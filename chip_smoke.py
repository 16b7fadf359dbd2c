"""Drive the PyTorch/CUDA port on one GPU and check every kernel.

    python3 chip_smoke.py

Phases, one line each, in order; any failure raises and the script
exits non-zero:

1. card: name and power limit from ``nvidia-smi``;
2. build: both CUDA sources under
   ``style_transfer_visualizer_tpu_torch/csrc/`` with ``nvcc`` for
   ``sm_90a``;
3. conv check: the conv kernel against its plain PyTorch version at
   every conv shape of the 512x512 main path (forward fused and
   unfused, the input gradient, and a batch of 2), max-abs error
   relative to the reference's largest magnitude <= 1e-4, with times;
4. Gram check: the same at the five Gram shapes, forward and backward,
   with and without an active clamp;
5. main path: ``run_style_transfer`` at 512x512 on full-width VGG19
   (seeded weights, shipped defaults) for 20 L-BFGS steps, with the
   launch counts set to 0 just before and read just after; then a
   64x64 run held against the same run on the CPU (plain versions).

The line before the card line is the kernels' JSON record; the last
line is the run's JSON verdict. Times come from CUDA events on this
run's card; bounds use the H100 SXM's 67 TFLOP/s fp32 (outside the
tensor cores) and 3.35 TB/s.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from functools import partial

import numpy as np
import torch
import torch.nn.functional as F  # noqa: N812

from style_transfer_visualizer_tpu_torch.config import (
    HardwareConfig,
    OptimizationConfig,
    OutputConfig,
    StyleTransferConfig,
)
from style_transfer_visualizer_tpu_torch.constants import (
    GRAM_MATRIX_CLAMP_MAX as CLAMP,
)
from style_transfer_visualizer_tpu_torch.main import run_style_transfer
from style_transfer_visualizer_tpu_torch.models.vgg19 import flip_stencil
from style_transfer_visualizer_tpu_torch.native import build
from style_transfer_visualizer_tpu_torch.ops import conv3x3, gram

PACKAGE = "style_transfer_visualizer_tpu_torch"
FP32_FLOPS = 67e12
HBM_BYTES = 3.35e12
TOL = 1e-4
STEPS = 20
LOG_EVERY = 10
SIZE = 512
# (H = W, C_in, C_out, convs of this shape up to layer 28) at 512x512.
CONV_SHAPES = [
    (512, 3, 64, 1), (512, 64, 64, 1),
    (256, 64, 128, 1), (256, 128, 128, 1),
    (128, 128, 256, 1), (128, 256, 256, 3),
    (64, 256, 512, 1), (64, 512, 512, 3),
    (32, 512, 512, 1),
]
# (P, C) of the five style taps at 512x512.
GRAM_SHAPES = [
    (262144, 64), (65536, 128), (16384, 256), (4096, 512), (1024, 512),
]


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",  # noqa: S607
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int = 10) -> float:

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _times(*fns) -> tuple[float, ...]:
    return tuple(_time_ms(fn) for fn in fns)


def _rel_err(ours, ref) -> tuple[float, float]:
    """(max abs error, that over the reference's largest magnitude)."""
    err = float((ours - ref).abs().max())
    return err, err / max(float(ref.abs().max()), 1e-30)


def _bound_s(flops: float, nbytes: float) -> tuple[float, float]:
    return flops / FP32_FLOPS, nbytes / HBM_BYTES


class Record:
    """One kernel's line of the JSON record, summed over a step."""

    def __init__(self, name: str, source: str, replaces: str) -> None:
        """Start an empty record."""
        self.entry = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0, "max_abs_err": 0.0,
            "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
        }
        self.flops_s = 0.0
        self.bytes_s = 0.0
        self.bound_s = 0.0

    def err(self, ours, ref, what: str) -> None:
        """Check one comparison against the tolerance and keep its error."""
        err, rel = _rel_err(ours, ref)
        if not rel <= TOL:
            msg = f"{self.entry['name']} {what}: rel err {rel:.3g} > {TOL}"
            raise AssertionError(msg)
        self.entry["max_abs_err"] = max(self.entry["max_abs_err"], err)

    def add(self, count: int, ms, plain_ms, library_ms, flops, nbytes):
        """Add ``count`` launches per step of one shape to the sums."""
        ops_s, mem_s = _bound_s(flops, nbytes)
        self.flops_s += count * ops_s
        self.bytes_s += count * mem_s
        self.bound_s += count * max(ops_s, mem_s)
        self.entry["ms"] += count * ms
        self.entry["plain_ms"] += count * plain_ms
        self.entry["library_ms"] += count * library_ms

    def finish(self, launches: int) -> dict:
        """The JSON entry, with this run's main-path launch count."""
        out = dict(self.entry, launches=launches)
        out["bound_ms"] = self.bound_s * 1e3
        out["bound_by"] = (
            "operations" if self.flops_s >= self.bytes_s else "bytes"
        )
        return out


def _check_conv(rec: Record) -> None:


    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = [(1, *s) for s in CONV_SHAPES] + [(2, 64, 128, 128, 0)]
    for n, hw, ci, co, count in cases:
        def rand(*shape, scale=1.0):
            return torch.randn(
                shape, generator=gen, device="cuda",
            ) * scale

        x = rand(n, hw, hw, ci)
        w9 = rand(9, ci, co, scale=(2.0 / (9 * ci)) ** 0.5)
        b = rand(co, scale=0.1)
        g = rand(n, hw, hw, co)
        w9f = flip_stencil(w9)
        w_oihw = w9.reshape(3, 3, ci, co).permute(3, 2, 0, 1).contiguous()
        label = f"{n}x{hw}x{hw} {ci}->{co}"
        for relu in (True, False):
            rec.err(
                conv3x3.conv3x3_kernel(x, w9, b, relu),
                conv3x3.conv3x3_plain(x, w9, b, relu),
                f"{label} forward relu={relu}",
            )
        # Input gradient through the fused ReLU. The reference is
        # cuDNN's own conv backward on g masked by the kernel's output,
        # so both sides use one mask.
        xk = x.clone().requires_grad_(True)
        out = conv3x3.conv3x3_bias_relu(xk, w9, w9f, b, True)
        out.backward(g)
        xr = x.clone().requires_grad_(True)
        ref = F.conv2d(xr.permute(0, 3, 1, 2), w_oihw, b, padding=1)
        ref.backward((g * (out.detach() > 0)).permute(0, 3, 1, 2))
        rec.err(xk.grad, xr.grad, f"{label} input gradient")
        if not count:
            print(f"conv {label}: ok (batch check)")
            continue
        x_nchw = x.permute(0, 3, 1, 2)
        g_nchw = g.permute(0, 3, 1, 2)
        wf_oihw = w9f.reshape(3, 3, co, ci).permute(3, 2, 0, 1).contiguous()
        fwd = _times(
            partial(conv3x3.conv3x3_kernel, x, w9, b, True),
            partial(conv3x3.conv3x3_plain, x, w9, b, True),
            partial(F.conv2d, x_nchw, w_oihw, b, padding=1),
        )
        bwd = _times(
            partial(conv3x3.conv3x3_kernel, g, w9f, None, False),
            partial(conv3x3.conv3x3_plain, g, w9f, None, False),
            partial(F.conv2d, g_nchw, wf_oihw, None, padding=1),
        )
        pix = n * hw * hw
        flops = 2.0 * 9 * pix * ci * co
        nbytes = 4.0 * (pix * (ci + co) + 9 * ci * co)
        rec.add(count, *fwd, flops, nbytes + 4.0 * co)
        rec.add(count, *bwd, flops, nbytes)
        bound = max(_bound_s(flops, nbytes)) * 1e3
        print(
            f"conv {label} x{count}: fwd kernel_ms {fwd[0]:.4f} plain_ms "
            f"{fwd[1]:.4f} library_ms {fwd[2]:.4f} | bwd kernel_ms "
            f"{bwd[0]:.4f} plain_ms {bwd[1]:.4f} library_ms {bwd[2]:.4f} "
            f"| bound_ms {bound:.4f}",
        )


def _check_gram(rec: Record) -> None:


    gen = torch.Generator(device="cuda").manual_seed(2)
    for p, c in GRAM_SHAPES:
        # Scale 1 leaves the clamp idle; the second scale puts the
        # diagonal near 1e6, above the 5e5 clamp.
        for scale in (1.0, (1e6 / p) ** 0.5):
            f = torch.randn((p, c), generator=gen, device="cuda") * scale
            dg = torch.randn((c, c), generator=gen, device="cuda")
            raw_k, g_k = gram.gram_kernel(f, CLAMP, float(p * c))
            raw_p, g_p = gram.gram_plain(f, CLAMP, float(p * c))
            active = bool((raw_p > CLAMP).any())
            label = f"({p},{c}) clamp_active={active}"
            rec.err(raw_k, raw_p, f"{label} raw")
            rec.err(g_k, g_p, f"{label} forward")
            if not torch.equal(raw_k, raw_k.T):
                msg = f"gram {label}: raw Gram is not symmetric"
                raise AssertionError(msg)
            feats = f.reshape(1, 1, p, c)
            fk = feats.clone().requires_grad_(True)
            gram.gram_matrix(fk).backward(dg)
            fr = feats.clone().requires_grad_(True)
            raw = fr.reshape(p, c).T @ fr.reshape(p, c)
            (torch.clamp(raw, max=CLAMP) / (p * c)).backward(dg)
            rec.err(fk.grad, fr.grad, f"{label} backward")
        times = _times(
            partial(gram.gram_kernel, f, CLAMP, float(p * c)),
            partial(gram.gram_plain, f, CLAMP, float(p * c)),
            partial(torch.mm, f.T, f),
        )
        # G is symmetric: c(c+1)/2 distinct entries, 2p flops each.
        flops = float(p * c * (c + 1))
        nbytes = 4.0 * (p * c + 2 * c * c)
        rec.add(1, *times, flops, nbytes)
        bound = max(_bound_s(flops, nbytes)) * 1e3
        print(
            f"gram ({p},{c}): kernel_ms {times[0]:.4f} plain_ms "
            f"{times[1]:.4f} library_ms {times[2]:.4f} bound_ms "
            f"{bound:.4f}",
        )


def _config(steps: int, device: str, **opt):
    """A shipped-defaults config with seeded weights."""
    return StyleTransferConfig(
        output=OutputConfig(log_every=LOG_EVERY),
        optimization=OptimizationConfig(
            steps=steps, allow_random_weights=True, **opt,
        ),
        hardware=HardwareConfig(device=device),
    )


def _images(size: int, seed: int):
    rng = np.random.default_rng(seed)
    return tuple(
        rng.uniform(size=(1, size, size, 3)).astype(np.float32)
        for _ in range(2)
    )


def _main_path() -> tuple[int, int]:
    """20 steps at 512x512; returns the conv and Gram launch counts."""
    content, style = _images(SIZE, 0)
    torch.cuda.reset_peak_memory_stats()
    conv3x3.launches.reset()
    gram.launches.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    image, history = run_style_transfer(
        content, style, _config(STEPS, "cuda"),
    )
    torch.cuda.synchronize()
    t_long = time.perf_counter() - t0
    conv_n, gram_n = conv3x3.launches.count, gram.launches.count
    peak = torch.cuda.max_memory_allocated()

    losses = history["total_loss"]
    logged = [losses[i - 1] for i in range(LOG_EVERY, STEPS + 1, LOG_EVERY)]
    if len(losses) != STEPS or not all(map(_finite, losses)):
        msg = f"non-finite or missing losses: {losses}"
        raise AssertionError(msg)
    if not losses[-1] < losses[0] or not logged[-1] < logged[0]:
        msg = f"loss did not decrease: {losses}"
        raise AssertionError(msg)
    if tuple(image.shape) != (1, SIZE, SIZE, 3) or not bool(
        torch.isfinite(image).all(),
    ):
        msg = f"bad output image {tuple(image.shape)}"
        raise AssertionError(msg)
    want = (26 * STEPS + 23, 5 * STEPS + 5)
    if (conv_n, gram_n) != want:
        msg = f"launches conv/gram {conv_n}/{gram_n}, expected {want}"
        raise AssertionError(msg)

    # Per-step time: the difference of a 20-step and a 10-step run made
    # after the counted one, so weights, targets and one-time library
    # set-up cancel out.
    t_run = {}
    for steps in (STEPS // 2, STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_style_transfer(content, style, _config(steps, "cuda"))
        torch.cuda.synchronize()
        t_run[steps] = time.perf_counter() - t0
    ms_step = (t_run[STEPS] - t_run[STEPS // 2]) / (STEPS // 2) * 1e3
    print(
        f"main path {SIZE}x{SIZE} vgg19 L-BFGS {STEPS} steps: "
        f"loss {losses[0]:.6g} -> {losses[-1]:.6g}, logged {logged}, "
        f"ms/step {ms_step:.3f}, run s {t_long:.3f}, "
        f"max_memory_allocated {peak}, launches conv {conv_n} gram {gram_n}",
    )
    return conv_n, gram_n


def _finite(v: float) -> bool:
    return v == v and abs(v) != float("inf")


def _small_reference() -> None:
    """A 64x64, 3-step run on the card against the same run on the CPU.

    Both start from the content image: the two devices' generators
    draw different random starting images from one seed.
    """
    content, style = _images(64, 1)
    runs = {
        d: run_style_transfer(
            content, style, _config(3, d, init_method="content"),
        )
        for d in ("cuda", "cpu")
    }
    gpu, cpu = (runs[d][1]["total_loss"] for d in ("cuda", "cpu"))
    np.testing.assert_allclose(gpu, cpu, rtol=1e-3)
    img_err = float(
        (runs["cuda"][0].cpu() - runs["cpu"][0]).abs().max(),
    )
    print(f"small reference 64x64 3 steps: cuda {gpu} cpu {cpu} "
          f"image max abs diff {img_err:.3g}")


def main() -> int:
    """Run every phase; return 0 when all pass (failures raise)."""
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs a GPU", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    card = _card()
    print(f"card: {card}")

    t0 = time.perf_counter()
    built = build.build_all()
    print(f"build: {len(built)} kernels in {time.perf_counter() - t0:.1f} s")
    for kernel in built:
        for line in kernel.ptxas_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {kernel.name}: {line.strip()}")

    conv = Record(
        "conv3x3", f"{PACKAGE}/csrc/conv3x3.cu",
        "style_transfer_visualizer_tpu/ops/pallas_conv.py:63",
    )
    _check_conv(conv)
    gram_rec = Record(
        "gram", f"{PACKAGE}/csrc/gram.cu",
        "style_transfer_visualizer_tpu/ops/pallas_gram.py:40",
    )
    _check_gram(gram_rec)
    conv_n, gram_n = _main_path()
    _small_reference()

    kernels = [conv.finish(conv_n), gram_rec.finish(gram_n)]
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
