"""Drive the PyTorch/CUDA port on one GPU and check every kernel.

    python3 chip_smoke.py

Phases, one line each, in order; any failure raises and the script
exits non-zero:

1. card: name and power limit from ``nvidia-smi``;
2. build: both CUDA sources under
   ``style_transfer_visualizer_tpu_torch/csrc/`` with ``nvcc`` for
   ``sm_90a``, with each library's count of ``HGMMA`` instructions
   (``wgmma`` on the tensor cores) from ``cuobjdump -sass`` where the
   toolkit has it;
3. conv check: the conv kernel against its plain PyTorch version at
   every conv shape of the 512x512 main path, of the objective phase's
   1024x1024 steps and of the batch phase's 512x512 steps at N = 4
   (forward fused and unfused, the fused-mask input gradient against
   the plain masked version, the autograd input gradient against
   cuDNN's), max-abs error relative to the reference's largest
   magnitude <= 1e-4, with times; at N > 1 each image's output and
   input gradient bit-equal to its launch alone; checked only: a batch
   of 2, and VGG19's stack at a 528x960 coarse level (a 1080x1920
   content's; widths that are not powers of two). VGG16's 512x512 shapes are
   confirmed to be among the checked ones;
4. Gram check: the same at the five Gram shapes of each size (P up to
   1,048,576 at 1024x1024), forward and backward, with and without an
   active clamp; then the batched launch (one launch for S images):
   S = 4 at the five 512x512 shapes (timed against ``torch.bmm``) and
   at the 528x960 coarse level's, where P is not a multiple of the
   kernel's 32-row slot, each image against its plain Gram and
   bit-equal to the single launch on that image, and S = 1 too;
5. main path: ``run_style_transfer`` at 512x512 on full-width VGG19
   (seeded weights, shipped defaults) for 20 L-BFGS steps through the
   port's runner (no progress bar), with the launch counts set to 0
   just before and read just after;
6. timelapse: the port's runner on the main path's configuration with
   ``save_every=1`` into an in-memory frame sink (20 frames through the
   pinned-buffer frame stream), launch counts again 0 just before and
   read just after; the frames in step order, (512, 512, 3) uint8, the
   last one bit-equal to the packed final image; the largest difference
   from the same run with synchronous frames; ms/step with frames off,
   at ``save_every=20`` and at ``save_every=1``, the spread of the last
   over the first round by round, and each mode's mean interval
   between steps 3 to 20. Where ``ffmpeg`` is on
   PATH and Pillow imports, also ``main.style_transfer`` at the shipped
   video defaults (realtime MP4, intro, outro) with ``save_every=2`` on
   512x512 PNGs, with the MP4's size and frame count; otherwise the
   line says which is missing;
7. objective: ``run_style_transfer`` at 1024x1024 on full-width VGG19,
   two styles blended 0.7/0.3, TV and Laplacian terms, per-layer style
   weights, ``preserve_color="luminance"``, 20 L-BFGS steps with the
   auto warm start (4 steps at 512x512 first): the warm start ran (its
   log lines), finite and decreasing losses, launch counts equal to
   those worked out from the code (``_launches_wanted``), the output's
   chrominance equal to the content's where nothing is clipped;
   ms/step at full size and the peak memory;
8. Adam on full-width VGG16 at 512x512, 20 steps: launches, a loss
   that decreases, finite output, ms/step;
9. batch: ``main.prepare_multi_style`` and ``main.run_multi_style_loop``
   (the multi-style batch) at 512x512 on full-width VGG19, S = 4 styles
   (numpy seeds 2-5, the last 384x640), the shipped L-BFGS from the
   content, 20 steps, ``log_every=10``, ``save_every=5``, GIF and MP4
   into in-memory sinks: launches as worked out (a step's do not grow
   with S), each style's losses finite and decreasing, 4 frames per
   style and sink in step order, the last bit-equal to the style's
   packed final image, each style's 20-step curve within 1e-3 relative
   per step of a single run of that style (the final images' largest
   difference beside it, and, for scale, a single run against itself
   with its content perturbed by 1e-7); then frames off at S = 1, 4
   and 8 and a single run, rounds interleaved: ms per step (the mean
   step interval over steps 3-20), style-steps/s, the device-busy share
   (profiled device time over the step interval) and the peak memory;
10. a 64x64 run held against the same run on the CPU (plain versions),
   then the same for Adam with every term above and a 2-step warm
   start at 32x32, then the same for a batch of 2 styles.

The line before the card line is the kernels' JSON record (each
kernel's launches in each driven path, and its times summed over a
step at 512x512, under ``at_1024`` at 1024x1024, and for the batch
phase's step at S = 4 under ``n4_512`` (conv) and ``batched_s4_512``
(Gram)); the last
line is the run's JSON verdict. Times come from CUDA events around
replays of CUDA graphs of back-to-back calls on this run's card (device
time; host launch overhead excluded for every version alike). Both
kernels compute 3xTF32 on the tensor cores, so ``bound_ms`` is the
larger of three TF32 products per operation at the H100 SXM's 495
TFLOP/s and the bytes at 3.35 TB/s; ``fp32_bound_ms`` keeps the fp32
figure (67 TFLOP/s outside the tensor cores).
"""
from __future__ import annotations

import gc
import importlib.util
import json
import logging
import re
import shutil
import statistics
import subprocess
import sys
import time
from functools import cache, partial
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F  # noqa: N812

from style_transfer_visualizer_tpu_torch import image_io
from style_transfer_visualizer_tpu_torch.config import (
    HardwareConfig,
    OptimizationConfig,
    OutputConfig,
    StyleTransferConfig,
    VideoConfig,
)
from style_transfer_visualizer_tpu_torch.constants import (
    GRAM_MATRIX_CLAMP_MAX as CLAMP,
)
from style_transfer_visualizer_tpu_torch.engine.coarse import plan_pyramid
from style_transfer_visualizer_tpu_torch.engine.runner import (
    OptimizationCallbacks,
    OptimizationRunner,
)
from style_transfer_visualizer_tpu_torch.main import (
    prepare_model_and_input,
    prepare_multi_style,
    run_multi_style_loop,
    run_style_transfer,
    style_transfer,
)
from style_transfer_visualizer_tpu_torch.media import segments
from style_transfer_visualizer_tpu_torch.models.arch import VGG16, VGG19
from style_transfer_visualizer_tpu_torch.models.vgg19 import (
    flip_stencil,
    load_pretrained_params,
    pack_stencil,
)
from style_transfer_visualizer_tpu_torch.native import build
from style_transfer_visualizer_tpu_torch.ops.color import RGB_TO_YIQ
from style_transfer_visualizer_tpu_torch.ops import conv3x3, gram
from style_transfer_visualizer_tpu_torch.type_defs import InputPaths
from style_transfer_visualizer_tpu_torch.utils.logging import logger

PACKAGE = "style_transfer_visualizer_tpu_torch"
FP32_FLOPS = 67e12
TF32X3_FLOPS = 495e12 / 3
HBM_BYTES = 3.35e12
CUOBJDUMP = "/usr/local/cuda/bin/cuobjdump"
TOL = 1e-4
# YIQ chrominance of a luminance-restored output against the content's,
# where no channel is clipped: float32 matrices, float64 check.
CHROMA_TOL = 1e-5
STEPS = 20
LOG_EVERY = 10
TIMELAPSE_ROUNDS = 16
SIZE = 512
# (H = W, C_in, C_out, convs of this shape up to layer 28, of which
# fused with their ReLU) at 512x512. A tap (layers 0, 5, 10, 19, 21,
# 28) is not fused, so its backward takes no mask.
CONV_SHAPES = [
    (512, 3, 64, 1, 0), (512, 64, 64, 1, 1),
    (256, 64, 128, 1, 0), (256, 128, 128, 1, 1),
    (128, 128, 256, 1, 0), (128, 256, 256, 3, 3),
    (64, 256, 512, 1, 0), (64, 512, 512, 3, 2),
    (32, 512, 512, 1, 0),
]
# (P, C) of the five style taps at 512x512.
GRAM_SHAPES = [
    (262144, 64), (65536, 128), (16384, 256), (4096, 512), (1024, 512),
]
# The objective phase: 1024x1024 content, whose auto warm start runs a
# 512x512 level first (the main path's shapes); then the same taps at
# twice the side. VGG16's stack at 512x512 has the main path's width
# pairs (fewer repeats), checked by ``_vgg16_shapes_covered``. A
# 1080x1920 content's coarse level, 528x960 (a width that is not a
# power of two), is checked through the whole VGG19 stack.
OBJECTIVE_SIZE = 1024
NON_SQUARE = (528, 960)
# The batch phase: S = 4 styles (numpy seeds 2-5; seed 5's is 384x640,
# the others 512x512), timed at S = 1, 4 and 8 (seeds 2-9).
BATCH_STYLES = 4
BATCH_SAVE_EVERY = 5
BATCH_TIMED = (1, 4, 8)
BATCH_ROUNDS = 3
ODD_STYLE = (5, (384, 640))


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",  # noqa: S607
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


@cache
def _timing_stream() -> torch.cuda.Stream:
    """The one side stream every timing capture runs on.

    PyTorch keeps a cuBLAS workspace for each stream that has run a
    cuBLAS call, for the life of the process; a fresh stream per timing
    would leave one behind for every timed product.
    """
    return torch.cuda.Stream()


def _time_ms(fn, reps: int = 10, replays: int = 3) -> float:
    """Device ms of one call of ``fn``, from a CUDA graph of ``reps`` calls.

    Replaying captured calls times the device work alone: the host's
    launch overhead (Python, ctypes, PyTorch's dispatcher) is left out
    of the kernel, the plain version and the library call alike. The
    wrappers' host time is measured apart (tools/wrapper_host_time.py).
    """
    stream = _timing_stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    graph.reset()
    return start.elapsed_time(end) / (reps * replays)


def _times(*fns) -> tuple[float, ...]:
    return tuple(_time_ms(fn) for fn in fns)


def _rel_err(ours, ref) -> tuple[float, float]:
    """(max abs error, that over the reference's largest magnitude)."""
    err = float((ours - ref).abs().max())
    return err, err / max(float(ref.abs().max()), 1e-30)


def _hgmma_count(library) -> int | None:
    """``HGMMA`` instructions in a library's SASS; None without the tool."""
    tool = shutil.which("cuobjdump") or CUOBJDUMP
    if not Path(tool).exists():
        return None
    sass = subprocess.run(
        [tool, "-sass", str(library)],
        capture_output=True, text=True, check=True, timeout=120,
    ).stdout
    return sass.count("HGMMA")


class Record:
    """One kernel's line of the JSON record, summed over a step."""

    def __init__(self, name: str, source: str, replaces: str) -> None:
        """Start an empty record."""
        self.entry = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0, "max_abs_err": 0.0,
            "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
        }
        self.ops_s = 0.0     # 3xTF32 operation time, summed
        self.bytes_s = 0.0
        self.bound_s = 0.0
        self.fp32_bound_s = 0.0

    def err(self, ours, ref, what: str) -> None:
        """Check one comparison against the tolerance and keep its error."""
        err, rel = _rel_err(ours, ref)
        if not rel <= TOL:
            msg = f"{self.entry['name']} {what}: rel err {rel:.3g} > {TOL}"
            raise AssertionError(msg)
        self.entry["max_abs_err"] = max(self.entry["max_abs_err"], err)

    def add(self, count: int, ms, plain_ms, library_ms, flops, nbytes):
        """Add ``count`` launches per step of one shape to the sums."""
        ops_s = flops / TF32X3_FLOPS
        mem_s = nbytes / HBM_BYTES
        self.ops_s += count * ops_s
        self.bytes_s += count * mem_s
        self.bound_s += count * max(ops_s, mem_s)
        self.fp32_bound_s += count * max(flops / FP32_FLOPS, mem_s)
        self.entry["ms"] += count * ms
        self.entry["plain_ms"] += count * plain_ms
        self.entry["library_ms"] += count * library_ms

    def finish(
        self, launches: dict[str, int], extras: dict[str, Record],
    ) -> dict:
        """The JSON entry: the main path's launches and per-step sums.

        ``launches`` maps each driven path to its launch count; the
        main path's is the entry's ``launches``. Each of ``extras``
        holds the same sums over a step of another configuration (the
        objective phase at full size, the batch phase at S = 4).
        """
        out = dict(
            self.entry, launches=launches["main path"],
            launches_by_phase=launches,
        )
        out.update(self._bounds())
        for key, rec in extras.items():
            out[key] = {
                k: rec.entry[k] for k in ("ms", "plain_ms", "library_ms")
            } | rec._bounds()  # noqa: SLF001 - same class
        return out

    def _bounds(self) -> dict:
        return {
            "bound_ms": self.bound_s * 1e3,
            "bound_by": (
                "operations" if self.ops_s >= self.bytes_s else "bytes"
            ),
            "fp32_bound_ms": self.fp32_bound_s * 1e3,
        }


def _bound_ms(flops: float, nbytes: float) -> float:
    return max(flops / TF32X3_FLOPS, nbytes / HBM_BYTES) * 1e3


def _conv_cases(rec: Record, rec_1024: Record, rec_n4: Record):
    """``(n, h, w, C_in, C_out, per step, of which fused, record)``.

    The main path's shapes, twice their side (the objective phase at
    full size) and the same at N = 4 (the batch phase's step at S = 4)
    are timed into ``rec``, ``rec_1024`` and ``rec_n4``; a batch of 2
    and the 528x960 coarse level's stack are checked only.
    """
    cases = [
        (1, hw, hw, ci, co, n, f, rec) for hw, ci, co, n, f in CONV_SHAPES
    ]
    cases += [
        (1, 2 * hw, 2 * hw, ci, co, n, f, rec_1024)
        for hw, ci, co, n, f in CONV_SHAPES
    ]
    cases += [
        (BATCH_STYLES, hw, hw, ci, co, n, f, rec_n4)
        for hw, ci, co, n, f in CONV_SHAPES
    ]
    cases.append((2, 64, 64, 128, 128, 0, 0, None))
    h, w = NON_SQUARE
    for hw, ci, co, _, _ in CONV_SHAPES:
        scale = SIZE // hw
        cases.append((1, h // scale, w // scale, ci, co, 0, 0, None))
    return cases


def _vgg16_shapes_covered() -> None:
    """VGG16's conv shapes at 512x512 are among the checked ones."""
    table = VGG16.layer_table
    last = max(VGG16.default_style_layers + VGG16.default_content_layers)
    pools = 0
    shapes = set()
    for idx in range(last + 1):
        kind, ci, co = table[idx]
        if kind == "pool":
            pools += 1
        elif kind == "conv":
            shapes.add((SIZE >> pools, ci, co))
    checked = {(hw, ci, co) for hw, ci, co, _, _ in CONV_SHAPES}
    if not shapes <= checked:
        msg = f"VGG16 conv shapes not checked: {sorted(shapes - checked)}"
        raise AssertionError(msg)
    print(f"conv vgg16 {SIZE}x{SIZE}: its {len(shapes)} shapes are checked")


def _check_conv(rec: Record, rec_1024: Record, rec_n4: Record) -> None:
    gen = torch.Generator(device="cuda").manual_seed(1)
    for n, h, w, ci, co, count, fused, into in _conv_cases(
        rec, rec_1024, rec_n4,
    ):
        def rand(*shape, scale=1.0):
            return torch.randn(
                shape, generator=gen, device="cuda",
            ) * scale

        x = rand(n, h, w, ci)
        w9 = rand(9, ci, co, scale=(2.0 / (9 * ci)) ** 0.5)
        b = rand(co, scale=0.1)
        g = rand(n, h, w, co)
        w9f = flip_stencil(w9)
        wk, wkf = pack_stencil(w9), pack_stencil(w9f)
        w_oihw = w9.reshape(3, 3, ci, co).permute(3, 2, 0, 1).contiguous()
        label = f"{n}x{h}x{w} {ci}->{co}"
        for relu in (True, False):
            rec.err(
                conv3x3.conv3x3_kernel(x, wk, b, relu),
                conv3x3.conv3x3_plain(x, w9, b, relu),
                f"{label} forward relu={relu}",
            )
        # The fused-mask input gradient: the kernel zeroes g where the
        # forward's output is not positive as it loads it.
        out = conv3x3.conv3x3_kernel(x, wk, b, True)
        rec.err(
            conv3x3.conv3x3_kernel(g, wkf, None, False, out),
            conv3x3.conv3x3_plain(g, w9f, None, False, out),
            f"{label} fused-mask input gradient",
        )
        # Through autograd, against cuDNN's own conv backward on g
        # masked by the kernel's output, so both sides use one mask.
        xk = x.clone().requires_grad_(True)
        out = conv3x3.conv3x3_bias_relu(xk, w9, w9f, b, True, wk, wkf)
        out.backward(g)
        xr = x.clone().requires_grad_(True)
        ref = F.conv2d(xr.permute(0, 3, 1, 2), w_oihw, b, padding=1)
        ref.backward((g * (out.detach() > 0)).permute(0, 3, 1, 2))
        rec.err(xk.grad, xr.grad, f"{label} input gradient")
        if n > 1:
            _check_batch_invariant(x, g, wk, wkf, b, label)
        if not count:
            print(f"conv {label}: ok (check only)")
            continue
        out = out.detach()
        x_nchw = x.permute(0, 3, 1, 2)
        gm_nchw = torch.where(out > 0, g, 0.0).permute(0, 3, 1, 2)
        wf_oihw = w9f.reshape(3, 3, co, ci).permute(3, 2, 0, 1).contiguous()
        fwd = _times(
            partial(conv3x3.conv3x3_kernel, x, wk, b, True),
            partial(conv3x3.conv3x3_plain, x, w9, b, True),
            partial(F.conv2d, x_nchw, w_oihw, b, padding=1),
        )
        pix = n * h * w
        flops = 2.0 * 9 * pix * ci * co
        nbytes = 4.0 * (pix * (ci + co) + 9 * ci * co)
        into.add(count, *fwd, flops, nbytes + 4.0 * co)
        line = (
            f"conv {label} x{count}: fwd kernel_ms {fwd[0]:.4f} plain_ms "
            f"{fwd[1]:.4f} library_ms {fwd[2]:.4f} "
            f"bound_ms {_bound_ms(flops, nbytes):.4f}"
        )
        # The backward as the main path runs it: masked for a conv fused
        # with its ReLU (it also reads the mask), plain otherwise. The
        # library yardstick is cuDNN's conv of the already masked g: one
        # call, the mask not counted.
        for n_bwd, mask, g_nchw, extra in (
            (fused, out, gm_nchw, 4.0 * pix * co),
            (count - fused, None, g.permute(0, 3, 1, 2), 0.0),
        ):
            if not n_bwd:
                continue
            bwd = _times(
                partial(conv3x3.conv3x3_kernel, g, wkf, None, False, mask),
                partial(conv3x3.conv3x3_plain, g, w9f, None, False, mask),
                partial(F.conv2d, g_nchw, wf_oihw, None, padding=1),
            )
            into.add(n_bwd, *bwd, flops, nbytes + extra)
            line += (
                f" | bwd x{n_bwd} mask={mask is not None} kernel_ms "
                f"{bwd[0]:.4f} plain_ms {bwd[1]:.4f} library_ms "
                f"{bwd[2]:.4f} bound_ms {_bound_ms(flops, nbytes + extra):.4f}"
            )
        print(line)


def _check_batch_invariant(x, g, wk, wkf, b, label: str) -> None:
    """Each image of a batch gets, bit for bit, its output alone.

    The forward (fused ReLU) and the fused-mask input gradient; the
    launch plan picks the split over K per image, not per batch.
    """
    out = conv3x3.conv3x3_kernel(x, wk, b, True)
    back = conv3x3.conv3x3_kernel(g, wkf, None, False, out)
    for i in range(x.shape[0]):
        one = conv3x3.conv3x3_kernel(x[i:i + 1].contiguous(), wk, b, True)
        one_back = conv3x3.conv3x3_kernel(
            g[i:i + 1].contiguous(), wkf, None, False, one,
        )
        if not (torch.equal(out[i], one[0])
                and torch.equal(back[i], one_back[0])):
            msg = f"conv {label}: image {i} differs from its launch alone"
            raise AssertionError(msg)


def _check_gram(rec: Record, rec_1024: Record, rec_b4: Record) -> None:
    """The main path's Gram shapes, the objective phase's (P x 4), then
    the batched launch (:func:`_check_gram_batched`)."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    cases = [(p, c, rec) for p, c in GRAM_SHAPES]
    cases += [(4 * p, c, rec_1024) for p, c in GRAM_SHAPES]
    for p, c, into in cases:
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
        into.add(1, *times, flops, nbytes)
        print(
            f"gram ({p},{c}): kernel_ms {times[0]:.4f} plain_ms "
            f"{times[1]:.4f} library_ms {times[2]:.4f} bound_ms "
            f"{_bound_ms(flops, nbytes):.4f}",
        )
    _check_gram_batched(rec, rec_b4, gen)


def _check_gram_batched(
    rec: Record, rec_b4: Record, gen: torch.Generator,
) -> None:
    """One launch for S images, each against its plain Gram.

    S = 4 at the 512x512 shapes (timed into ``rec_b4``, against
    ``torch.bmm`` fp32 on the same ``(S, C, P) . (S, P, C)``) and at
    the 528x960 coarse level's, whose two deepest taps (P = 7920 and
    1980) are not multiples of the kernel's 32-row slot: image s's last
    slab must not read image s+1's rows, so each image is scaled
    differently. At S = 1 the raw Gram is the single launch's, bit for
    bit.
    """
    s = BATCH_STYLES
    h, w = NON_SQUARE
    cases = [(p, c, True) for p, c in GRAM_SHAPES]
    cases += [
        ((h >> k) * (w >> k), c, False)
        for k, (_, c) in enumerate(GRAM_SHAPES)
    ]
    spread = 1.0 + torch.arange(s, device="cuda")[:, None, None] / s
    for p, c, timed in cases:
        norm = float(p * c)
        for scale in (1.0, (1e6 / p) ** 0.5):
            f = torch.randn(
                (s, p, c), generator=gen, device="cuda",
            ) * (scale * spread)
            dg = torch.randn((s, c, c), generator=gen, device="cuda")
            raw_k, g_k = gram.gram_kernel_batched(f, CLAMP, norm)
            raw_p, g_p = gram.gram_plain_batched(f, CLAMP, norm)
            active = bool((raw_p > CLAMP).any())
            label = f"S={s} ({p},{c}) clamp_active={active}"
            for i in range(s):
                rec.err(raw_k[i], raw_p[i], f"{label} image {i} raw")
                rec.err(g_k[i], g_p[i], f"{label} image {i} forward")
                if not torch.equal(raw_k[i], raw_k[i].T):
                    msg = f"gram {label}: raw Gram {i} is not symmetric"
                    raise AssertionError(msg)
            fk = f.reshape(s, 1, p, c).clone().requires_grad_(True)
            gram.gram_matrix_batched(fk).backward(dg)
            fr = f.clone().requires_grad_(True)
            (torch.clamp(fr.mT @ fr, max=CLAMP) / norm).backward(dg)
            for i in range(s):
                rec.err(
                    fk.grad[i, 0], fr.grad[i], f"{label} image {i} backward",
                )
            one, _ = gram.gram_kernel_batched(f[:1].contiguous(), CLAMP, norm)
            for i in range(s):
                single, _ = gram.gram_kernel(f[i].contiguous(), CLAMP, norm)
                if not torch.equal(raw_k[i], single) or (
                    i == 0 and not torch.equal(one[0], single)
                ):
                    msg = (
                        f"gram ({p},{c}): image {i} differs from the "
                        "single launch"
                    )
                    raise AssertionError(msg)
        if not timed:
            print(
                f"gram {label}: ok, each image and S = 1 bit-equal to the "
                "single launch (check only)",
            )
            continue
        times = _times(
            partial(gram.gram_kernel_batched, f, CLAMP, norm),
            partial(gram.gram_plain_batched, f, CLAMP, norm),
            partial(torch.bmm, f.mT, f),
        )
        flops = float(s * p * c * (c + 1))
        nbytes = 4.0 * s * (p * c + 2 * c * c)
        rec_b4.add(1, *times, flops, nbytes)
        print(
            f"gram S={s} ({p},{c}) one launch: kernel_ms {times[0]:.4f} "
            f"plain_ms {times[1]:.4f} library_ms (torch.bmm) "
            f"{times[2]:.4f} bound_ms {_bound_ms(flops, nbytes):.4f}; "
            f"each image and S = 1 bit-equal to the single launch",
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


def _counted_run(run):
    """``run()`` with the launch counts set to 0 just before and read
    just after; returns its result, its seconds and the counts."""
    conv3x3.launches.reset()
    gram.launches.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return out, seconds, (conv3x3.launches.count, gram.launches.count)


def _check_run(label: str, image, losses, launches, want, size: int):
    """Finite, decreasing losses, one a step; the launches worked out."""
    if len(losses) != STEPS or not all(map(_finite, losses)):
        msg = f"{label}: non-finite or missing losses {losses}"
        raise AssertionError(msg)
    if not losses[-1] < losses[0]:
        msg = f"{label}: loss did not decrease: {losses}"
        raise AssertionError(msg)
    if tuple(image.shape) != (1, size, size, 3) or not bool(
        torch.isfinite(image).all(),
    ):
        msg = f"{label}: bad output image {tuple(image.shape)}"
        raise AssertionError(msg)
    if launches != want:
        msg = f"{label}: launches conv/gram {launches}, expected {want}"
        raise AssertionError(msg)


def _ms_per_step(run_steps) -> float:
    """ms/step as the difference of a 20-step and a 10-step run.

    Made after the counted run, so weights, targets and one-time
    library set-up cancel out.
    """
    seconds = {}
    for steps in (STEPS // 2, STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_steps(steps)
        torch.cuda.synchronize()
        seconds[steps] = time.perf_counter() - t0
    return (seconds[STEPS] - seconds[STEPS // 2]) / (STEPS // 2) * 1e3


def _fresh_peak() -> int:
    """Free the checks' tensors and graph pools; reset the peak.

    Returns the bytes still allocated, so a phase's own peak is the
    peak less these.
    """
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def _main_path() -> tuple[int, int]:
    """20 steps at 512x512; returns the conv and Gram launch counts."""
    content, style = _images(SIZE, 0)
    config = _config(STEPS, "cuda")
    before = _fresh_peak()
    (image, history), t_long, launches = _counted_run(
        lambda: run_style_transfer(content, style, config),
    )
    peak = torch.cuda.max_memory_allocated()
    losses = history["total_loss"]
    _check_run(
        "main path", image, losses, launches,
        _launches_wanted(VGG19, config.optimization, SIZE, 1), SIZE,
    )
    logged = [losses[i - 1] for i in range(LOG_EVERY, STEPS + 1, LOG_EVERY)]
    if not logged[-1] < logged[0]:
        msg = f"main path: logged loss did not decrease: {logged}"
        raise AssertionError(msg)
    ms_step = _ms_per_step(
        lambda n: run_style_transfer(content, style, _config(n, "cuda")),
    )
    print(
        f"main path {SIZE}x{SIZE} vgg19 L-BFGS {STEPS} steps: "
        f"loss {losses[0]:.6g} -> {losses[-1]:.6g}, logged {logged}, "
        f"ms/step {ms_step:.3f}, run s {t_long:.3f}, "
        f"max_memory_allocated {peak}, of which allocated before the run "
        f"{before} (the run's own {peak - before}), "
        f"launches conv {launches[0]} gram {launches[1]}",
    )
    return launches


def _finite(v: float) -> bool:
    return v == v and abs(v) != float("inf")


class _FrameSink:
    """An in-memory frame sink: keeps every delivered array."""

    def __init__(self) -> None:
        """Start empty."""
        self.frames: list[np.ndarray] = []
        self._size = None

    def append_data(self, frame: np.ndarray) -> None:
        """Keep one frame."""
        self.frames.append(frame)

    def close(self) -> None:
        """Nothing to release."""


class _Progress:
    """The script's own progress reporter: counts steps, prints nothing."""

    def __init__(self) -> None:
        """Start at step 0."""
        self.steps = 0

    def update(self, n: int = 1) -> None:
        """Count ``n`` steps."""
        self.steps += n

    def set_postfix(self, *args, **kwargs) -> None:
        """Ignore the loss display."""
        del args, kwargs

    def close(self) -> None:
        """Nothing to release."""


def _timelapse_run(
    content, style, params, steps: int, save_every: int | None, *,
    async_frames: bool = True,
):
    """The runner on the main path's configuration, frames in memory.

    Returns the final working image, the loss history, the frames, the
    step of each frame, the runner's wall seconds (device synced
    before and after) and the host clock at the end of each step.
    ``save_every=None`` attaches no sink.
    """
    config = _config(steps, "cuda")
    config.video.save_every = save_every or steps + 1
    bundle, input_img = prepare_model_and_input(
        content, style, config, params=params,
    )
    sink = _FrameSink() if save_every else None
    frame_steps: list[int] = []
    step_ends: list[float] = []
    progress = _Progress()
    runner = OptimizationRunner(
        bundle.update_fn, bundle.opt_state, input_img, config,
        progress_bar=progress,
        # The step-end callback makes every mode run single steps.
        callbacks=OptimizationCallbacks(
            on_step_end=lambda _m: step_ends.append(time.perf_counter()),
            on_video_frame=lambda _f, step: frame_steps.append(step),
        ),
        video_writer=sink,
        async_frames=async_frames,
        chunked_update_fn=bundle.chunked_update_fn,
    )
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    image, history, _ = runner.run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if progress.steps != steps:
        msg = f"progress saw {progress.steps} steps, expected {steps}"
        raise AssertionError(msg)
    frames = sink.frames if sink else []
    return image, history, frames, frame_steps, seconds, step_ends


def _timelapse() -> tuple[int, int]:
    """20 frames through the frame stream; ms/step with and without."""
    content, style = _images(SIZE, 0)
    params = load_pretrained_params(
        torch.device("cuda"), allow_random=True, seed=0,
    )
    conv3x3.launches.reset()
    gram.launches.reset()
    image, history, frames, steps_seen, _, _ = _timelapse_run(
        content, style, params, STEPS, 1,
    )
    conv_n, gram_n = conv3x3.launches.count, gram.launches.count
    want = _launches_wanted(
        VGG19, _config(STEPS, "cuda").optimization, SIZE, 1,
    )
    if (conv_n, gram_n) != want:
        msg = f"timelapse launches conv/gram {conv_n}/{gram_n}, want {want}"
        raise AssertionError(msg)
    if steps_seen != list(range(1, STEPS + 1)) or len(frames) != STEPS:
        msg = f"frames at steps {steps_seen}, {len(frames)} delivered"
        raise AssertionError(msg)
    for frame in frames:
        if frame.shape != (SIZE, SIZE, 3) or frame.dtype != np.uint8:
            msg = f"bad frame {frame.shape} {frame.dtype}"
            raise AssertionError(msg)
    final = image_io.pack_uint8_frame(
        image_io.prepare_image_for_output(image, normalize=True),
    ).cpu().numpy()
    if not np.array_equal(frames[-1], final):
        msg = "last frame differs from the packed final image"
        raise AssertionError(msg)
    if len({id(f) for f in frames}) != STEPS or not all(
        map(_finite, history["total_loss"]),
    ):
        msg = "frames share memory or losses are not finite"
        raise AssertionError(msg)
    _, _, sync_frames, _, _, _ = _timelapse_run(
        content, style, params, STEPS, 1, async_frames=False,
    )
    sync_diff = max(
        int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())
        for a, b in zip(frames, sync_frames, strict=True)
    )

    # ms/step per mode: the difference of a 20-step and a 10-step run of
    # the runner, the least of TIMELAPSE_ROUNDS rounds, modes
    # interleaved (the host's noise is of the order of the frames'
    # cost). The spread of the same ratio taken round by round shows
    # that noise. The mean interval between steps 3 to 20 of the same
    # runs is a second reading, free of each run's start and end.
    modes = {"frames off": None, "save_every=20": 20, "save_every=1": 1}
    rounds: dict[tuple[str, int], list[float]] = {
        (name, steps): []
        for name in modes for steps in (STEPS // 2, STEPS)
    }
    gaps: dict[str, list[float]] = {name: [] for name in modes}
    for _ in range(TIMELAPSE_ROUNDS):
        for name, every in modes.items():
            for steps in (STEPS // 2, STEPS):
                run = _timelapse_run(content, style, params, steps, every)
                rounds[name, steps].append(run[4])
                if steps == STEPS:
                    gaps[name].extend(np.diff(run[5][2:]) * 1e3)
    gap_ms = {name: float(np.mean(v)) for name, v in gaps.items()}

    def per_step_ms(name: str, pick) -> float:
        return (
            pick(rounds[name, STEPS]) - pick(rounds[name, STEPS // 2])
        ) / (STEPS // 2) * 1e3

    ms = {name: per_step_ms(name, min) for name in modes}
    ratio = ms["save_every=1"] / ms["frames off"]
    per_round = sorted(
        per_step_ms("save_every=1", lambda v, i=i: v[i])
        / per_step_ms("frames off", lambda v, i=i: v[i])
        for i in range(TIMELAPSE_ROUNDS)
    )
    print(
        f"timelapse {SIZE}x{SIZE} {STEPS} steps save_every=1: "
        f"{len(frames)} frames in step order, last frame equal to the "
        f"final image, async vs sync frames max abs diff {sync_diff}, "
        f"launches conv {conv_n} gram {gram_n}; ms/step "
        + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
        + f", save_every=1 over frames off {ratio:.4f}; the same ratio "
        f"round by round: median {statistics.median(per_round):.4f}, "
        f"least {per_round[0]:.4f}, greatest {per_round[-1]:.4f}; mean "
        f"step interval ms "
        + ", ".join(f"{k} {v:.3f}" for k, v in gap_ms.items())
        + f", save_every=1 over frames off "
        f"{gap_ms['save_every=1'] / gap_ms['frames off']:.4f}",
    )
    _full_timelapse()
    return conv_n, gram_n


def _mp4_frames(path: Path) -> int:
    """Frames in an MP4's video stream, counted by ffmpeg."""
    out = subprocess.run(
        ["ffmpeg", "-hide_banner", "-i", str(path), "-map", "0:v:0",  # noqa: S607
         "-c", "copy", "-f", "null", "-"],
        capture_output=True, text=True, check=True, timeout=120,
    )
    counts = re.findall(r"frame=\s*(\d+)", out.stderr)
    if not counts:
        msg = f"no frame count from ffmpeg: {out.stderr[-300:]}"
        raise AssertionError(msg)
    return int(counts[-1])


def _full_timelapse() -> None:
    """``main.style_transfer`` at the shipped video defaults, if it can."""
    missing = []
    if shutil.which("ffmpeg") is None:
        missing.append("ffmpeg not on PATH")
    if importlib.util.find_spec("PIL") is None:
        missing.append("Pillow not importable")
    if missing:
        print(f"timelapse full run: not run: {'; '.join(missing)}")
        return
    from PIL import Image  # noqa: PLC0415 - optional on this machine

    root = Path(__file__).resolve().parent / PACKAGE / "build" / "timelapse"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    paths = []
    for name, arr in zip(("content", "style"), _images(SIZE, 3)):
        path = root / f"{name}.png"
        Image.fromarray(np.round(arr[0] * 255).astype(np.uint8)).save(path)
        paths.append(str(path))
    steps, every = STEPS, 2
    config = StyleTransferConfig(
        output=OutputConfig(output=str(root / "out"), log_every=LOG_EVERY),
        optimization=OptimizationConfig(
            steps=steps, allow_random_weights=True,
        ),
        video=VideoConfig(save_every=every),
        hardware=HardwareConfig(device="cuda"),
    )
    video = config.video
    t0 = time.perf_counter()
    style_transfer(
        InputPaths(*paths), config, progress_bar=_Progress(),
    )
    seconds = time.perf_counter() - t0
    mp4 = root / "out" / "timelapse_content_x_style.mp4"
    if not mp4.is_file() or mp4.stat().st_size == 0:
        msg = f"no MP4 at {mp4}"
        raise AssertionError(msg)
    fps = video.fps
    expected = (
        max(1, min(round(fps * segments.INTRO_FADE_IN_SECONDS),
                   segments.INTRO_MAX_FADE_FRAMES))
        + round(fps * video.intro_duration_seconds)
        + max(1, min(round(fps * segments.INTRO_CROSSFADE_SECONDS),
                     segments.INTRO_MAX_CROSSFADE_FRAMES))
        + steps // every
        + max(segments.FINAL_TIMELAPSE_MIN_FRAMES,
              round(fps * segments.FINAL_TIMELAPSE_HOLD_SECONDS))
        + max(1, min(round(fps * segments.OUTRO_CROSSFADE_SECONDS),
                     segments.OUTRO_MAX_CROSSFADE_FRAMES))
        + max(segments.FINAL_COMPARISON_MIN_FRAMES,
              round(fps * video.outro_duration_seconds))
    )
    frames = _mp4_frames(mp4)
    if frames != expected:
        msg = f"MP4 has {frames} frames, expected {expected}"
        raise AssertionError(msg)
    written = sorted(p.name for p in (root / "out").iterdir())
    print(
        f"timelapse full run: style_transfer {SIZE}x{SIZE} {steps} steps "
        f"save_every={every}, realtime MP4 with intro and outro: "
        f"{mp4.stat().st_size} bytes, {frames} frames (expected "
        f"{expected}), {seconds:.2f} s; wrote {written}",
    )


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
    # The whole objective: Adam with the TV and Laplacian terms, style
    # weights, a two-style blend, luminance color preservation, and a
    # 2-step warm start at 32x32.
    extra = _images(64, 5)[0]
    runs = {
        d: run_style_transfer(
            content, style,
            _config(
                3, d, init_method="content", optimizer="adam", lr=0.1,
                tv_w=1e-2, lap_w=1e2, coarse_steps=2,
                style_layer_weights=[1, 1, 0.5, 0.25, 0.25],
                preserve_color="luminance",
            ),
            style_blend=[(style, 0.7), (extra, 0.3)],
        )
        for d in ("cuda", "cpu")
    }
    gpu, cpu = (runs[d][1]["total_loss"] for d in ("cuda", "cpu"))
    np.testing.assert_allclose(gpu, cpu, rtol=1e-3)
    img_err = float(
        (runs["cuda"][0].cpu() - runs["cpu"][0]).abs().max(),
    )
    print(f"small reference 64x64 whole objective, Adam, 2 coarse steps "
          f"at 32x32, 3 steps: cuda {gpu} cpu {cpu} image max abs diff "
          f"{img_err:.3g}")


class _LogLines(logging.Handler):
    """Keeps the port logger's messages while a phase runs."""

    def __init__(self) -> None:
        """Start empty."""
        super().__init__()
        self.lines: list[str] = []

    def emit(self, record: logging.LogRecord) -> None:
        """Keep one message."""
        self.lines.append(record.getMessage())


def _convs_through(arch, last: int) -> int:
    return sum(1 for i in arch.conv_indices if i <= last)


def _launches_wanted(arch, opt, size: int, styles: int) -> tuple[int, int]:
    """Conv and Gram launches of a run, worked out from the code.

    ``opt`` is the run's optimization config as the run left it (its
    ``coarse_steps`` resolved), ``size`` the content's side and
    ``styles`` the number of styles blended.

    Targets: each style's sweep to the deepest style tap (one Gram per
    style tap) and one content sweep to the deepest content tap
    (``targets_maybe_blended``: the content layers ride with the first
    style only), at full size and again at each coarse level. A step
    with one evaluation (L-BFGS ``max_iter=1`` or Adam): the sweep to
    the deepest tap, every conv's input gradient (the image is the
    leaf), and one Gram per style tap.
    """
    plan = plan_pyramid(size, size, opt.coarse_steps, opt.pyramid_levels)
    style_convs = _convs_through(arch, max(opt.style_layers))
    content_convs = _convs_through(arch, max(opt.content_layers))
    step_convs = 2 * _convs_through(
        arch, max(opt.style_layers + opt.content_layers),
    )
    n_style = len(opt.style_layers)
    resolutions = 1 + len(plan)
    total_steps = opt.steps + sum(level[2] for level in plan)
    conv = (
        resolutions * (styles * style_convs + content_convs)
        + step_convs * total_steps
    )
    gram = resolutions * styles * n_style + n_style * total_steps
    return conv, gram


def _chroma_error(image: torch.Tensor, content: np.ndarray) -> float:
    """Largest YIQ chrominance difference where no channel is clipped."""
    out = image[0].double().cpu().numpy()
    unclipped = ((out > 1e-6) & (out < 1 - 1e-6)).all(axis=-1)
    if unclipped.mean() < 0.5:  # noqa: PLR2004
        msg = f"only {unclipped.mean():.3f} of the pixels are unclipped"
        raise AssertionError(msg)
    to_iq = RGB_TO_YIQ[1:].T
    diff = np.abs(out @ to_iq - content[0].astype(np.float64) @ to_iq)
    return float(diff[unclipped].max())


def _objective() -> tuple[int, int]:
    """The whole objective at 1024x1024 through ``run_style_transfer``.

    Full-width VGG19 (seeded), two 1024x1024 styles (numpy seeds 2 and
    3) blended 0.7/0.3, TV and Laplacian terms, per-layer style
    weights, luminance color preservation, the shipped L-BFGS for 20
    steps with the warm start left at auto: 4 steps at 512x512 first.
    """
    size = OBJECTIVE_SIZE
    content = _images(size, 1)[0]
    styles = [_images(size, seed)[0] for seed in (2, 3)]
    blend = list(zip(styles, (0.7, 0.3), strict=True))

    def config(n_steps: int, coarse_steps: int = -1):
        return _config(
            n_steps, "cuda", tv_w=1e-2, lap_w=1e2,
            style_layer_weights=[1, 1, 0.5, 0.25, 0.25],
            preserve_color="luminance", coarse_steps=coarse_steps,
        )

    before = _fresh_peak()
    logs = _LogLines()
    logger.addHandler(logs)
    counted = config(STEPS)
    try:
        (image, history), run_s, launches = _counted_run(
            lambda: run_style_transfer(
                content, styles[0], counted, style_blend=blend,
            ),
        )
    finally:
        logger.removeHandler(logs)
    peak = torch.cuda.max_memory_allocated()

    coarse_steps = counted.optimization.coarse_steps
    half = size // 2
    started = f"Coarse warm start: {coarse_steps} steps at {half}x{half}"
    done = f"Coarse level {half}x{half} done"
    if coarse_steps != STEPS // 5 or not all(
        any(line.startswith(want) for line in logs.lines)
        for want in (started, done)
    ):
        msg = f"coarse warm start did not run: {logs.lines}"
        raise AssertionError(msg)
    losses = history["total_loss"]
    want = _launches_wanted(
        VGG19, counted.optimization, size, len(blend),
    )
    _check_run("objective", image, losses, launches, want, size)
    chroma = _chroma_error(image, content)
    if not chroma <= CHROMA_TOL:
        msg = f"objective: chrominance off by {chroma:.3g} > {CHROMA_TOL}"
        raise AssertionError(msg)
    # The timed runs keep the counted run's coarse budget, so the warm
    # start cancels out with the targets.
    ms_step = _ms_per_step(
        lambda n: run_style_transfer(
            content, styles[0], config(n, coarse_steps), style_blend=blend,
        ),
    )
    print(
        f"objective {size}x{size} vgg19 L-BFGS {STEPS} steps, blend "
        f"0.7/0.3, tv_w 1e-2, lap_w 1e2, style weights 1,1,0.5,0.25,0.25,"
        f" luminance: coarse warm start {coarse_steps} steps at "
        f"{half}x{half} ran; loss {losses[0]:.6g} -> {losses[-1]:.6g}; "
        f"launches conv {launches[0]} gram {launches[1]} (expected "
        f"{want}); chrominance max abs diff {chroma:.3g} (tol "
        f"{CHROMA_TOL}); ms/step at {size}x{size} {ms_step:.3f}; run s "
        f"{run_s:.3f}; max_memory_allocated {peak}, of which allocated "
        f"before the run {before} (the run's own {peak - before})",
    )
    return launches


def _adam_vgg16() -> tuple[int, int]:
    """Adam on full-width VGG16 (seeded) at 512x512, 20 steps.

    ``lr`` 0.1, the rate the golden corpus runs Adam at (the shipped
    1.0 is L-BFGS's step scale).
    """
    content, style = _images(SIZE, 4)

    def config(n_steps: int):
        return _config(
            n_steps, "cuda", model="vgg16", optimizer="adam", lr=0.1,
        )

    counted = config(STEPS)
    (image, history), run_s, launches = _counted_run(
        lambda: run_style_transfer(content, style, counted),
    )
    losses = history["total_loss"]
    want = _launches_wanted(VGG16, counted.optimization, SIZE, 1)
    _check_run("adam vgg16", image, losses, launches, want, SIZE)
    ms_step = _ms_per_step(
        lambda n: run_style_transfer(content, style, config(n)),
    )
    print(
        f"adam vgg16 {SIZE}x{SIZE} {STEPS} steps lr 0.1: loss "
        f"{losses[0]:.6g} -> {losses[-1]:.6g}; launches conv "
        f"{launches[0]} gram {launches[1]} (expected {want}); ms/step "
        f"{ms_step:.3f}; run s {run_s:.3f}",
    )
    return launches

def _style_arrays(n: int) -> list[np.ndarray]:
    """``n`` style images: numpy seeds 2, 3, ...; seed 5's is 384x640."""
    out = []
    for seed in range(2, 2 + n):
        h, w = ODD_STYLE[1] if seed == ODD_STYLE[0] else (SIZE, SIZE)
        rng = np.random.default_rng(seed)
        out.append(rng.uniform(size=(1, h, w, 3)).astype(np.float32))
    return out


def _batch_config(steps: int, *, media: bool, **opt):
    """The batch phase's config: shipped defaults from the content."""
    config = _config(steps, "cuda", init_method="content", **opt)
    config.output.plot_losses = False
    config.video.save_every = BATCH_SAVE_EVERY
    config.video.create_gif = media
    config.video.create_video = media
    return config


def _batch_run(content, styles, config, params=None, *, sinks=None,
               capture=None):
    """``prepare_multi_style`` then ``run_multi_style_loop``.

    Returns the final stacked images, the last state, the bundle, the
    ``(steps, S)`` losses (kept on the device until the end), the host
    clock at the end of each step and the conv and Gram launches of the
    step loop alone. ``sinks`` (a dict) collects in-memory sinks by
    file name; ``capture(step, images)`` sees every step.
    """
    bundle, images = prepare_multi_style(
        content, styles, config, params=params,
    )
    prepared = (conv3x3.launches.count, gram.launches.count)
    losses: list[torch.Tensor] = []
    step_ends: list[float] = []

    def on_step_end(step, imgs, aux):
        losses.append(aux.loss)
        step_ends.append(time.perf_counter())
        if capture is not None:
            capture(step, imgs)

    def make_sink(kind, name):
        del kind
        sinks[name] = _FrameSink()
        return sinks[name]

    images, state, errors = run_multi_style_loop(
        bundle, images, config,
        Path(__file__).resolve().parent / PACKAGE / "build" / "batch",
        [f"s{i}" for i in range(len(styles))],
        progress_bar=_Progress(),
        make_sink=make_sink if sinks is not None else None,
        on_step_end=on_step_end,
    )
    if errors:
        raise errors[0]
    loop_launches = (
        conv3x3.launches.count - prepared[0],
        gram.launches.count - prepared[1],
    )
    return (
        images, state, bundle, torch.stack(losses), step_ends,
        loop_launches,
    )


def _packed(images: torch.Tensor) -> torch.Tensor:
    return image_io.pack_uint8_frames_batch(
        image_io.prepare_image_for_output(images, normalize=True),
    )


def _device_ms_per_step(bundle, images, state, steps: int = 5) -> float:
    """Device kernel time of one step, from ``torch.profiler``."""
    for _ in range(2):
        images, state, _ = bundle.update_fn(images, state)
    torch.cuda.synchronize()
    acts = [
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA,
    ]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            images, state, _ = bundle.update_fn(images, state)
        torch.cuda.synchronize()
    busy_us = sum(
        e.self_device_time_total for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
    )
    if busy_us <= 0:
        msg = "the profiler saw no device time"
        raise AssertionError(msg)
    return busy_us / steps / 1e3


def _batch() -> tuple[int, int]:
    """The multi-style batch at 512x512: S = 4, then S = 1, 4 and 8."""
    content = _images(SIZE, 1)[0]
    styles = _style_arrays(max(BATCH_TIMED))
    params = load_pretrained_params(
        torch.device("cuda"), allow_random=True, seed=0,
    )
    config = _batch_config(STEPS, media=True)
    sinks: dict[str, _FrameSink] = {}
    cadence: list[torch.Tensor] = []

    def capture(step, imgs):
        if step % BATCH_SAVE_EVERY == 0:
            cadence.append(_packed(imgs))

    before = _fresh_peak()
    (images, _, _, losses, _, _), run_s, launches = _counted_run(
        lambda: _batch_run(
            content, styles[:BATCH_STYLES], config, params, sinks=sinks,
            capture=capture,
        ),
    )
    peak = torch.cuda.max_memory_allocated()
    want = _launches_wanted(
        VGG19, config.optimization, SIZE, BATCH_STYLES,
    )
    if launches != want:
        msg = f"batch: launches conv/gram {launches}, expected {want}"
        raise AssertionError(msg)
    curves = losses.cpu().numpy()
    if curves.shape != (STEPS, BATCH_STYLES) or not np.isfinite(
        curves,
    ).all() or not (curves[-1] < curves[0]).all():
        msg = f"batch: losses not finite and decreasing: {curves}"
        raise AssertionError(msg)
    final = _packed(images).cpu().numpy()
    expected = [c.cpu().numpy() for c in cadence]
    if len(sinks) != 2 * BATCH_STYLES:
        msg = f"batch: sinks {sorted(sinks)}"
        raise AssertionError(msg)
    for name, sink in sinks.items():
        i = int(name.rsplit("_s", 1)[1].split(".")[0])
        frames = sink.frames
        if len(frames) != STEPS // BATCH_SAVE_EVERY or any(
            f.shape != (SIZE, SIZE, 3) or f.dtype != np.uint8
            for f in frames
        ):
            msg = f"batch {name}: {len(frames)} frames"
            raise AssertionError(msg)
        if not all(
            np.array_equal(f, e[i]) for f, e in zip(frames, expected,
                                                    strict=True)
        ):
            msg = f"batch {name}: frames out of step order"
            raise AssertionError(msg)
        if not np.array_equal(frames[-1], final[i]):
            msg = f"batch {name}: last frame is not the final image"
            raise AssertionError(msg)
    # Each style's curve against a single run of that style, and the
    # same single run with its content perturbed by 1e-7 relative: the
    # shipped fixed-step L-BFGS grows such a difference past 1e-3, so
    # the batch keeps each style's arithmetic the single run's.
    single_err, image_err = [], []
    for i in range(BATCH_STYLES):
        single_image, history = run_style_transfer(
            content, styles[i], _config(STEPS, "cuda", init_method="content"),
        )
        single = np.asarray(history["total_loss"])
        rel = np.abs(curves[:, i] - single) / np.abs(single)
        if not rel.max() <= 1e-3:  # noqa: PLR2004
            msg = (
                f"batch style {i}: curve off its single run by "
                f"{rel.max():.3g}: {curves[:, i]} vs {single}"
            )
            raise AssertionError(msg)
        single_err.append(float(rel.max()))
        batch_image = image_io.prepare_image_for_output(
            images[i], normalize=True,
        )
        image_err.append(float((batch_image - single_image).abs().max()))
    rng = np.random.default_rng(9)
    nudged = content * (1 + 1e-7 * rng.standard_normal(content.shape))
    _, history = run_style_transfer(
        nudged.astype(np.float32), styles[0],
        _config(STEPS, "cuda", init_method="content"),
    )
    _, base = run_style_transfer(
        content, styles[0], _config(STEPS, "cuda", init_method="content"),
    )
    nudge_err = float(np.max(
        np.abs(np.asarray(history["total_loss"]) - base["total_loss"])
        / np.abs(base["total_loss"]),
    ))
    print(
        f"batch {SIZE}x{SIZE} vgg19 L-BFGS S={BATCH_STYLES} (styles "
        f"{[tuple(x.shape[1:3]) for x in styles[:BATCH_STYLES]]}) {STEPS} "
        f"steps save_every={BATCH_SAVE_EVERY} GIF+MP4 in memory: losses "
        f"{curves[0].tolist()} -> {curves[-1].tolist()}; launches conv "
        f"{launches[0]} gram {launches[1]} (expected {want}); "
        f"{STEPS // BATCH_SAVE_EVERY} frames per style and sink in step "
        f"order, the last equal to the final image; each style's curve "
        f"within {max(single_err):.3g} relative of its single run "
        f"(per style {[f'{e:.3g}' for e in single_err]}), final images "
        f"max abs diff {image_err} (a single run against itself with its "
        f"content perturbed by 1e-7 relative: {nudge_err:.3g}); run s "
        f"{run_s:.3f}; max_memory_allocated {peak}, of which allocated "
        f"before the run {before} (the run's own {peak - before})",
    )
    _batch_speed(content, styles, params)
    return launches


def _batch_speed(content, styles, params) -> None:
    """Frames off: S = 1, 4, 8 and the single run, rounds interleaved."""
    gaps: dict[str, list[float]] = {"single": []}
    gaps |= {f"S={n}": [] for n in BATCH_TIMED}
    peaks: dict[str, int] = {}
    steps_launches: dict[str, tuple[int, int]] = {}
    last = {}
    for _ in range(BATCH_ROUNDS):
        run = _timelapse_run(content, styles[0], params, STEPS, None)
        gaps["single"].append(float(np.mean(np.diff(run[5][2:]))) * 1e3)
        for n in BATCH_TIMED:
            config = _batch_config(STEPS, media=False)
            before = _fresh_peak()
            out, _, counts = _counted_run(
                lambda n=n, config=config: _batch_run(
                    content, styles[:n], config, params,
                ),
            )
            key = f"S={n}"
            peaks[key] = torch.cuda.max_memory_allocated() - before
            want = _launches_wanted(VGG19, config.optimization, SIZE, n)
            if counts != want:
                msg = f"batch {key}: launches {counts}, expected {want}"
                raise AssertionError(msg)
            steps_launches[key] = tuple(c / STEPS for c in out[5])
            gaps[key].append(float(np.mean(np.diff(out[4][2:]))) * 1e3)
            last[key] = out
    ms = {k: statistics.median(v) for k, v in gaps.items()}
    busy = {}
    for n in BATCH_TIMED:
        key = f"S={n}"
        images, state, bundle, _, _, _ = last.pop(key)
        busy[key] = _device_ms_per_step(bundle, images, state) / ms[key]
        del images, state, bundle
    if len(set(steps_launches.values())) != 1:
        msg = f"batch: a step's launches grow with S: {steps_launches}"
        raise AssertionError(msg)
    print(
        f"batch speed {SIZE}x{SIZE} frames off, {BATCH_ROUNDS} rounds "
        f"interleaved, median of the mean step interval over steps 3-{STEPS}:"
        + "".join(
            f" {k} {v:.3f} ms/step"
            + (f" {int(k[2:]) * 1e3 / v:.2f} style-steps/s" if k != "single"
               else f" {1e3 / v:.2f} steps/s")
            for k, v in ms.items()
        )
        + f"; rounds {gaps}; device busy share (profiled device ms over "
        f"the step interval) "
        + ", ".join(f"{k} {v:.3f}" for k, v in busy.items())
        + f"; launches per step conv/gram {steps_launches['S=1']} at every "
        f"S; the run's own peak memory "
        + ", ".join(f"{k} {v}" for k, v in peaks.items()),
    )


def _small_batch_reference() -> None:
    """A 64x64 batch of 2 on the card against the same on the CPU.

    As the single run's whole-objective reference: Adam with every term
    (TV, Laplacian, per-layer style weights, luminance) and a 2-step
    warm start at 32x32; both start from the content image. (The
    shipped fixed-step L-BFGS grows the card's and the CPU's rounding
    differences past 1e-3 within a few steps; the batch phase holds the
    batched L-BFGS to the single one on the card, and the first
    reference holds that to the CPU.)
    """
    content = _images(64, 1)[0]
    styles = [_images(64, 5)[0], _images(64, 6)[0]]
    runs = {}
    for device in ("cuda", "cpu"):
        config = _config(
            3, device, init_method="content", optimizer="adam", lr=0.1,
            tv_w=1e-2, lap_w=1e2, coarse_steps=2,
            style_layer_weights=[1, 1, 0.5, 0.25, 0.25],
            preserve_color="luminance",
        )
        config.output.plot_losses = False
        config.video.create_video = False
        bundle, images = prepare_multi_style(content, styles, config)
        losses = []
        images, _, _ = run_multi_style_loop(
            bundle, images, config, Path("unused"), ["a", "b"],
            progress_bar=_Progress(),
            on_step_end=lambda _s, _i, aux, out=losses: out.append(aux.loss),
        )
        runs[device] = (torch.stack(losses).cpu().numpy(), images.cpu())
    gpu, cpu = runs["cuda"][0], runs["cpu"][0]
    np.testing.assert_allclose(gpu, cpu, rtol=1e-3)
    img_err = float((runs["cuda"][1] - runs["cpu"][1]).abs().max())
    print(
        f"small reference 64x64 batch of 2, whole objective, Adam, 2 "
        f"coarse steps at 32x32, 3 steps: cuda {gpu.tolist()} cpu "
        f"{cpu.tolist()} image max abs diff {img_err:.3g}",
    )


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
        hgmma = _hgmma_count(kernel.library)
        print(f"  {kernel.name}: HGMMA instructions in SASS: {hgmma}")
        if hgmma == 0:
            msg = f"{kernel.name}: no wgmma (HGMMA) in the built library"
            raise AssertionError(msg)
        for line in kernel.ptxas_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {kernel.name}: {line.strip()}")

    records = {}
    for name, source, replaces, batch_key in (
        ("conv3x3", "csrc/conv3x3.cu", "ops/pallas_conv.py:63", "n4_512"),
        ("gram", "csrc/gram.cu", "ops/pallas_gram.py:40", "batched_s4_512"),
    ):
        main_rec, *extra = (
            Record(
                name, f"{PACKAGE}/{source}",
                f"style_transfer_visualizer_tpu/{replaces}",
            )
            for _ in range(3)
        )
        records[name] = (main_rec, dict(zip(
            ("at_1024", batch_key), extra, strict=True,
        )))
    _check_conv(records["conv3x3"][0], *records["conv3x3"][1].values())
    _vgg16_shapes_covered()
    _check_gram(records["gram"][0], *records["gram"][1].values())
    phases = {"main path": _main_path()}
    phases["timelapse"] = _timelapse()
    phases["objective"] = _objective()
    phases["adam vgg16"] = _adam_vgg16()
    phases["batch"] = _batch()
    _small_reference()
    _small_batch_reference()

    kernels = [
        rec.finish({k: v[i] for k, v in phases.items()}, extras)
        for i, (rec, extras) in enumerate(records.values())
    ]
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
