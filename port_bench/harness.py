"""One run of one cell: set-up, the measured window, the trace, the check.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``: a
configuration (``port_bench/configs/<config>.json``) under a traffic
mix (``port_bench/traffic/<traffic>.json``), with its limits
(``port_bench/limits/<cell>.json``); each metric is read by
``port_bench/metrics/<name before the first dot>.py``, and what
depends on a configuration's architecture (weights, the port's
parameters, the reference's objective, kernel counters, step FLOPs) by
its family, ``port_bench/families/<family>.py``. The harness finds
all of them by name, so a cell, a configuration, an architecture or a
metric is added by adding files and entries.

The window drives the port's own entry, image after image, each a new
content and style draw of the mix's sizes: ``main.prepare_model_and_input``
and ``engine.runner.OptimizationRunner`` for a single image (the path
of ``main.run_style_transfer``), ``main.prepare_multi_style`` and
``main.run_multi_style_loop`` for a style batch, on every rank of a
style x space mesh when the mix asks for one. It closes at the end of
the first image that ends after ``--seconds``. Afterwards, with the
port's state freed, the plain reference (``port_bench/reference``)
follows the first steps of every image and style of the window from
the same seeds, and the gaps decide ``correct``.
"""
from __future__ import annotations

import csv
import importlib.util
import json
import math
import shutil
import sys
import tempfile
import time
from pathlib import Path

import torch

from port_bench import families, generate, trace
from port_bench.reference import optimizers as ref_optim

ROOT = Path(__file__).resolve().parents[1]
#: Top-level modules no process of a run may hold.
FORBIDDEN = ("jax", "jaxlib", "flax", "style_transfer_visualizer_tpu")
#: Seconds any collective of a mesh run may wait, and the whole run.
MESH_TIMEOUT_S = 120.0
MESH_DEADLINE_S = 330.0


class RunError(RuntimeError):
    """A run that cannot report: it exits non-zero and prints no result."""


def _json(path: Path) -> dict:
    try:
        return json.loads(path.read_text())
    except FileNotFoundError:
        msg = f"missing {path.relative_to(ROOT) if path.is_relative_to(ROOT) else path}"
        raise RunError(msg) from None


def load_cell(name: str, root: Path = ROOT) -> dict:
    """The cell ``name`` with its configuration, mix, limits and the
    metrics it reports, read from ``root``."""
    bench = _json(root / "BENCHMARK.json")
    works = {w["name"]: w for w in bench["workloads"]}
    if name not in works:
        msg = f"no workload {name!r} in BENCHMARK.json"
        raise RunError(msg)
    work = works[name]
    config = _json(root / "port_bench" / "configs" / f"{work['config']}.json")
    try:
        families.load(config)
    except LookupError as exc:
        raise RunError(str(exc)) from None
    end_to_end = [
        m for m in bench["end_to_end"] if name in m.get("workloads", [name])
    ]
    moved = {m["name"] for m in end_to_end}
    per_layer = [
        m for m in bench["per_layer"]
        if name in m.get("workloads", [name] if m["moves"] in moved else [])
    ]
    return {
        "name": name,
        "chips": work["chips"],
        "config": config,
        "traffic": _json(root / "port_bench" / "traffic" / f"{work['traffic']}.json"),
        "limits": _json(root / "port_bench" / "limits" / f"{name}.json"),
        "end_to_end": end_to_end,
        "per_layer": per_layer,
        "root": str(root),
    }


def _reader(root: str, metric: str):
    base = metric.split(".", 1)[0]
    path = Path(root) / "port_bench" / "metrics" / f"{base}.py"
    spec = importlib.util.spec_from_file_location(f"port_bench_metric_{base}", path)
    if spec is None or not path.is_file():
        msg = f"no reader port_bench/metrics/{base}.py for {metric}"
        raise RunError(msg)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules() -> list[str]:
    """The forbidden top-level names this process holds, compared whole."""
    held = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(held.intersection(FORBIDDEN))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _plant(spec: dict) -> None:
    """Call the ``module:function`` a test names, in every process of
    the run, before the port runs (a planted fault)."""
    if spec.get("plant"):
        module, func = spec["plant"].split(":")
        getattr(importlib.import_module(module), func)()


def _override(config, sections: dict) -> None:
    """Set a configuration's or a mix's ``port`` object on the port's
    configuration: ``{section: {field: value}}``, any field of
    ``StyleTransferConfig``'s sections."""
    for section, fields in sections.items():
        part = getattr(config, section, None)
        for key, value in fields.items():
            if part is None or not hasattr(part, key):
                msg = f"the port's configuration has no {section}.{key}"
                raise RunError(msg)
            setattr(part, key, value)
    config.validate()


def _csv_losses(path: Path) -> list[tuple[float, float, float]]:
    """A loss CSV's ``(total, style, content)`` rows; the file goes."""
    with path.open() as handle:
        rows = list(csv.DictReader(handle))
    path.unlink()
    return [
        (float(r["total_loss"]), float(r["style_loss"]), float(r["content_loss"]))
        for r in rows
    ]


class _FirstLoss:
    """The progress reporter the port's loops take: notes when the
    first loss value reaches the host."""

    def __init__(self) -> None:
        self.runner = None
        self.at: float | None = None

    def update(self, n=1):
        if self.at is None and self.runner is not None and (
            self.runner.latest_logged is not None
        ):
            self.at = time.perf_counter()

    def set_postfix(self, ordered_dict=None, refresh=True):
        if self.at is None:
            self.at = time.perf_counter()

    def close(self) -> None:
        return None


class _MemorySink:
    """Stands in for the timelapse encoder: keeps the frames."""

    def __init__(self) -> None:
        self.frames: list = []

    def append_data(self, frame) -> None:
        self.frames.append(frame)

    def close(self) -> None:
        return None


class _Images:
    """Runs one image of the cell's mix through the port's entry."""

    def __init__(self, spec: dict, device, mesh) -> None:
        self.spec = spec
        self.cell = spec["cell"]
        self.config = self.cell["config"]
        self.traffic = self.cell["traffic"]
        self.device = device
        self.mesh = mesh
        self.writes = mesh is None or mesh.writes
        self.family = families.load(self.config)
        self.params = self.family.port_params(
            self.config,
            self.family.make_weights(self.config, spec["seed"], device),
            device,
        )

    def _port_config(self, index: int, steps: int, csv_path):
        from style_transfer_visualizer_tpu_torch.config import (  # noqa: PLC0415
            HardwareConfig,
            OptimizationConfig,
            OutputConfig,
            StyleTransferConfig,
            VideoConfig,
        )

        model, mix = self.config, self.traffic
        _, start_seed = generate.image_seeds(self.spec["seed"], index)
        mesh = mix.get("mesh") or {"space": 1}
        config = StyleTransferConfig(
            optimization=OptimizationConfig(
                steps=steps,
                style_w=model["style_w"],
                content_w=model["content_w"],
                lr=model["lr"],
                init_method=model["init_method"],
                seed=start_seed,
                normalize=True,
                style_layers=list(model["style_layers"]),
                content_layers=list(model["content_layers"]),
                model=model["architecture"],
                optimizer=model["optimizer"],
                lbfgs_max_iter=model["lbfgs_max_iter"],
                lbfgs_max_eval=model["lbfgs_max_eval"],
                lbfgs_history_size=model["lbfgs_history_size"],
                lbfgs_history_dtype=model["lbfgs_history_dtype"],
                lbfgs_direction=model["lbfgs_direction"],
                coarse_steps=mix["coarse_steps"],
            ),
            hardware=HardwareConfig(
                device=str(self.device.type),
                precision=self.spec["precision"],
                spatial_shards=mesh["space"],
            ),
            video=VideoConfig(
                save_every=mix["save_every"], create_video=False,
                create_gif=False,
            ),
            output=OutputConfig(
                output=self.spec["out_dir"],
                log_every=mix["log_every"],
                log_loss=None if csv_path is None else str(csv_path),
                plot_losses=False,
            ),
        )
        _override(config, model.get("port", {}))
        _override(config, mix.get("port", {}))
        if csv_path is not None and config.output.log_every != 1:
            msg = "a loss CSV the check reads needs log_every 1"
            raise RunError(msg)
        return config

    def run(self, index: int, steps: int | None = None):
        """One image's record, and the optimizer state it ended with."""
        from style_transfer_visualizer_tpu_torch import image_io, main  # noqa: PLC0415
        from style_transfer_visualizer_tpu_torch.engine.runner import (  # noqa: PLC0415
            OptimizationRunner,
        )

        mix = self.traffic
        steps = steps or mix["steps"]
        record_function = torch.profiler.record_function
        t_entry = time.perf_counter()
        with record_function("port_bench.inputs"):
            content, styles = generate.make_images(
                mix, self.spec["seed"], index, self.device,
            )
        probe = _FirstLoss()
        out_dir = Path(self.spec["out_dir"])
        if mix["entry"] == "single":
            csv_path = out_dir / f"loss_{index}.csv" if mix.get("loss_csv") else None
            config = self._port_config(index, steps, csv_path)
            with record_function("port_bench.prepare"):
                bundle, start = main.prepare_model_and_input(
                    content, styles[0], config, params=self.params,
                    mesh=self.mesh,
                )
            sink = _MemorySink() if mix["frames"] else None
            runner = OptimizationRunner(
                bundle.update_fn, bundle.opt_state, start, config,
                progress_bar=probe, video_writer=sink,
                chunked_update_fn=bundle.chunked_update_fn, mesh=self.mesh,
            )
            probe.runner = runner
            with record_function("port_bench.loop"):
                image, history, _ = runner.run()
            # The probe and the runner refer to each other: unlinked, the
            # runner and its optimizer state go when the image ends, not
            # at a later garbage collection inside another image.
            probe.runner = None
            state = runner.opt_state
            losses = []
            if self.writes:
                with record_function("port_bench.final"):
                    # The final image reaches the host, as its PNG needs it.
                    image_io.pack_uint8_frame(
                        image_io.prepare_image_for_output(image, normalize=True),
                    ).cpu()
                losses = [_csv_losses(csv_path) if csv_path else list(zip(
                    history["total_loss"], history["style_loss"],
                    history["content_loss"], strict=True,
                ))]
        else:
            names = [f"s{i}" for i in range(len(styles))]
            csv_path = out_dir / f"loss_{index}.csv"
            config = self._port_config(index, steps, csv_path)
            with record_function("port_bench.prepare"):
                bundle, start = main.prepare_multi_style(
                    content, styles, config, params=self.params,
                    mesh=self.mesh,
                )
            with record_function("port_bench.loop"):
                images, state, errors = main.run_multi_style_loop(
                    bundle, start, config, out_dir, names,
                    progress_bar=probe, mesh=self.mesh,
                )
            if errors:
                raise errors[0]
            losses = []
            if self.writes:
                with record_function("port_bench.final"):
                    image_io.pack_uint8_frames_batch(
                        image_io.prepare_image_for_output(
                            images, normalize=True,
                        ),
                    ).cpu()
                losses = [
                    _csv_losses(csv_path.with_name(f"{csv_path.stem}_{name}.csv"))
                    for name in names
                ]
        del bundle
        t_end = time.perf_counter()
        return state, {
            "index": index,
            "t_entry": t_entry,
            "t_first": probe.at if probe.at is not None else t_end,
            "t_end": t_end,
            "steps": steps,
            "styles": len(styles),
            "losses": [rows[: self.cell["limits"]["steps"]] for rows in losses],
        }


def direction_gap(config: dict, state, mesh=None) -> float | None:
    """The widest gap, over the styles, of the L-BFGS direction the
    port's last step took from the reference's compact direction over
    the same ring, ``gamma`` and gradient (the port's final state, the
    whole image's on a mesh): ``|d - d_ref| / |d_ref|``."""
    if config["optimizer"] != "lbfgs":
        return None
    if mesh is not None:
        from style_transfer_visualizer_tpu_torch.parallel.spatial import (  # noqa: PLC0415
            gather_state,
        )

        state = gather_state(mesh, state)
        if not mesh.writes:
            return None
    torch.backends.cuda.matmul.allow_tf32 = False
    ring = getattr(torch, config["lbfgs_history_dtype"])
    fields = ("s_hist", "y_hist", "hist_len", "hist_pos", "h_diag",
              "prev_grad", "direction")
    batched = state.s_hist.dim() == 3  # noqa: PLR2004
    s_hist, y_hist, length, pos, gamma, grad, direction = (
        getattr(state, f) if batched else getattr(state, f)[None]
        for f in fields
    )
    worst = 0.0
    for i in range(s_hist.shape[0]):
        m, n = s_hist.shape[1], int(length[i])
        if n == 0:
            continue
        order = [(int(pos[i]) - n + k) % m for k in range(n)]
        want = ref_optim.compact_direction(
            grad[i], s_hist[i][order], y_hist[i][order], gamma[i], ring,
        )
        gap = float((direction[i] - want).norm() / want.norm())
        worst = max(worst, gap if math.isfinite(gap) else math.inf)
    return worst


def window(spec: dict, mesh=None) -> dict:
    """Set-up and the measured window on this process's device; on a
    mesh, world rank 0 returns every rank's readings."""
    _plant(spec)
    device = mesh.device if mesh is not None else torch.device(spec["device"], 0)
    if device.type == "cuda":
        from style_transfer_visualizer_tpu_torch.native import build  # noqa: PLC0415

        torch.cuda.set_device(device)
        build.build_all()
    images = _Images(spec, device, mesh)
    counters = images.family.launch_counters() if spec["trace"] else {}
    images.run(generate.WARMUP_INDEX, spec["cell"]["traffic"]["warmup_steps"])
    state = None
    tracing = spec["trace"] and device.type == "cuda"
    activities = [torch.profiler.ProfilerActivity.CPU]
    if tracing:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
        # The profiler's first start pays for its own set-up.
        with torch.profiler.profile(activities=activities):
            _sync(device)
    _sync(device)
    setup_s = time.time() - spec["t_start"]
    records, summary, counted, closed_s = [], None, None, None
    start = time.perf_counter()
    while True:
        index = len(records)
        if spec["trace"] and index == 0:
            if tracing:
                for counter in counters.values():
                    counter.reset()
            with torch.profiler.profile(activities=activities) as prof:
                with torch.profiler.record_function(trace.SPAN):
                    state, record = images.run(index)
                    _sync(device)
            closed_s = time.perf_counter() - record["t_end"]
            counted = {
                name: counter.launched() if tracing else 0
                for name, counter in counters.items()
            }
        else:
            state, record = images.run(index)
        records.append(record)
        # A traced window also holds an untraced image, which the
        # entry's reader needs: the traced image and the closing of its
        # profiler can outlast ``seconds`` on their own.
        done = (
            time.perf_counter() - start >= spec["seconds"]
            and len(records) > int(spec["trace"])
        )
        if mesh is not None:
            flag = torch.tensor([int(done)], device=device)
            torch.distributed.broadcast(flag, src=0)
            done = bool(flag.item())
        if done:
            break
        del state
    window_s = time.perf_counter() - start
    if spec["trace"]:
        summary = trace.summarize(prof)
        del prof
    reading = {
        "rank": 0 if mesh is None else torch.distributed.get_rank(),
        "setup_s": setup_s,
        "window_s": window_s,
        "records": records,
        "peak": (
            torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0
        ),
        "summary": summary,
        "counted": counted,
        "forbidden": forbidden_modules(),
        "closed_s": closed_s,
    }
    del images
    reading["direction_gap"] = direction_gap(spec["cell"]["config"], state, mesh)
    del state
    if mesh is None:
        return {"ranks": [reading]}
    everyone = [None] * torch.distributed.get_world_size()
    torch.distributed.all_gather_object(everyone, reading)
    return {"ranks": everyone} if mesh.writes else None


class View:
    """What a metric's reader gets: the window's timings, each rank's
    peak of allocated device bytes and, in a traced run, each rank's
    trace summary and kernel counts."""

    def __init__(self, cell: dict, result: dict, chips: int) -> None:
        first = result["ranks"][0]
        self.config = cell["config"]
        self.traffic = cell["traffic"]
        self.chips = chips
        self.setup_s = first["setup_s"]
        self.window_s = first["window_s"]
        self.records = first["records"]
        self.peaks = [r["peak"] for r in result["ranks"]]
        self.traced_steps = self.traffic["steps"]
        self.ranks = [
            r for r in result["ranks"] if r["summary"] is not None
        ]

    @staticmethod
    def kernel_time(entry: dict, patterns) -> tuple[int, float]:
        """Launches and device seconds of the kernels whose names hold
        any of ``patterns`` (letter case ignored) in one rank's trace."""
        count, seconds = 0, 0.0
        for name, (n, s) in entry["summary"]["kernels"].items():
            low = name.lower()
            if any(p.lower() in low for p in patterns):
                count += n
                seconds += s
        return count, seconds


def _gap(program: float, reference: float) -> float:
    if not math.isfinite(program):
        return math.inf
    return abs(program - reference) / max(abs(reference), 1e-30)


def _step_gaps(got, want) -> dict[str, float]:
    """One image and style's numbers: the step-1 style and content
    scores, each later step's total loss, and the first step's
    decrease ``L1 - L2``."""
    if len(got) < len(want):
        return None
    gaps = {"s1_style": _gap(got[0][1], want[0][1]),
            "s1_content": _gap(got[0][2], want[0][2])}
    for k in range(1, len(want)):
        gaps[f"s{k + 1}_loss"] = _gap(got[k][0], want[k][0])
    gaps["d12"] = _gap(got[0][0] - got[1][0], want[0][0] - want[1][0])
    return gaps


def check(cell: dict, seed: int, records: list[dict], device) -> dict:
    """The widest gap of each number over every image and style of the
    window: the reference follows each one's first ``limits["steps"]``
    steps from the same seeds. ``failed`` counts the images and styles
    with a compared number past its limit."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config, mix, limits = cell["config"], cell["traffic"], cell["limits"]
    steps = limits["steps"]
    family = families.load(config)
    weights = family.make_weights(config, seed, device)
    height, width = mix["content"]
    n_styles = len(mix["styles"])
    shape = (1, height, width, 3)
    gaps: dict[str, float] = {}
    failed = 0
    for record in records:
        content, styles = generate.make_images(mix, seed, record["index"], device)
        _, start_seed = generate.image_seeds(seed, record["index"])
        gen = torch.Generator(device=device).manual_seed(start_seed)
        starts = torch.randn(
            shape if mix["entry"] == "single" else (n_styles, *shape),
            generator=gen, device=device,
        ).reshape(-1, *shape)
        for s, style in enumerate(styles):
            objective = family.objective(
                config, weights, torch.from_numpy(content).to(device),
                torch.from_numpy(style).to(device),
            )
            vag = ref_optim.value_and_grad(objective, shape)
            if config["optimizer"] == "lbfgs":
                want = ref_optim.lbfgs_losses(
                    vag, starts[s], steps, lr=config["lr"],
                    history_size=config["lbfgs_history_size"],
                    history_dtype=getattr(torch, config["lbfgs_history_dtype"]),
                )
            else:
                want = ref_optim.adam_losses(vag, starts[s], steps, lr=config["lr"])
            mine = _step_gaps(record["losses"][s], want)
            if mine is None:
                mine = dict.fromkeys(limits["limits"], math.inf)
            if any(mine.get(k, 0.0) > v for k, v in limits["limits"].items()):
                failed += 1
            for key, value in mine.items():
                gaps[key] = max(gaps.get(key, 0.0), value)
            del objective, vag
    return {"gaps": gaps, "failed": failed, "attempted": len(records) * n_styles}


def _own_port(root: Path) -> None:
    """Raise unless the port imported is the checkout's own."""
    try:
        import style_transfer_visualizer_tpu_torch as port  # noqa: PLC0415
    except ImportError:
        msg = "the checkout holds no style_transfer_visualizer_tpu_torch"
        raise RunError(msg) from None
    if not Path(port.__file__).resolve().is_relative_to(root.resolve()):
        msg = f"the port imported is {port.__file__}, not the checkout's"
        raise RunError(msg)


def _device_info(chips: int, peak: int) -> dict:
    return {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": chips,
        "memory_peak_bytes": peak,
    }


def _spec(args, cell: dict, out_dir: str, device: str) -> dict:
    return {
        "cell": cell,
        "seed": args.seed,
        "seconds": args.seconds,
        "trace": bool(args.trace),
        "device": device,
        "precision": (
            cell["config"]["control_precision"] if args.control
            else cell["config"]["precision"]
        ),
        "t_start": args.t_start,
        "out_dir": out_dir,
        "plant": args.plant,
    }


def _rehearsal_cell(cell: dict) -> dict:
    rehearsal = dict(cell)
    rehearsal["traffic"] = {
        **cell["traffic"], **cell["traffic"]["rehearsal"],
    }
    return rehearsal


def run(args) -> dict:
    """One run of ``args.workload``: the result's fields, ``checks``
    last. ``args.rehearse`` drives the cell's control flow on the CPU
    at the mix's rehearsal sizes and reports no device metric. The
    process is searched for forbidden modules once more after the
    check and the metric readers, the last of what the run loads."""
    out = _run(args)
    found = forbidden_modules()
    if found:
        msg = f"the run loaded {', '.join(found)} after its window"
        raise RunError(msg)
    return out


def _run(args) -> dict:
    cell = load_cell(args.workload, Path(args.root))
    _own_port(Path(args.root))
    if args.rehearse:
        cell = _rehearsal_cell(cell)
        device = "cpu"
    else:
        if not torch.cuda.is_available():
            msg = "no CUDA device: a measuring run needs the card"
            raise RunError(msg)
        if torch.cuda.device_count() < (1 if args.share_card else cell["chips"]):
            msg = (
                f"{torch.cuda.device_count()} CUDA devices; the cell asks "
                f"for {cell['chips']}"
            )
            raise RunError(msg)
        device = "cuda"
    mix = cell["traffic"]
    mesh = mix.get("mesh")
    out_dir = tempfile.mkdtemp(prefix="port_bench-")
    try:
        spec = _spec(args, cell, out_dir, device)
        if mesh and mesh.get("style", 1) * mesh["space"] > 1:
            from style_transfer_visualizer_tpu_torch.parallel.mesh import launch  # noqa: PLC0415

            result = launch(
                window, (spec,), mesh["space"], device,
                n_style=mesh.get("style", 1), share_card=args.share_card,
                timeout=MESH_TIMEOUT_S, deadline=MESH_DEADLINE_S,
            )
        else:
            result = window(spec)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    found = sorted({
        *forbidden_modules(), *(m for r in result["ranks"] for m in r["forbidden"]),
    })
    if found:
        msg = f"the run loaded {', '.join(found)}"
        raise RunError(msg)
    ranks = result["ranks"]
    if args.trace:
        first = ranks[0]["records"][0]
        print(
            f"traced image {first['t_end'] - first['t_entry']:.3f} s, "
            f"profiler closed in {ranks[0]['closed_s']:.3f} s, "
            f"window {ranks[0]['window_s']:.3f} s of "
            f"{len(ranks[0]['records'])} images",
            file=sys.stderr,
        )
    peak = max(r["peak"] for r in ranks)
    if device == "cuda":
        torch.cuda.empty_cache()
    checked = check(
        cell, args.seed, ranks[0]["records"], torch.device(device, 0)
        if device == "cuda" else torch.device("cpu"),
    )
    limits = cell["limits"]["limits"]
    view = View(cell, result, cell["chips"])
    readings = dict(checked["gaps"])
    if ranks[0]["direction_gap"] is not None:
        readings["dir"] = ranks[0]["direction_gap"]
    checks = {
        key: {"value": readings.get(key, math.inf), "limit": limit}
        for key, limit in limits.items()
    }
    correct = checked["failed"] == 0 and all(
        c["value"] <= c["limit"] for c in checks.values()
    )
    if args.rehearse:
        readers = [_reader(cell["root"], m["name"]) for m in cell["per_layer"]]
        return {
            "rehearsal": True,
            "correct": correct,
            "attempted": checked["attempted"],
            "failed": checked["failed"],
            "images": len(view.records),
            "steps": sum(r["steps"] for r in view.records),
            "readings": readings,
            "readers_run": len(readers),
            "readers_answered": sum(
                read(view) is not None for read in readers
            ) if view.ranks else 0,
            "checks": checks,
        }
    metrics_of = cell["per_layer"] if args.trace else cell["end_to_end"]
    metrics = {}
    for metric in metrics_of:
        value = _reader(cell["root"], metric["name"])(view)
        if value is None:
            print(f"{metric['name']}: nothing to read", file=sys.stderr)
            continue
        metrics[metric["name"]] = {"value": value, "unit": metric["unit"]}
    out = {
        "correct": correct,
        "attempted": checked["attempted"],
        "failed": checked["failed"],
        "metrics": metrics,
        "device": _device_info(cell["chips"], peak),
    }
    if args.trace:
        out["device"]["busy_s"] = sum(
            r["summary"]["busy_s"] for r in view.ranks
        ) / len(view.ranks)
        out["device"]["window_s"] = max(
            r["summary"]["span_s"] for r in view.ranks
        )
        out["breakdown"] = _breakdown(view.ranks)
    out["readings"] = readings
    out["checks"] = checks
    return out


def _breakdown(ranks: list[dict]) -> dict:
    ops: dict[str, float] = {}
    for entry in ranks:
        for name, (_, seconds) in entry["summary"]["kernels"].items():
            ops[name[:120]] = ops.get(name[:120], 0.0) + seconds / len(ranks)
    gaps = sorted(
        ([name[:120], s] for entry in ranks for name, s in entry["summary"]["gaps"]),
        key=lambda g: -g[1],
    )
    return {
        "device_ops": sorted(
            ([n, s] for n, s in ops.items()), key=lambda o: -o[1],
        )[:10],
        "idle_gaps": gaps[:10],
    }
