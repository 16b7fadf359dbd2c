"""Rank-side batteries of the port's row-sharded tests (CPU, gloo).

Each battery runs on every rank of one ``parallel.mesh.launch`` and
returns, from rank 0, numpy results that the test module compares with
the JAX package and with the port's whole-image functions. Only
``torch``, ``numpy`` and the port are imported here: the ranks are
spawned processes, and JAX never runs in them.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from style_transfer_visualizer_tpu_torch import blend_sweep, main, sequence
from style_transfer_visualizer_tpu_torch.engine.optimizers import (
    lbfgs_init,
    lbfgs_step,
)
from style_transfer_visualizer_tpu_torch.models import vgg19
from style_transfer_visualizer_tpu_torch.models.features import Targets
from style_transfer_visualizer_tpu_torch.parallel import spatial
from style_transfer_visualizer_tpu_torch.parallel.mesh import Mesh


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _per_rank(mesh: Mesh, value: torch.Tensor) -> np.ndarray:
    """Every rank's scalar, in rank order (to check it is replicated)."""
    return _np(mesh.gather(value.detach().reshape(1, 1).float(), dim=1))[0]


def _targets(mesh: Mesh, case: dict) -> Targets:
    feats = {
        int(k): mesh.shard(torch.from_numpy(v))
        for k, v in case["feats"].items()
    }
    return Targets(
        style_grams={
            int(k): torch.from_numpy(v) for k, v in case["grams"].items()
        },
        content_feats=feats,
    )


def _loss_case(mesh: Mesh, params, case: dict) -> dict:
    """The sharded loss and the whole gradient at ``case["x"]``."""
    loss_fn = spatial.make_spatial_loss(
        mesh, case["x"].shape, **case["settings"],
    )
    x = mesh.shard(torch.from_numpy(case["x"])).requires_grad_(True)
    total, (style, content) = loss_fn(params, x, _targets(mesh, case))
    (grad,) = torch.autograd.grad(total, x)
    return {
        "loss": _per_rank(mesh, total),
        "style": _np(style), "content": _np(content),
        "grad": _np(mesh.gather(grad)),
    }


def _targets_case(mesh: Mesh, params, case: dict) -> dict:
    got = spatial.compute_sharded_targets(
        mesh, params, mesh.shard(torch.from_numpy(case["style"])),
        mesh.shard(torch.from_numpy(case["content"])),
        case["style_layers"], case["content_layers"],
    )
    out = {f"gram{k}": _np(v) for k, v in got.style_grams.items()}
    out.update({
        f"feat{k}": _np(mesh.gather(v)) for k, v in got.content_feats.items()
    })
    return out


def _halos(mesh: Mesh, x: np.ndarray) -> np.ndarray:
    """Every rank's halo'd rows, stacked in rank order."""
    return _np(mesh.gather(
        spatial.exchange_halos(mesh.shard(torch.from_numpy(x)), mesh),
    ))


class _Rows(torch.autograd.Function):
    """A replicated tensor's rows for this rank; its gradient, the sum
    over the ranks of each rank's rows' gradient (so a replicated
    input's gradient is the whole one on every rank)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.shard(x)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        return mesh.gather(g.contiguous()), None


def _gradcheck(mesh: Mesh) -> bool:
    """``gradcheck`` of a weighted sum of the halo'd rows, float64."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((1, 4 * mesh.size, 3, 2), generator=gen,
                    dtype=torch.float64, requires_grad=True)
    weights = torch.randn((1, 6 * mesh.size, 3, 2), generator=gen,
                          dtype=torch.float64)
    w_rank = weights[:, 6 * mesh.index:6 * (mesh.index + 1)]

    def toy(whole):
        halo = spatial.exchange_halos(_Rows.apply(whole, mesh), mesh)
        return spatial.psum(torch.sum(halo * w_rank), mesh)

    return bool(torch.autograd.gradcheck(
        toy, (x,), eps=1e-6, atol=1e-8, raise_exception=False,
    ))


def _lbfgs_case(mesh: Mesh, case: dict) -> dict:
    """Three L-BFGS steps of a separable quadratic over the ranks."""
    a = mesh.shard(torch.from_numpy(case["a"]), dim=0)
    b = mesh.shard(torch.from_numpy(case["b"]), dim=0)
    x = mesh.shard(torch.from_numpy(case["x0"]), dim=0)

    def vag(v):
        loss = spatial.psum(torch.sum(a * v * v + b * v), mesh)
        return (loss, (loss, loss)), 2 * a * v + b

    out = {}
    for method in ("compact", "two-loop"):
        state = lbfgs_init(x.shape[0], 4, "cpu")
        v = x.clone()
        for _ in range(3):
            v, state, _ = lbfgs_step(
                vag, v, state, 1.0, max_iter=2, max_eval=3,
                direction_method=method, mesh=mesh,
            )
        out[method] = _np(mesh.gather(v[None], dim=1)[0])
    return out


def _span_names(mesh: Mesh, params, case: dict) -> list[str]:
    """The ``stv.`` spans of one sharded loss and gradient, profiled
    on the host."""
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU],
    ) as prof:
        _loss_case(mesh, params, case)
    return sorted({
        e.name() for e in prof.profiler.kineto_results.events()
        if e.name().startswith("stv.")
    })


def function_battery(cases: dict, *, mesh: Mesh) -> dict:
    """Every function case of the spatial tests on this rank."""
    params = vgg19.params_from_numpy(cases["weights"], "cpu")
    out = {"size": mesh.size}
    for name, case in cases["loss"].items():
        out[f"loss/{name}"] = _loss_case(mesh, params, case)
    out["spans"] = _span_names(
        mesh, params, next(iter(cases["loss"].values())),
    )
    for name, case in cases["targets"].items():
        out[f"targets/{name}"] = _targets_case(mesh, params, case)
    out["halos"] = _halos(mesh, cases["halo_x"])
    out["gradcheck"] = _gradcheck(mesh)
    out["lbfgs"] = _lbfgs_case(mesh, cases["lbfgs"])
    return out


def _read_csv(path: Path) -> np.ndarray:
    rows = path.read_text().splitlines()[1:]
    return np.array([[float(v) for v in r.split(",")] for r in rows])


def run_battery(jobs: dict, *, mesh: Mesh) -> dict:
    """The sharded runs of the run tests, each through its entry point
    called with this rank's mesh; rank 0 reads back what it wrote."""
    out = {}
    for name, (kind, args, kwargs) in jobs.items():
        if kind == "single":
            paths, config = args
            image = main.style_transfer(paths, config, mesh=mesh, **kwargs)
            out[name] = {"image": _np(image)}
            if config.output.log_loss and mesh.writes:
                out[name]["curve"] = _read_csv(Path(config.output.log_loss))
        elif kind == "sweep":
            result = blend_sweep.stylize_blend_sweep(
                *args, mesh=mesh, **kwargs,
            )
            out[name] = {"losses": np.array(result.frame_losses)}
        else:
            result = sequence.stylize_sequence(*args, mesh=mesh, **kwargs)
            out[name] = {"losses": np.array(result.frame_losses)}
    return out

