"""Rank-side batteries of the port's batch-over-cards tests (CPU, gloo).

Each battery runs on every rank of one ``parallel.mesh.launch`` with a
style axis and returns, from world rank 0, numpy results that
``tests/test_torch_batch_mesh.py`` compares with the JAX package and
with the port's single-process batch. Only ``torch``, ``numpy`` and the
port are imported here: the ranks are spawned processes, and JAX never
runs in them.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from style_transfer_visualizer_tpu_torch import main
from style_transfer_visualizer_tpu_torch.engine.step import EagerChunk
from style_transfer_visualizer_tpu_torch.models import vgg19
from style_transfer_visualizer_tpu_torch.models.features import Targets
from style_transfer_visualizer_tpu_torch.ops import conv3x3
from style_transfer_visualizer_tpu_torch.parallel import spatial
from style_transfer_visualizer_tpu_torch.parallel.mesh import Mesh


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _whole(mesh: Mesh, block: torch.Tensor, row_dim: int = 2) -> np.ndarray:
    """The whole batch from every rank's styles and rows."""
    return _np(mesh.gather_styles(mesh.gather(block.contiguous(), row_dim)))


def _targets(mesh: Mesh, case: dict) -> Targets:
    """This rank's block of a case's whole targets: its styles' Grams,
    the rows of its styles' content features."""
    return Targets(
        style_grams={
            int(k): mesh.style_block(torch.from_numpy(v))
            for k, v in case["grams"].items()
        },
        content_feats={
            int(k): mesh.shard(mesh.style_block(torch.from_numpy(v)), 2)
            for k, v in case["feats"].items()
        },
    )


def _rows(mesh: Mesh, images: np.ndarray) -> torch.Tensor:
    return mesh.shard(mesh.style_block(torch.from_numpy(images)), 2)


def _step0(mesh: Mesh, params, case: dict) -> dict:
    """Each style's loss, scores and whole gradient at the case's
    images, through the per-image sharded loss; and the first step's
    metrics from the dp x sp bundle."""
    shape = case["shape"]
    settings = case["kwargs"]
    loss_fn = spatial.make_spatial_loss(
        mesh, shape, per_image=True, style_layers=case["style_layers"],
        content_layers=case["content_layers"],
        **{k: v for k, v in settings.items() if k not in ("optimizer", "lr")},
    )
    targets = _targets(mesh, case)
    x = _rows(mesh, case["images"]).requires_grad_(True)
    # One image per style: the sweep's (S_local, h, W, 3) batch.
    total, (style, content) = loss_fn(params, x.flatten(0, 1), targets)
    (grad,) = torch.autograd.grad(total.sum(), x)
    bundle = spatial.build_dp_sp_update(
        mesh, params, targets, shape, case["images"].shape[0],
        style_layers=case["style_layers"],
        content_layers=case["content_layers"], **settings,
    )
    _, _, aux = bundle.update_fn(x.detach(), bundle.opt_state)
    return {
        "loss": _np(mesh.gather_styles(total)),
        "style": _np(mesh.gather_styles(style)),
        "content": _np(mesh.gather_styles(content)),
        "grad": _whole(mesh, grad),
        "aux_loss": _np(mesh.gather_styles(aux.loss)),
    }


def _trajectory(mesh: Mesh, params, case: dict) -> dict:
    """``steps`` steps of the dp x sp step: each step's whole images
    and per-style losses; for Adam also the same steps as one chunk."""
    n_styles = case["images"].shape[0]

    def bundle():
        return spatial.build_dp_sp_update(
            mesh, params, _targets(mesh, case), case["shape"], n_styles,
            style_layers=case["style_layers"],
            content_layers=case["content_layers"], **case["kwargs"],
        )

    built = bundle()
    images, state = _rows(mesh, case["images"]), built.opt_state
    out = {"images": [], "loss": [], "eager": isinstance(
        built.chunked_update_fn, EagerChunk,
    )}
    for _ in range(case["steps"]):
        images, state, aux = built.update_fn(images, state)
        out["images"].append(_whole(mesh, images))
        out["loss"].append(_np(mesh.gather_styles(aux.loss)))
    if case["kwargs"]["optimizer"] == "adam":
        chunk = bundle()
        got, _, auxes = chunk.chunked_update_fn(
            _rows(mesh, case["images"]), chunk.opt_state, case["steps"],
        )
        out["chunked"] = _whole(mesh, got)
        out["chunked_loss"] = _np(mesh.gather_styles(auxes.loss, dim=1))
    return out


def _layout(mesh: Mesh) -> np.ndarray:
    """Every rank's ``(style_index, index)``, by style row and index,
    and whether it writes."""
    mine = torch.tensor(
        [[[mesh.style_index, mesh.index, int(mesh.writes)]]],
        dtype=torch.int64,
    )
    return _np(mesh.gather_styles(mesh.gather(mine, 1)))


def step_battery(cases: dict, *, mesh: Mesh) -> dict:
    """Every step case of the batch-mesh tests on this rank."""
    params = vgg19.init_random_params(0, "cpu")
    out = {
        "layout": _layout(mesh),
        "axes": (mesh.style_size, mesh.size),
        "step0": _step0(mesh, params, cases["step0"]),
    }
    for name, case in cases["trajectories"].items():
        out[name] = _trajectory(mesh, params, case)
    return out


def _state(mesh: Mesh, state) -> dict:
    whole = spatial.gather_state(mesh, state)
    return {
        name: _np(getattr(whole, name).float())
        for name in whole.__dataclass_fields__
    }


def per_image(plain):
    """``ops.conv3x3.conv3x3_plain`` run image by image.

    The card's conv kernel is batch-invariant (its plan splits per
    image); the CPU's ``F.conv2d`` need not be, so a test that holds a
    block of styles to the whole batch runs the plain conv so, on both
    sides (as ``tests/test_torch_multistyle.py``'s batch-invariance
    test does).
    """

    def conv(x, w9, b, apply_relu, mask=None):
        return torch.cat([
            plain(x[i:i + 1], w9, b, apply_relu,
                  None if mask is None else mask[i:i + 1])
            for i in range(x.shape[0])
        ])

    return conv


def prepare_battery(jobs: dict, *, mesh: Mesh) -> dict:
    """``main.prepare_multi_style`` with this rank's mesh, then
    ``steps`` dispatches of its bundle: each job's whole images, state
    and start, and whether the step replays graphs. The plain conv
    runs image by image (:func:`per_image`)."""
    conv3x3.conv3x3_plain = per_image(conv3x3.conv3x3_plain)
    out = {}
    for name, (content, styles, config, steps) in jobs.items():
        bundle, images = main.prepare_multi_style(
            content, styles, config, mesh=mesh,
        )
        start = _whole(mesh, images)
        images, state, _ = bundle.chunked_update_fn(
            images, bundle.opt_state, steps,
        )
        out[name] = {
            "start": start, "images": _whole(mesh, images),
            "state": _state(mesh, state),
            "eager": isinstance(bundle.chunked_update_fn, EagerChunk),
        }
    return out


def run_battery(jobs: dict, *, mesh: Mesh) -> dict:
    """Each job through ``main.multi_style_transfer`` with this rank's
    mesh; world rank 0 returns the paths it saved."""
    out = {}
    for name, (content, styles, config) in jobs.items():
        saved = main.multi_style_transfer(content, styles, config, mesh=mesh)
        out[name] = [str(Path(p)) for p in saved]
    return out
