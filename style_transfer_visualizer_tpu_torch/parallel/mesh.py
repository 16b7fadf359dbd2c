"""Process meshes for row-sharded evaluation, on ``torch.distributed``.

The port of the JAX package's ``parallel/mesh.py``. A JAX mesh lays
devices out on two named axes, ``style`` and ``space``
(``constants.MESH_AXIS_STYLE``, ``MESH_AXIS_SPACE``); here each device
is a process of its own, and a :class:`Mesh` is what one process knows
of the layout: the space axis's process group, its index on that axis
(the JAX ``axis_index``) and the axis's size (``axis_size``). The style
axis stays at 1: several styles over several cards is ROADMAP.md's
queue item "Batch over cards and dp×sp", and :func:`create_mesh` refuses
it by that name.

:func:`launch` is the one-command launcher: it starts one process per
shard (``torch.multiprocessing`` with ``spawn``), meets them at a
``file://`` rendezvous in a temporary directory (no network), runs the
given entry point on every rank with the rank's mesh, and returns rank
0's result. A failure on any rank stops the others and raises with that
rank's traceback; every collective has a finite timeout, so a rank left
waiting raises instead of hanging. The backend is chosen by the device
and never changed behind the caller's back: gloo for CPU ranks (the
tests, like the JAX package's virtual CPU devices), NCCL with rank r on
``cuda:r``. ``share_card=True`` puts every rank on ``cuda:0`` with gloo
between them, through the host: a check of the sharded path on a
machine with one card, named as such in the log, never a way to run
faster.

Every collective here is an ``all_reduce``, the one both backends take
on CUDA tensors. Moving data (a broadcast, a gather, the halo exchange
of ``parallel/spatial.py``) sums the tensor's bytes as ``uint8`` over a
buffer that only one rank fills at each position, so every value
arrives bit for bit, the sign of a zero included.
"""
from __future__ import annotations

import logging
import os
import shutil
import tempfile
import time
from dataclasses import dataclass
from datetime import timedelta
from pathlib import Path
from typing import TYPE_CHECKING

import torch
import torch.distributed as dist

from style_transfer_visualizer_tpu_torch.constants import (
    SPATIAL_TIMEOUT_SECONDS,
)
from style_transfer_visualizer_tpu_torch.native import build
from style_transfer_visualizer_tpu_torch.utils.logging import logger

if TYPE_CHECKING:
    from collections.abc import Callable

#: What several styles over several cards waits for.
BATCH_ITEM = "ROADMAP.md queue item 'Batch over cards and dp×sp'"


@dataclass(frozen=True)
class Mesh:
    """One process's place on a 1 x ``size`` (style x space) mesh.

    ``group`` is the space axis's process group, None on a single
    device; ``index`` this rank's index on the axis; ``device`` where
    its tensors live. Rank ``index`` holds rows ``rows(h)`` of every
    row-sharded tensor of global height ``h``.
    """

    group: object | None
    index: int
    size: int
    device: torch.device

    @property
    def is_root(self) -> bool:
        """Whether this rank writes the run's files (rank 0)."""
        return self.index == 0

    def rows(self, height: int) -> tuple[int, int]:
        """``(lo, hi)``: this rank's rows of ``height`` global rows."""
        block = height // self.size
        return self.index * block, (self.index + 1) * block

    def shard(self, whole: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """This rank's rows of a whole tensor, contiguous, on its
        device (the JAX ``device_put`` to the row sharding)."""
        lo, hi = self.rows(whole.shape[dim])
        return whole.narrow(dim, lo, hi - lo).contiguous().to(self.device)

    def _reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        if self.group is not None:
            dist.all_reduce(t, op=op, group=self.group)
        return t

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the ranks, in place (the JAX ``psum``)."""
        return self._reduce(t, dist.ReduceOp.SUM)

    def all_max(self, t: torch.Tensor) -> torch.Tensor:
        """``t``'s elementwise maximum over the ranks, in place
        (``pmax``)."""
        return self._reduce(t, dist.ReduceOp.MAX)

    def sum_bytes(self, t: torch.Tensor) -> torch.Tensor:
        """``t``'s bytes summed over the ranks as ``uint8``, in place.

        Where one rank holds a value and the others zeros, every rank
        ends with that value's exact bits. ``t`` must be contiguous.
        """
        if self.group is not None:
            dist.all_reduce(
                t.reshape(-1).view(torch.uint8), group=self.group,
            )
        return t

    def broadcast(self, t: torch.Tensor | None, like: torch.Tensor):
        """Rank 0's ``t`` on every rank, bit for bit.

        The other ranks pass None (or anything) for ``t``; ``like``
        gives the shape and dtype every rank agrees on.
        """
        buf = (
            t.detach().contiguous().clone() if self.is_root
            else torch.zeros_like(like)
        )
        return self.sum_bytes(buf)

    def gather(self, block: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """The whole tensor on every rank from each rank's equal block
        along ``dim``, bit for bit."""
        if self.size == 1:
            return block
        shape = list(block.shape)
        k = shape[dim]
        shape[dim] = k * self.size
        whole = torch.zeros(shape, dtype=block.dtype, device=block.device)
        whole.narrow(dim, self.index * k, k).copy_(block)
        return self.sum_bytes(whole)

    def any(self, *flags: bool) -> tuple[bool, ...]:
        """Each flag true on any rank: one decision for every rank."""
        t = torch.tensor(
            [float(f) for f in flags], dtype=torch.float32,
            device=self.device,
        )
        self.all_max(t)
        return tuple(bool(v) for v in t.tolist())


def single_device_mesh(device: torch.device | str = "cpu") -> Mesh:
    """The degenerate 1 x 1 mesh: no group, no collectives."""
    return Mesh(group=None, index=0, size=1, device=torch.device(device))


def create_mesh(
    n_style: int = 1,
    n_space: int | None = None,
    *,
    device: torch.device | str | None = None,
) -> Mesh:
    """This process's mesh over the initialized default process group.

    ``n_space`` (default: every rank) must be the group's size; a
    style axis past 1 raises ``NotImplementedError`` naming the queue
    item it waits for. ``device`` defaults to the current CUDA device,
    or the CPU without one.
    """
    if n_style != 1:
        msg = (
            f"a style axis of {n_style} over several cards is not "
            f"ported; it waits for {BATCH_ITEM}"
        )
        raise NotImplementedError(msg)
    total = dist.get_world_size()
    n_space = total if n_space is None else n_space
    if n_style * n_space != total:
        msg = (
            f"Mesh {n_style}x{n_space} needs {n_style * n_space} devices, "
            f"have {total}"
        )
        raise ValueError(msg)
    if device is None:
        device = (
            torch.device("cuda", torch.cuda.current_device())
            if torch.cuda.is_available() else torch.device("cpu")
        )
    return Mesh(
        group=dist.group.WORLD, index=dist.get_rank(), size=n_space,
        device=torch.device(device),
    )


def require_devices(n_space: int, device: str) -> None:
    """Raise the JAX package's ``ValueError`` when ``device`` is CUDA
    and fewer than ``n_space`` cards are attached (one card a rank)."""
    if torch.device(device).type != "cuda":
        return
    count = torch.cuda.device_count()
    if count < n_space:
        msg = (
            f"--spatial-shards {n_space} needs {n_space} cuda devices; "
            f"{count} attached."
        )
        raise ValueError(msg)


def _rank_main(
    index: int,
    fn: Callable,
    args: tuple,
    kwargs: dict,
    n_space: int,
    spec: tuple[str, str, bool, float],
    result_path: str,
) -> None:
    """One rank: join the group, run ``fn(*args, mesh=..., **kwargs)``,
    and on rank 0 keep its result for the launcher."""
    init_file, device_type, share_card, timeout = spec
    if device_type == "cuda":
        device = torch.device("cuda", 0 if share_card else index)
        torch.cuda.set_device(device)
        backend = "gloo" if share_card else "nccl"
    else:
        device = torch.device("cpu")
        backend = "gloo"
        # The ranks share the host's cores.
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n_space))
    if index:
        logger.setLevel(logging.WARNING)
    dist.init_process_group(
        backend, init_method=f"file://{init_file}", world_size=n_space,
        rank=index, timeout=timedelta(seconds=timeout),
    )
    try:
        mesh = create_mesh(1, n_space, device=device)
        out = fn(*args, mesh=mesh, **kwargs)
        if mesh.is_root:
            torch.save(out, result_path)
    finally:
        dist.destroy_process_group()


def launch(
    fn: Callable,
    args: tuple,
    n_space: int,
    device: str,
    *,
    kwargs: dict | None = None,
    share_card: bool = False,
    timeout: float = SPATIAL_TIMEOUT_SECONDS,
    deadline: float | None = None,
):
    """Run ``fn(*args, mesh=mesh, **kwargs)`` on ``n_space`` ranks;
    return rank 0's result.

    ``device`` ``"cpu"`` runs gloo ranks on the CPU; ``"cuda"`` (any
    index) runs NCCL ranks, rank r on ``cuda:r``, and raises
    (:func:`require_devices`) with fewer cards. ``share_card`` puts
    every rank on ``cuda:0`` with gloo between them (the one-card
    check). The kernels are built here, once, before the ranks start.
    ``timeout`` bounds the rendezvous and every collective;
    ``deadline``, when given, the whole run in seconds: past it every
    rank is killed and ``TimeoutError`` raised. ``fn``, ``args`` and
    ``kwargs`` must pickle (``spawn``); so must the result.
    """
    device_type = torch.device(device).type
    if device_type == "cuda":
        if share_card:
            require_devices(1, device)
            logger.warning(
                "%d ranks share cuda:0 over gloo through the host: a "
                "check of the sharded path on one card, not a "
                "multi-card run.", n_space,
            )
        else:
            require_devices(n_space, device)
        build.build_all()
    logger.info(
        "Spatial sharding: image rows over %d %s ranks.",
        n_space, device_type,
    )
    tmp = Path(tempfile.mkdtemp(prefix="stv-mesh-"))
    try:
        spec = (str(tmp / "rendezvous"), device_type, share_card, timeout)
        result_path = str(tmp / "result.pt")
        ctx = torch.multiprocessing.start_processes(
            _rank_main,
            args=(fn, args, kwargs or {}, n_space, spec, result_path),
            nprocs=n_space, join=False, start_method="spawn",
        )
        end = None if deadline is None else time.monotonic() + deadline
        while not ctx.join(timeout=5.0):
            if end is not None and time.monotonic() > end:
                for proc in ctx.processes:
                    proc.kill()
                    proc.join()
                msg = (
                    f"{n_space} ranks did not finish within {deadline} s; "
                    "every rank was killed"
                )
                raise TimeoutError(msg)
        return torch.load(result_path, weights_only=False)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
