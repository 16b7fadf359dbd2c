"""Process meshes for row-sharded evaluation and the style batch, on
``torch.distributed``.

The port of the JAX package's ``parallel/mesh.py``. A JAX mesh lays
devices out on two named axes, ``style`` and ``space``
(``constants.MESH_AXIS_STYLE``, ``MESH_AXIS_SPACE``), as the grid
``devices.reshape(n_style, n_space)``; here each device is a process of
its own, world rank ``r = style_index * n_space + index``, and a
:class:`Mesh` is what one process knows of the layout: its style row's
space group (the JAX ``axis_name`` of the space axis), its index on
that axis (``axis_index``) and the axis's size (``axis_size``), its
row on the style axis and that axis's size, and the world group that
gathers to the writer. Every row has a space group of its own
(``dist.new_group``, which every rank makes for every row, in the same
order); a row of one rank has none, so its step holds no collective.

Two roots, never confused: the space root (``index`` 0,
:attr:`Mesh.is_root`) broadcasts within its row (:meth:`Mesh.broadcast`);
world rank 0 (:attr:`Mesh.writes`) alone writes the run's files, CSVs,
frames and checkpoints. With one style row they are the same rank.

:func:`launch` is the one-command launcher: it starts one process per
rank (``torch.multiprocessing`` with ``spawn``), meets them at a
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
from style_transfer_visualizer_tpu_torch.runtime.device import setup_device
from style_transfer_visualizer_tpu_torch.utils.logging import logger
from style_transfer_visualizer_tpu_torch.utils.trace import span

if TYPE_CHECKING:
    from collections.abc import Callable


def _sum_bytes(t: torch.Tensor, group) -> torch.Tensor:
    """``t``'s bytes summed over ``group``'s ranks as ``uint8``, in
    place; ``t`` must be contiguous."""
    dist.all_reduce(t.reshape(-1).view(torch.uint8), group=group)
    return t


@dataclass(frozen=True)
class Mesh:
    """One process's place on an ``n_style`` x ``size`` (style x space)
    mesh.

    ``group`` is its style row's space group, None on a row of one
    rank; ``index`` this rank's index on the space axis; ``device``
    where its tensors live. Rank ``index`` holds rows ``rows(h)`` of
    every row-sharded tensor of global height ``h``. ``style_index``
    is its row on the style axis of ``style_size`` rows: it holds
    styles ``styles(S)`` of an S-style batch. ``world`` is the group of
    every rank (None when the mesh is one process without a group).
    """

    group: object | None
    index: int
    size: int
    device: torch.device
    style_index: int = 0
    style_size: int = 1
    world: object | None = None

    @property
    def is_root(self) -> bool:
        """Whether this rank is its row's space root (index 0), the
        rank :meth:`broadcast` sends from."""
        return self.index == 0

    @property
    def writes(self) -> bool:
        """Whether this rank writes the run's files: world rank 0."""
        return self.index == 0 and self.style_index == 0

    def rows(self, height: int) -> tuple[int, int]:
        """``(lo, hi)``: this rank's rows of ``height`` global rows."""
        block = height // self.size
        return self.index * block, (self.index + 1) * block

    def styles(self, n_styles: int) -> tuple[int, int]:
        """``(lo, hi)``: this rank's styles of an ``n_styles`` batch."""
        block = n_styles // self.style_size
        return self.style_index * block, (self.style_index + 1) * block

    def shard(self, whole: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """This rank's rows of a whole tensor, contiguous, on its
        device (the JAX ``device_put`` to the row sharding)."""
        lo, hi = self.rows(whole.shape[dim])
        return whole.narrow(dim, lo, hi - lo).contiguous().to(self.device)

    def style_block(self, whole: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's styles of a whole batch along ``dim``,
        contiguous, on its device."""
        lo, hi = self.styles(whole.shape[dim])
        return whole.narrow(dim, lo, hi - lo).contiguous().to(self.device)

    def _reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        if self.group is not None:
            dist.all_reduce(t, op=op, group=self.group)
        return t

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the row's ranks, in place (the JAX
        ``psum`` over the space axis)."""
        return self._reduce(t, dist.ReduceOp.SUM)

    def all_max(self, t: torch.Tensor) -> torch.Tensor:
        """``t``'s elementwise maximum over the row's ranks, in place
        (``pmax``)."""
        return self._reduce(t, dist.ReduceOp.MAX)

    def sum_bytes(self, t: torch.Tensor) -> torch.Tensor:
        """``t``'s bytes summed over the row's ranks as ``uint8``, in
        place.

        Where one rank holds a value and the others zeros, every rank
        ends with that value's exact bits. ``t`` must be contiguous.
        """
        if self.group is not None:
            _sum_bytes(t, self.group)
        return t

    def broadcast(self, t: torch.Tensor | None, like: torch.Tensor):
        """The space root's ``t`` on every rank of its row, bit for bit.

        The other ranks pass None (or anything) for ``t``; ``like``
        gives the shape and dtype every rank agrees on.
        """
        buf = (
            t.detach().contiguous().clone() if self.is_root
            else torch.zeros_like(like)
        )
        return self.sum_bytes(buf)

    def gather(self, block: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """The whole tensor on every rank of the row from each rank's
        equal block of rows along ``dim``, bit for bit."""
        if self.size == 1:
            return block
        with span("stv.parallel.gather"):
            shape = list(block.shape)
            k = shape[dim]
            shape[dim] = k * self.size
            whole = torch.zeros(
                shape, dtype=block.dtype, device=block.device,
            )
            whole.narrow(dim, self.index * k, k).copy_(block)
            return self.sum_bytes(whole)

    def gather_styles(
        self, block: torch.Tensor, dim: int = 0,
    ) -> torch.Tensor:
        """The whole batch on every rank from each style row's equal
        block along ``dim``, bit for bit: :meth:`gather` over the style
        axis. ``block`` must be the same on every rank of a row (a
        replicated value, or rows already gathered); each row's space
        root fills its slot."""
        if self.style_size == 1:
            return block
        with span("stv.parallel.gather"):
            shape = list(block.shape)
            k = shape[dim]
            shape[dim] = k * self.style_size
            whole = torch.zeros(
                shape, dtype=block.dtype, device=block.device,
            )
            if self.is_root:
                whole.narrow(dim, self.style_index * k, k).copy_(block)
            return _sum_bytes(whole, self.world)

    def any(self, *flags: bool) -> tuple[bool, ...]:
        """Each flag true on any rank of the row: one decision for
        every rank of a row-sharded run."""
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
    device: torch.device | str = "cuda",
    timeout: float = SPATIAL_TIMEOUT_SECONDS,
) -> Mesh:
    """This process's mesh over the initialized default process group.

    ``n_style * n_space`` (``n_space`` by default every rank over the
    style rows) must be the group's size. World rank r sits at style
    row ``r // n_space``, index ``r % n_space`` (the JAX grid
    ``devices.reshape(n_style, n_space)``). With one style row the
    space group is the world's, as a single sharded run has it; with
    several, every rank makes every row's group, in row order, and a
    row of one rank has none. ``device`` is CUDA unless the CPU is
    asked for by name, and raises without a card
    (``runtime.device.setup_device``); ``timeout`` bounds the rows'
    collectives.
    """
    device = setup_device(str(device))
    total = dist.get_world_size()
    n_space = total // n_style if n_space is None else n_space
    if n_style * n_space != total:
        msg = (
            f"Mesh {n_style}x{n_space} needs {n_style * n_space} devices, "
            f"have {total}"
        )
        raise ValueError(msg)
    style_index, index = divmod(dist.get_rank(), n_space)
    world = dist.group.WORLD
    if n_style == 1:
        group = world
    else:
        group = None
        if n_space > 1:
            for row in range(n_style):
                made = dist.new_group(
                    ranks=list(range(row * n_space, (row + 1) * n_space)),
                    timeout=timedelta(seconds=timeout),
                )
                if row == style_index:
                    group = made
    return Mesh(
        group=group, index=index, size=n_space, device=device,
        style_index=style_index, style_size=n_style, world=world,
    )


def require_devices(n_space: int, device: str, n_style: int = 1) -> None:
    """Raise the JAX package's ``ValueError`` when ``device`` is CUDA
    and fewer than ``n_style * n_space`` cards are attached (one card a
    rank)."""
    if torch.device(device).type != "cuda":
        return
    count = torch.cuda.device_count()
    need = n_style * n_space
    if count < need:
        what = (
            f"--spatial-shards {n_space}" if n_style == 1
            else f"A {n_style} (style) x {n_space} (space) mesh"
        )
        msg = f"{what} needs {need} cuda devices; {count} attached."
        raise ValueError(msg)


def _rank_main(
    rank: int,
    fn: Callable,
    args: tuple,
    kwargs: dict,
    axes: tuple[int, int],
    spec: tuple[str, str, bool, float],
    result_path: str,
) -> None:
    """One rank: join the group, run ``fn(*args, mesh=..., **kwargs)``,
    and on world rank 0 keep its result for the launcher."""
    n_style, n_space = axes
    world = n_style * n_space
    init_file, device_type, share_card, timeout = spec
    if device_type == "cuda":
        device = torch.device("cuda", 0 if share_card else rank)
        torch.cuda.set_device(device)
        backend = "gloo" if share_card else "nccl"
    else:
        device = torch.device("cpu")
        backend = "gloo"
        # The ranks share the host's cores.
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    if rank:
        logger.setLevel(logging.WARNING)
    dist.init_process_group(
        backend, init_method=f"file://{init_file}", world_size=world,
        rank=rank, timeout=timedelta(seconds=timeout),
    )
    try:
        mesh = create_mesh(n_style, n_space, device=device, timeout=timeout)
        out = fn(*args, mesh=mesh, **kwargs)
        if mesh.writes:
            torch.save(out, result_path)
    finally:
        dist.destroy_process_group()


def launch(
    fn: Callable,
    args: tuple,
    n_space: int,
    device: str,
    *,
    n_style: int = 1,
    kwargs: dict | None = None,
    share_card: bool = False,
    timeout: float = SPATIAL_TIMEOUT_SECONDS,
    deadline: float | None = None,
):
    """Run ``fn(*args, mesh=mesh, **kwargs)`` on ``n_style * n_space``
    ranks (an ``n_style`` x ``n_space`` mesh); return world rank 0's
    result.

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
    world = n_style * n_space
    device_type = torch.device(device).type
    if device_type == "cuda":
        if share_card:
            require_devices(1, device)
            logger.warning(
                "%d ranks share cuda:0 over gloo through the host: a "
                "check of the sharded path on one card, not a "
                "multi-card run.", world,
            )
        else:
            require_devices(n_space, device, n_style)
        build.build_all()
    if n_style == 1:
        logger.info(
            "Spatial sharding: image rows over %d %s ranks.",
            n_space, device_type,
        )
    else:
        logger.info(
            "Style batch over %d x %d (style x space) %s ranks.",
            n_style, n_space, device_type,
        )
    tmp = Path(tempfile.mkdtemp(prefix="stv-mesh-"))
    try:
        spec = (str(tmp / "rendezvous"), device_type, share_card, timeout)
        result_path = str(tmp / "result.pt")
        ctx = torch.multiprocessing.start_processes(
            _rank_main,
            args=(
                fn, args, kwargs or {}, (n_style, n_space), spec,
                result_path,
            ),
            nprocs=world, join=False, start_method="spawn",
        )
        end = None if deadline is None else time.monotonic() + deadline
        while not ctx.join(timeout=5.0):
            if end is not None and time.monotonic() > end:
                for proc in ctx.processes:
                    proc.kill()
                    proc.join()
                msg = (
                    f"{world} ranks did not finish within {deadline} s; "
                    "every rank was killed"
                )
                raise TimeoutError(msg)
        return torch.load(result_path, weights_only=False)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
