"""The (data, row) grid of ranks — the counterpart of
``fast_tffm_tpu/parallel/mesh.py``.

The JAX package lays its devices out as a ``jax.sharding.Mesh`` of shape
``[data, row]``, row-major.  Here one rank is one device, so the mesh is a
grid of ranks: rank r sits at ``(r // R, r % R)``.

  * ``row`` (R): the table is split into R contiguous row shards; rank r
    holds shard ``r % R``.  The R ranks that share a data coordinate form
    r's **row group** (``lax.all_gather(x, "row")`` and ``psum_scatter``
    run there).
  * ``data`` (D): the ranks that share a row coordinate hold identical
    copies of their shard (``P("row", None)``) and form r's **data
    group**.
  * Every rank scores a distinct ``B / (D·R)`` slice of the global batch,
    as the JAX batch splits over both axes; the world group is both axes.

The collectives below are the port's spellings of the JAX ones on these
groups.  Each takes the group's size: with no process group at all
(single process) a size-1 collective is the identity, and with one it
always runs, so a world-size-1 run can drive the general branches through
a real group (``Mesh(fast_paths=False)``).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

__all__ = [
    "DATA_AXIS",
    "ROW_AXIS",
    "Mesh",
    "make_mesh",
    "pad_vocab",
    "check_batch_divides",
    "all_gather_cat",
    "reduce_scatter_sum",
    "all_to_all",
    "all_reduce_sum",
]

DATA_AXIS = "data"
ROW_AXIS = "row"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the ``[data, row]`` grid and its groups
    (``None``: the default group).  ``fast_paths`` False takes the general
    (R > 1-shaped) branches even on axes of size 1."""

    data: int = 1
    row: int = 1
    rank: int = 0
    row_group: object = None
    data_group: object = None
    fast_paths: bool = True

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data, ROW_AXIS: self.row}

    @property
    def size(self) -> int:
        return self.data * self.row

    @property
    def data_index(self) -> int:
        return self.rank // self.row

    @property
    def row_index(self) -> int:
        return self.rank % self.row

    def one(self, axis: str) -> bool:
        """True where ``axis`` takes its size-1 fast path."""
        return self.fast_paths and self.shape[axis] == 1

    @property
    def single(self) -> bool:
        """The 1 x 1 fast path: the single-device step."""
        return self.fast_paths and self.size == 1


def make_mesh(data_parallel: int | None = None, row_parallel: int = 1, *,
              fast_paths: bool = True) -> Mesh:
    """The mesh of shape ``[data_parallel, row_parallel]`` over the ranks of
    the default process group (one rank without one).  ``data_parallel``
    None takes every rank left after ``row_parallel``.  The grid must hold
    every rank: a rank outside it would have no batch slice.

    Every rank creates every row and data group, in the same order, even
    the groups it is not in (``dist.new_group`` is collective)."""
    initialized = dist.is_available() and dist.is_initialized()
    n = dist.get_world_size() if initialized else 1
    rank = dist.get_rank() if initialized else 0
    row = int(row_parallel) if row_parallel else 1
    if data_parallel is None or data_parallel <= 0:
        if n % row:
            raise ValueError(f"{n} devices not divisible by row_parallel={row}")
        data_parallel = n // row
    data = int(data_parallel)
    if data * row != n:
        raise ValueError(
            f"mesh [{data}, {row}] needs {data * row} ranks, the process group has {n} "
            "(one rank per device: every rank must sit in the mesh)"
        )
    row_group = data_group = None
    if initialized and n > 1:
        for d in range(data):
            g = dist.new_group([d * row + j for j in range(row)])
            if d == rank // row:
                row_group = g
        for j in range(row):
            g = dist.new_group([d * row + j for d in range(data)])
            if j == rank % row:
                data_group = g
    return Mesh(data, row, rank, row_group, data_group, fast_paths)


def pad_vocab(vocabulary_size: int, row_parallel: int) -> int:
    """Round the table row count up so every row shard is equal-sized."""
    r = row_parallel
    return ((vocabulary_size + r - 1) // r) * r


def check_batch_divides(batch_size: int, mesh: Mesh) -> None:
    """Fail fast when the global batch cannot split over every rank."""
    if batch_size % mesh.size:
        raise ValueError(f"batch_size {batch_size} not divisible by the {mesh.size}-device mesh")


def _collective(size: int) -> bool:
    initialized = dist.is_available() and dist.is_initialized()
    if not initialized and size != 1:
        raise RuntimeError(f"a collective over {size} ranks needs an initialized process group")
    return initialized


def all_gather_cat(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """``lax.all_gather(x, axis, tiled=True)``: the group's tensors
    concatenated along dim 0 in rank order."""
    if not _collective(size):
        return x
    x = x.contiguous()
    out = x.new_empty((size * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out


def reduce_scatter_sum(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """``lax.psum_scatter(x, axis, scatter_dimension=0, tiled=True)``: the
    sum over the group, rank i keeping the i-th of ``size`` slices of dim 0."""
    if not _collective(size):
        return x
    x = x.contiguous()
    out = x.new_empty((x.shape[0] // size, *x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, op=dist.ReduceOp.SUM, group=group)
    return out


def all_to_all(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """``lax.all_to_all(x, axis, 0, 0, tiled=True)``: slice i of dim 0 goes
    to rank i, which keeps the slices in sender order."""
    if not _collective(size):
        return x
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def all_reduce_sum(x: torch.Tensor, size: int) -> torch.Tensor:
    """``lax.psum`` over the world's ``size`` ranks (a new tensor; the
    summation order is the backend's)."""
    if not _collective(size):
        return x
    out = x.detach().clone().contiguous()
    dist.all_reduce(out, op=dist.ReduceOp.SUM)
    return out
