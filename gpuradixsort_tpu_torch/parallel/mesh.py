"""The row mesh: one process per shard, and the few collectives the layer uses.

The PyTorch counterpart of ``gpuradixsort_tpu/parallel/mesh.py``.  The JAX
package shards rows over the ``"x"`` axis of a device mesh and runs each
shard's body under ``shard_map``; here each rank of a ``torch.distributed``
process group holds its own shard on its own device, and the mesh's row
axis is that process group.

A ``RowMesh`` keeps the shard order apart from the group's rank order:
``flatten_pod_mesh`` orders ranks host-major, which need not be the global
rank order.  ``all_to_all_single`` splits its buffer by group rank, so
``all_to_all`` permutes the blocks from shard order to rank order and back.

The collectives take no uint32 (gloo raises "Invalid scalar type"), so
uint32 moves as its int32 view.  Where the backend is gloo and the shard
lies on a CUDA card, every collective goes through pinned host memory:
gloo is the only backend that runs several ranks on one card (NCCL refuses
two ranks on one GPU), and that transfer says nothing about NVLink.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from gpuradixsort_tpu_torch.config import default_device
from gpuradixsort_tpu_torch.core.table import int32_bits


@dataclasses.dataclass(frozen=True)
class RowMesh:
    """This rank's view of the row axis: its shard, its device, the shard order."""

    group: dist.ProcessGroup  # the row axis
    ranks: tuple[int, ...]  # global rank of each shard, in shard order
    shard: int  # this rank's shard index
    device: torch.device
    backend: str

    @property
    def num_shards(self) -> int:
        return len(self.ranks)

    @property
    def staged(self) -> bool:
        """Collectives copy through host memory (gloo with a CUDA shard)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    @property
    def transport(self) -> str:
        return f"{self.backend} via host" if self.staged else self.backend


def row_mesh_in_order(ranks, group=None, device=None) -> RowMesh:
    """A RowMesh whose shard s is global rank ``ranks[s]`` of ``group``.

    ``device`` holds this rank's shard; by default the rank's current CUDA
    card, under any backend (``config.default_device``: without a card it
    raises unless ``device="cpu"``).
    """
    group = group or dist.group.WORLD
    backend = str(dist.get_backend(group))
    ranks = tuple(int(r) for r in ranks)
    if sorted(ranks) != sorted(dist.get_process_group_ranks(group)):
        raise ValueError(f"shard order {ranks} is not the ranks of the group")
    return RowMesh(group, ranks, ranks.index(dist.get_rank()), default_device(device),
                   backend)


def make_row_mesh(group=None, device=None) -> RowMesh:
    """The row mesh over ``group`` (default: every rank), shards in rank order.

    ``device`` is as in ``row_mesh_in_order``.
    """
    group = group or dist.group.WORLD
    return row_mesh_in_order(dist.get_process_group_ranks(group), group, device)


def shard_rows(mesh: RowMesh, global_array) -> torch.Tensor:
    """This rank's contiguous slice of a global array, on the mesh's device.

    ``global_array``: a numpy array (a memory map reads only the slice) or
    a JAX array (copied to the host first).  Its length must split evenly
    over the shards.  The shard is a copy.
    """
    n = global_array.shape[0]
    if n % mesh.num_shards:
        raise ValueError(f"{n} rows do not split over {mesh.num_shards} shards")
    n_local = n // mesh.num_shards
    rows = np.asarray(global_array)[mesh.shard * n_local:(mesh.shard + 1) * n_local]
    return torch.from_numpy(np.array(rows)).to(mesh.device)


# -- transport -----------------------------------------------------------------


def _to_wire(mesh: RowMesh, t: torch.Tensor) -> torch.Tensor:
    """``t`` as the collectives take it: int32 bits for uint32, on the host if staged."""
    t = int32_bits(t).contiguous()
    if not mesh.staged:
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    torch.cuda.current_stream(mesh.device).synchronize()
    return host


def _empty_wire(mesh: RowMesh, like: torch.Tensor) -> torch.Tensor:
    if not mesh.staged:
        return torch.empty_like(like)
    return torch.empty(like.shape, dtype=like.dtype, pin_memory=True)


def _from_wire(mesh: RowMesh, t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    out = t.to(mesh.device, non_blocking=True) if mesh.staged else t
    return out.view(dtype) if dtype == torch.uint32 else out


_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}


def all_reduce(mesh: RowMesh, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """Sum, min or max of ``t`` over the shards, returned as a new tensor.

    Reduce int64 or float values: a min or max over int32 views orders
    uint32 keys >= 2^31 wrongly.
    """
    if t.dtype == torch.uint32:
        raise TypeError("all_reduce takes no uint32; widen to int64 first")
    wire = _to_wire(mesh, t)
    if wire is t:
        wire = t.clone()
    dist.all_reduce(wire, op=_OPS[op], group=mesh.group)
    return _from_wire(mesh, wire, t.dtype)


def barrier(mesh: RowMesh) -> None:
    """Wait for every shard (a one-element all_reduce on the mesh's transport)."""
    all_reduce(mesh, torch.zeros(1, dtype=torch.int32, device=mesh.device))


def _block_perm(mesh: RowMesh) -> torch.Tensor | None:
    """Shard index of each group rank, or None when shard order is rank order."""
    group_rank = [dist.get_group_rank(mesh.group, r) for r in mesh.ranks]
    if group_rank == list(range(mesh.num_shards)):
        return None
    shard_of = [0] * mesh.num_shards
    for s, g in enumerate(group_rank):
        shard_of[g] = s
    return torch.tensor(shard_of, dtype=torch.int64)


def all_to_all(mesh: RowMesh, t: torch.Tensor) -> torch.Tensor:
    """Tiled all-to-all: block d of ``t`` goes to shard d; block s of the result came from shard s.

    ``t`` splits along dim 0 into ``num_shards`` equal blocks, as the JAX
    package's ``all_to_all(..., tiled=True)`` over the row axis.
    """
    p = mesh.num_shards
    if t.shape[0] % p:
        raise ValueError(f"{t.shape[0]} rows do not split into {p} blocks")
    x = int32_bits(t)
    perm = _block_perm(mesh)
    if perm is not None:  # blocks in group-rank order
        x = x.reshape(p, -1).index_select(0, perm.to(x.device)).reshape(x.shape)
    wire = _to_wire(mesh, x)
    out = _empty_wire(mesh, wire)
    dist.all_to_all_single(out, wire, group=mesh.group)
    out = _from_wire(mesh, out, out.dtype)
    if perm is not None:  # back to shard order: shard s sits at its group rank
        inv = torch.argsort(perm).to(out.device)
        out = out.reshape(p, -1).index_select(0, inv).reshape(out.shape)
    return out.view(t.dtype)


def all_gather(mesh: RowMesh, t: torch.Tensor) -> torch.Tensor:
    """(num_shards, *t.shape): every shard's ``t``, in shard order."""
    wire = _to_wire(mesh, t)
    parts = [_empty_wire(mesh, wire) for _ in range(mesh.num_shards)]
    dist.all_gather(parts, wire, group=mesh.group)
    by_rank = dict(zip(dist.get_process_group_ranks(mesh.group), parts))
    rows = torch.stack([_from_wire(mesh, by_rank[r], wire.dtype) for r in mesh.ranks])
    return rows.view(t.dtype)


class RingStep:
    """One ring step in flight: my blocks to shard (me - step), from shard (me + step)."""

    def __init__(self, mesh: RowMesh, blocks: list[torch.Tensor], step: int):
        p = mesh.num_shards
        dst = mesh.ranks[(mesh.shard - step) % p]
        src = mesh.ranks[(mesh.shard + step) % p]
        self._mesh = mesh
        self._dtypes = [b.dtype for b in blocks]
        wires = [_to_wire(mesh, b) for b in blocks]
        self._recv = [_empty_wire(mesh, w) for w in wires]
        ops = [dist.P2POp(dist.isend, w, dst, mesh.group) for w in wires]
        ops += [dist.P2POp(dist.irecv, r, src, mesh.group) for r in self._recv]
        self._reqs = dist.batch_isend_irecv(ops)
        self._sent = wires  # alive until the sends complete

    def wait(self) -> list[torch.Tensor]:
        """The blocks received from shard (me + step), on the mesh's device."""
        for req in self._reqs:
            req.wait()
        return [_from_wire(self._mesh, r, d) for r, d in zip(self._recv, self._dtypes)]


def gather_prefixes(mesh: RowMesh, buf: torch.Tensor, counts: np.ndarray) -> np.ndarray:
    """The first ``counts[s]`` rows of every shard's ``buf``, concatenated in shard order.

    Every shard calls it with the same ``counts``; each gets the result on
    the host.
    """
    width = int(counts.max()) if counts.size else 0
    if width == 0:
        return buf[:0].cpu().numpy()
    rows = all_gather(mesh, buf[:width].contiguous()).cpu().numpy()
    return np.concatenate([rows[s, : counts[s]] for s in range(mesh.num_shards)])
