"""Multi-host runtime: process-group init from torchrun's environment, node-aware mesh.

The PyTorch counterpart of ``gpuradixsort_tpu/parallel/multihost.py``.

- :func:`initialize` joins the process group that ``torchrun`` describes in
  the environment (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
  ``RANK``, ``LOCAL_RANK``).  In a single-process run it is a no-op and
  returns False, so a program can call it unconditionally.
- :func:`make_pod_mesh` groups the ranks by node, hosts in the order of
  their lowest rank; :func:`flatten_pod_mesh` gives the row mesh host-major,
  so each host's shards are neighbours and the range partition sends most
  rows between ranks of one host.  The JAX package's ``make_pod_mesh``
  reshapes the device list by position, which groups by device id, not by
  process; here the node of each rank comes from torchrun's ``GROUP_RANK``
  or, where that is not set, from the hostname.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket

import torch
import torch.distributed as dist

from gpuradixsort_tpu_torch.config import default_device
from gpuradixsort_tpu_torch.parallel.mesh import RowMesh, row_mesh_in_order


def initialize(timeout: float | None = None) -> bool:
    """Join the process group torchrun describes.  Idempotent.

    Returns True once this process is in a group, False for the
    single-process no-op (no ``MASTER_ADDR`` in the environment).  Takes
    ``nccl`` when every local rank has its own card, ``gloo`` otherwise, and
    makes card ``LOCAL_RANK`` (modulo the cards) the current device.
    """
    if dist.is_initialized():
        return True
    if "MASTER_ADDR" not in os.environ:
        return False
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards:
        torch.cuda.set_device(local_rank % cards)
    backend = "nccl" if cards >= local_world else "gloo"
    dist.init_process_group(
        backend, init_method="env://",
        timeout=None if timeout is None else datetime.timedelta(seconds=timeout))
    return True


def _node_key() -> str:
    group_rank = os.environ.get("GROUP_RANK")
    return f"node {group_rank}" if group_rank is not None else socket.gethostname()


@dataclasses.dataclass(frozen=True)
class PodMesh:
    """Ranks grouped by node: ``grid[h]`` lists host h's global ranks, ascending."""

    group: dist.ProcessGroup
    grid: tuple[tuple[int, ...], ...]
    device: torch.device


def make_pod_mesh(group=None, device=None) -> PodMesh:
    """(host, local) grid of the group's ranks, grouped by the node each rank runs on.

    Every rank of ``group`` must call it (one all-gather of the node names).
    Hosts must hold equal numbers of ranks.  ``device`` holds this rank's
    shard; by default the rank's current CUDA card, under any backend.
    """
    device = default_device(device)
    group = group or dist.group.WORLD
    ranks = dist.get_process_group_ranks(group)
    keys = [None] * len(ranks)
    dist.all_gather_object(keys, _node_key(), group=group)
    hosts: dict[str, list[int]] = {}
    for rank, key in zip(ranks, keys):
        hosts.setdefault(key, []).append(rank)
    per_host = {len(v) for v in hosts.values()}
    if len(per_host) != 1:
        raise ValueError(f"ranks do not split evenly over hosts: {hosts}")
    grid = tuple(tuple(sorted(v)) for v in sorted(hosts.values(), key=min))
    return PodMesh(group, grid, device)


def flatten_pod_mesh(pod: PodMesh) -> RowMesh:
    """The row mesh the ``dist_*`` operators take, shards host-major."""
    return row_mesh_in_order([r for host in pod.grid for r in host], pod.group, pod.device)
