"""Run a function on every rank of a fresh process group, and the per-rank op runner.

The JAX package simulates a mesh with virtual devices in one process; here
each shard is a process.  ``run_ranks`` spawns ``world`` processes, joins
them through a ``file://`` rendezvous in a temporary directory (a TCP port
could collide between concurrent runs), calls ``fn(mesh, *args)`` on each
and returns each rank's result.  It raises if any rank raised, exited
non-zero or outlived ``timeout``; the same timeout bounds every collective,
so a lost rank fails the others instead of hanging them.

``run_ops`` is the per-rank body the tests, ``chip_smoke.py`` and the
entry points run: it takes each rank's shard of global host arrays, runs
the distributed operators on it, and returns host results.  Spawned ranks
import this module and the operators, never the test modules or JAX.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import pickle
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from gpuradixsort_tpu_torch.config import default_device
from gpuradixsort_tpu_torch.parallel import mesh as M
from gpuradixsort_tpu_torch.parallel.dist_ops import (
    dist_group_by_aggregate,
    dist_join_inner,
    gather_groups,
    gather_join,
)
from gpuradixsort_tpu_torch.parallel.dist_sort import dist_sort_pairs, gather_sorted
from gpuradixsort_tpu_torch.parallel.multihost import flatten_pod_mesh, make_pod_mesh
from gpuradixsort_tpu_torch.utils.timing import StageClock, profiled_device_ms
from gpuradixsort_tpu_torch.utils.trace import kernel_wrappers


def _rank_env(rank: int, world: int, nodes) -> dict:
    """torchrun's variables for ``rank``: node = ``nodes[rank]``, local rank within it."""
    node = nodes[rank]
    same = [r for r in range(world) if nodes[r] == node]
    return {"RANK": str(rank), "WORLD_SIZE": str(world), "GROUP_RANK": str(node),
            "LOCAL_RANK": str(same.index(rank)), "LOCAL_WORLD_SIZE": str(len(same))}


def _rank_main(rank, world, store, backend, device, timeout, fn, args, env, out_path):
    os.environ.update(env)
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            if dev.index is None:
                dev = torch.device("cuda", int(env["LOCAL_RANK"]) % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        else:
            torch.set_num_threads(1)
        dist.init_process_group(backend, init_method=f"file://{store}", world_size=world,
                                rank=rank, timeout=datetime.timedelta(seconds=timeout))
        try:
            result = ("ok", fn(M.make_row_mesh(device=dev), *args))
        finally:
            dist.destroy_process_group()
    except BaseException:  # reported to the parent, which raises
        result = ("error", traceback.format_exc())
    with open(out_path + ".tmp", "wb") as f:
        pickle.dump(result, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(out_path + ".tmp", out_path)
    if result[0] != "ok":
        raise SystemExit(1)


def _stop(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(10)
        if p.is_alive():
            p.kill()
            p.join(10)


def run_ranks(world: int, fn, args=(), backend: str = "gloo", device: str | None = None,
              timeout: float = 300.0, nodes=None) -> list:
    """``fn(mesh, *args)`` on each of ``world`` spawned ranks; their results, by rank.

    ``fn`` must be importable by the spawned ranks (a module-level function
    of a module that imports no test code).  ``device``: ``"cuda"`` (the
    default), card LOCAL_RANK modulo the cards for each rank; one card
    (``"cuda:0"``: every rank on it); or ``"cpu"``.  Ranks that share a card
    need gloo: NCCL refuses two ranks on one GPU.  Without a card the default
    raises; the ranks run on the CPU only when ``device="cpu"``.
    ``nodes[r]`` is rank r's node number (default: all on node 0), set as
    torchrun would set it.
    """
    if device is None:
        device = default_device().type
    nodes = list(nodes) if nodes is not None else [0] * world
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.pkl") for r in range(world)]
        procs = [ctx.Process(target=_rank_main, daemon=True, args=(
            r, world, os.path.join(tmp, "store"), backend, device, timeout, fn, args,
            _rank_env(r, world, nodes), outs[r])) for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        timed_out = False
        try:
            while any(p.is_alive() for p in procs):
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
                if time.monotonic() > deadline:
                    timed_out = True
                    break
                time.sleep(0.05)
        finally:
            _stop(procs)
        results, errors = [], []
        for r, (p, out) in enumerate(zip(procs, outs)):
            status, value = ("missing", None)
            if os.path.exists(out):
                with open(out, "rb") as f:
                    status, value = pickle.load(f)
            if status == "ok" and p.exitcode == 0:
                results.append(value)
            elif status == "error":
                errors.append(f"rank {r} raised:\n{value}")
            else:
                why = f"timed out after {timeout} s" if timed_out else "stopped"
                errors.append(f"rank {r} exited with code {p.exitcode} and no result ({why})")
        if errors:
            raise RuntimeError(f"{len(errors)} of {world} ranks failed\n" + "\n".join(errors))
        return results


# -- the per-rank op runner ----------------------------------------------------

KERNEL_WRAPPERS = kernel_wrappers()


def _host(x):
    """A global host array; a path names a .npy file, read as a memory map."""
    return np.load(x, mmap_mode="r") if isinstance(x, str) else x


def _run_op(mesh, op: str, shard: dict, values: dict, kwargs: dict, clock=None):
    """One operator call on this rank's shard; returns (result, its columns, its gather)."""
    if op == "sort":
        res = dist_sort_pairs(shard["keys"], mesh, clock=clock, **kwargs)
        return res, {"keys": res.keys, "index": res.index}, gather_sorted
    if op == "aggregate":
        res = dist_group_by_aggregate(shard["keys"], values, mesh=mesh, clock=clock, **kwargs)
        return res, {"keys": res.keys, **res.values}, gather_groups
    if op == "join":
        res = dist_join_inner(shard["probe_keys"], shard["probe_values"], shard["build_keys"],
                              shard["build_values"], mesh, clock=clock, **kwargs)
        return res, {"keys": res.keys, "probe_values": res.probe_values,
                     "build_values": res.build_values}, gather_join
    raise ValueError(f"unknown op {op!r}")


def _run_call(mesh, call: dict) -> dict:
    op, inputs, kwargs = call["op"], call["inputs"], call.get("kwargs", {})
    shard = {name: M.shard_rows(mesh, _host(x)) for name, x in inputs.items()
             if name != "values"}
    values = {name: M.shard_rows(mesh, _host(x)) for name, x in inputs.get("values", {}).items()}
    if call.get("warmup", False):  # untimed: allocator, host buffers, communicators
        _run_op(mesh, op, shard, values, kwargs)
    clock = StageClock(lambda: M.barrier(mesh))
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0
    t0 = clock.start()
    res, cols, gather = _run_op(mesh, op, shard, values, kwargs, clock)
    wall = clock.mark("counts") - t0
    launches = {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}
    counts = res.counts.cpu().numpy()
    out = {"shard": mesh.shard, "ranks": mesh.ranks, "transport": mesh.transport,
           "counts": counts,
           "overflow": bool(res.overflow), "wall_s": wall, "split_s": dict(clock.seconds),
           "launches": launches}
    if call.get("profile"):
        _, rows = profiled_device_ms(lambda: _run_op(mesh, op, shard, values, kwargs), calls=1)
        out["device_ms"] = {row: ms for row, ms in rows.items()
                            if any(name in row for name in call["profile"])}
    if call.get("shards", True):
        out["live"] = {name: t[:counts[mesh.shard]].cpu().numpy() for name, t in cols.items()}
    if call.get("gather", False):
        try:
            gathered = gather(res, mesh)
        except RuntimeError as e:  # the overflow flag, read alike by every shard
            out["gather_error"] = str(e)
        else:
            out["gathered"] = gathered if mesh.shard == 0 else None
    return out


def run_ops(mesh, calls: list[dict], pod: bool = False) -> list[dict]:
    """Run distributed operators on this rank's shards; one host result per call.

    Each call is ``{"op": "sort" | "aggregate" | "join", "inputs": {...},
    "kwargs": {...}, "warmup": bool, "shards": bool, "gather": bool}``.  ``inputs`` holds
    global host arrays (or paths of .npy files): ``keys`` (and ``values``, a
    dict) for sort and aggregate; ``probe_keys``, ``probe_values``,
    ``build_keys``, ``build_values`` for join.  ``kwargs`` go to the
    operator; ``warmup`` runs the op once untimed first; ``profile``, a
    list of names, runs it once more after the timed run under
    torch.profiler (a CUDA rank only) and adds ``device_ms``: the device ms
    of each profiler row whose name holds one of them, empty where the
    rank's profiler recorded none.  Each result holds
    this shard's index, the shard order, the transport, the counts and
    overflow flag, the timed run's wall time and its split by stage (every
    stage waits for the device and all ranks), its kernel launches on this
    rank, this shard's live rows (``shards``, default True) and, on
    shard 0, the gathered global result (``gather``).  ``pod=True`` runs
    them over ``flatten_pod_mesh(make_pod_mesh())``, shards host-major.
    """
    if pod:
        mesh = flatten_pod_mesh(make_pod_mesh(device=mesh.device))
    return [_run_call(mesh, call) for call in calls]
