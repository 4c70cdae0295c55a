"""Scatter runs, and the fused sort's pass: bucketize and scatter in one kernel.

The PyTorch counterpart of ``gpuradixsort_tpu/kernels/scatter.py``.  After
``bucketize_tiles`` tile t holds its digit-r run at
``local_off[t, r] = sum(hist[t, :r])``, and the run belongs at
``offsets[t, r]`` of the output.  On a CUDA tensor ``scatter_runs`` launches
``csrc/scatter_runs.cu``, one warp a tile, which stores every element
straight at its place; the TPU's window plan, meta tables and carried row
have no counterpart, because the GPU has a random store.  There is no
window, so nothing can overflow: the ``overflow`` result stays for the JAX
package's API and is always False.  A destination outside the buffer, which
only an inconsistent hist/offsets pair gives, is dropped, as the JAX
package drops it; the kernel then leaves that output row unwritten, where
the plain version leaves a zero.

The JAX package's fused pass runs ``bucketize_tiles`` and then
``scatter_runs``, the bucketized tiles going through device memory between
them.  ``bucketize_scatter`` is that pair as one kernel
(``csrc/bucketize_scatter.cu``), which keeps the bucketized tile in shared
memory: it reads and writes each key once.  ``bucketize_tiles`` and
``scatter_runs`` stay as the counterparts of the JAX package's two functions.

The fused sort's passes run ``bucketize_scatter_lookback``, whose run
offsets come from no table.  A block of the kernel
(``csrc/bucketize_scatter.cu``) takes a partition of
``key_bits.LOOKBACK_PARTITION`` keys; its run of digit r starts at the
pass's digit base (``key_bits.sort_plan``) plus the counts of r in the
partitions before it, which the kernel finds by a decoupled look-back over
the partitions, so a pass launches no K1 and no offsets scan.  A stable
partition by digit has one answer, so the plain version computes it tile by
tile as the JAX package does.  ``bucketize_scatter``, which reads K1's
offsets table, stays as the counterpart of the JAX package's pass.

The look-back pass reads the sort's input and writes its result R where the
sort's argument block says (``key_bits.sort_args``), so one graph serves
every call of a shape.  Where it reads the input, the rows from the sort's
live length on are pad rows (PAD_KEY, PAD_INDEX), and with no index given
it makes the index: the JAX package's re-padding and index column, with no
pass over the buffer.  The plain version builds both with torch
(``key_bits.live_input``) and runs the pass on them.
"""

from __future__ import annotations

import torch

from gpuradixsort_tpu_torch.config import EngineConfig, resolve_impl
from gpuradixsort_tpu_torch.core.table import int32_bits
from gpuradixsort_tpu_torch.kernels._build import launch
from gpuradixsort_tpu_torch.kernels.bucketize import FAST_TILE, _bucketize_ref
from gpuradixsort_tpu_torch.kernels.key_bits import (
    SortArgs,
    SortPlan,
    check_block,
    check_length,
    live_input,
    lookback_words,
    sort_args,
)
from gpuradixsort_tpu_torch.kernels.radix import (
    MAX_SHARED_BYTES,
    WARP,
    _tile_histograms_ref,
    check_keys,
    check_plan,
    data_ptr,
    planned_route,
)

# Tiles a bucketize_scatter block: on an H100 (700 W) 4 ran 10% faster than
# 8 and 2% faster than 2 at 2^24 keys (kernel_ab.py; PERF.md, Findings).
FUSED_TILES_PER_BLOCK = 4
_MAX_FUSED_RADIX = 16


def _scatter_runs_ref(bk, bi, hist, offsets, cfg: EngineConfig):
    """Plain version: element-exact scatter of the bucketized runs."""
    num_tiles, radix = hist.shape
    wide = hist.to(torch.int64)
    ends = torch.cumsum(wide, dim=1)
    local_off = ends - wide
    pos = torch.arange(cfg.tile, device=bk.device).expand(num_tiles, cfg.tile)
    # Slots are digit-major, so a slot's run is the searchsorted bucket of
    # its position among the run ends.
    b = torch.searchsorted(ends, pos.contiguous(), right=True).clamp(max=radix - 1)
    dest = offsets.to(torch.int64).gather(1, b) + pos - local_off.gather(1, b)
    dest = dest.view(-1)
    keep = (dest >= 0) & (dest < bk.numel())  # the JAX oracle drops the rest

    def scatter(src):
        out = torch.zeros_like(int32_bits(src))
        out[dest[keep]] = int32_bits(src)[keep]
        return out.view(src.dtype)

    return scatter(bk), scatter(bi)


def _check_tables(hist: torch.Tensor, offsets: torch.Tensor, like: torch.Tensor,
                  num_tiles: int, cfg: EngineConfig) -> None:
    for name, t in (("hist", hist), ("offsets", offsets)):
        shape = (num_tiles, cfg.radix)
        if t.dtype != torch.int32 or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"{name} must be contiguous int32 of shape {shape}, got "
                f"{t.dtype} of shape {tuple(t.shape)}"
            )
        if t.device != like.device:
            raise ValueError("the keys, hist and offsets must be on one device")


def scatter_runs(
    bk: torch.Tensor,
    bi: torch.Tensor,
    hist: torch.Tensor,
    offsets: torch.Tensor,
    cfg: EngineConfig,
    impl: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor, bool]:
    """Scatter bucketized tiles to their global stable positions.

    bk, bi: (num_tiles * tile,) uint32, each tile digit-major.  hist,
    offsets: (num_tiles, radix) int32 per-tile counts and global offsets
    (``global_offsets``).  Returns (keys, indices, overflow=False).
    """
    num_tiles = check_keys("bk", bk, cfg)
    check_keys("bi", bi, cfg)
    if bi.device != bk.device:
        raise ValueError("bk and bi must be on one device")
    _check_tables(hist, offsets, bk, num_tiles, cfg)
    if resolve_impl(bk, impl) == "reference":
        return (*_scatter_runs_ref(bk, bi, hist, offsets, cfg), False)
    out_keys, out_idx = torch.empty_like(bk), torch.empty_like(bi)
    launch(
        "grs_scatter_runs", bk, bk.data_ptr(), bi.data_ptr(), hist.data_ptr(),
        offsets.data_ptr(), out_keys.data_ptr(), out_idx.data_ptr(), num_tiles,
        cfg.tile, cfg.radix,
    )
    scatter_runs.launches += 1
    return out_keys, out_idx, False


scatter_runs.launches = 0


def _bucketize_scatter_ref(keys, idx, hist, offsets, shift: int, cfg: EngineConfig):
    """Plain version: ``scatter_runs``' of ``bucketize_tiles``' (key, index) tiles."""
    return _scatter_runs_ref(*_bucketize_ref(keys, idx, shift, cfg), hist, offsets, cfg)


def bucketize_scatter_geometry(cfg: EngineConfig) -> tuple[int, int]:
    """(threads, shared bytes) of a bucketize_scatter block.

    One warp a tile, up to ``FUSED_TILES_PER_BLOCK`` tiles a block; each
    stages its tile's sorted keys and indices (8 bytes a key) in shared
    memory, and on any tile but the 1,024-key one also its rows of run ends
    and deltas (128 bytes).
    """
    per_tile = 8 * cfg.tile + (0 if cfg.tile == FAST_TILE else 8 * _MAX_FUSED_RADIX)
    tiles = min(FUSED_TILES_PER_BLOCK, MAX_SHARED_BYTES // per_tile)
    if tiles == 0:
        raise ValueError(
            f"bucketize_scatter stages {per_tile} bytes a tile, more than a block's "
            f"{MAX_SHARED_BYTES}; use tile_rows <= {(MAX_SHARED_BYTES - 128) // (8 * 128)}"
        )
    return WARP * tiles, tiles * per_tile


def bucketize_scatter(
    keys: torch.Tensor,
    idx: torch.Tensor,
    hist: torch.Tensor,
    offsets: torch.Tensor,
    shift: int,
    cfg: EngineConfig,
    impl: str | None = None,
    plan: torch.Tensor | None = None,
    pass_index: int = 0,
    buffers: tuple | None = None,
):
    """One fused pass: ``scatter_runs(*bucketize_tiles(keys, idx, shift), hist, offsets)``.

    keys, idx: (num_tiles * tile,) uint32; hist: the tiles' digit
    histograms (``tile_histograms``), offsets their ``global_offsets``.
    Returns the output (keys, idx).  The kernel counts each tile's digits
    itself and does not read hist, so hist must be the keys' histograms, as
    in a sort; the plain version reads it.

    With ``plan`` the call is pass ``pass_index`` of a fused sort whose input
    is (keys, idx) and whose result and scratch buffers are ``buffers``, two
    (keys, idx) pairs: the pass reads and writes the buffers the plan names,
    never the same, or, where the plan skips it, writes nothing; it returns
    None.
    """
    if cfg.radix > _MAX_FUSED_RADIX:
        raise ValueError("bucketize_scatter supports radix <= 16")
    num_tiles = check_keys("keys", keys, cfg)
    check_keys("idx", idx, cfg)
    if idx.numel() != keys.numel() or idx.device != keys.device:
        raise ValueError("keys and idx must have one length and one device")
    _check_tables(hist, offsets, keys, num_tiles, cfg)
    if plan is not None:
        pairs = buffers or ((None, None), (None, None))
        check_plan(plan, pass_index, keys, (idx, *pairs[0], *pairs[1]))
    if resolve_impl(keys, impl) == "reference":
        if plan is None:
            return _bucketize_scatter_ref(keys, idx, hist, offsets, shift, cfg)
        route = planned_route(plan, pass_index, ((keys, idx), *buffers))
        if route is not None:
            source, destination = route
            for dst, src in zip(destination,
                                _bucketize_scatter_ref(*source, hist, offsets, shift, cfg)):
                dst.copy_(src)
        return None
    if plan is None:
        out = torch.empty_like(keys), torch.empty_like(idx)
        scratch = (None, None)
    else:
        out, scratch = buffers
    threads, _ = bucketize_scatter_geometry(cfg)
    launch(
        "grs_bucketize_scatter", keys, keys.data_ptr(), idx.data_ptr(), offsets.data_ptr(),
        *map(data_ptr, out), *map(data_ptr, scratch), num_tiles, cfg.tile, threads, shift,
        cfg.radix, data_ptr(plan), pass_index,
    )
    bucketize_scatter.launches += 1
    return None if plan is not None else out


bucketize_scatter.launches = 0


def _lookback_offsets_ref(hist: torch.Tensor, bases: torch.Tensor) -> torch.Tensor:
    """Plain version of the look-back's run offsets: bases[r] + hist[:t, r].sum().

    hist: (num_tiles, radix) tile histograms; bases: (radix,) the pass's
    digit bases.  The exclusive scan runs over the transposed table's rows.
    """
    by_digit = hist.t().to(torch.int64).contiguous()
    excl = torch.cumsum(by_digit, dim=1) - by_digit + bases.to(torch.int64)[:, None]
    return excl.t().to(torch.int32).contiguous()


def _lookback_pass_ref(keys, idx, state: SortPlan, pass_index: int, cfg: EngineConfig):
    """Plain version: ``bucketize_scatter``'s of the tiles' histograms and look-back offsets."""
    shift = pass_index * cfg.radix_bits
    hist = _tile_histograms_ref(keys, shift, cfg)
    offsets = _lookback_offsets_ref(hist, state.bases[pass_index])
    return _bucketize_scatter_ref(keys, idx, hist, offsets, shift, cfg)


def _check_state(state: SortPlan, pass_index: int, like: torch.Tensor, num_tiles: int,
                 cfg: EngineConfig) -> None:
    shape = (cfg.num_passes, cfg.radix)
    if (state.bases.dtype != torch.int32 or tuple(state.bases.shape) != shape
            or not state.bases.is_contiguous() or state.lookback.dtype != torch.int32
            or state.lookback.numel() < lookback_words(num_tiles, cfg)
            or any(t.device != like.device for t in state)):
        raise ValueError(f"state must be a sort_plan of a {num_tiles}-tile buffer on {like.device}")
    if not 0 <= pass_index < cfg.num_passes:
        raise ValueError(f"pass_index {pass_index} is not a pass of {cfg.num_passes}")


def bucketize_scatter_lookback(
    keys: torch.Tensor,
    idx: torch.Tensor | None,
    cfg: EngineConfig,
    state: SortPlan,
    pass_index: int,
    buffers: tuple | None = None,
    impl: str | None = None,
    length: int | None = None,
    block: torch.Tensor | None = None,
):
    """Fused pass ``pass_index`` of a sort, its run offsets found by look-back.

    The output of ``bucketize_scatter(keys, idx, hist, offsets, shift, cfg)``
    at ``shift = pass_index * cfg.radix_bits``, hist the keys' tile
    histograms and offsets ``state.bases[pass_index]`` plus the exclusive sum
    of hist over the tiles: where ``state`` is the ``sort_plan`` of keys with
    the same multiset, as in a sort, that is ``global_offsets(hist)``.

    Where the pass reads the input (``keys``, ``idx``), its rows from
    ``length`` (all of them by default) on read as (PAD_KEY, PAD_INDEX), and
    with ``idx`` None element e's index is e: the input of
    ``key_bits.live_input(keys, idx, length)``, as ``sort_plan(keys, cfg,
    skipped, length=length)`` counts it.

    ``state``'s look-back scratch serves each pass index once: a launch
    leaves that pass's tickets and status words used (``sort_plan`` clears
    them for a sort).  With ``buffers``, the sort's result R and scratch S
    as two (keys, idx) pairs, the call routes as ``bucketize_scatter``'s
    with ``plan=state.plan`` and returns None; without, it reads the input
    and returns a new output.  On the card the kernel reads the input, the
    length and R from ``block``, the sort's argument block of them
    (``key_bits.sort_args``), which this call writes itself (one more
    launch) where it is None; a block comes with ``buffers``, whose R it
    names.
    """
    if cfg.radix > _MAX_FUSED_RADIX:
        raise ValueError("bucketize_scatter_lookback supports radix <= 16")
    num_tiles = check_keys("keys", keys, cfg)
    if idx is not None:
        check_keys("idx", idx, cfg)
        if idx.numel() != keys.numel() or idx.device != keys.device:
            raise ValueError("keys and idx must have one length and one device")
    length = check_length(length, keys)
    _check_state(state, pass_index, keys, num_tiles, cfg)
    if block is not None and buffers is None:
        raise ValueError("an argument block names the sort's result R: pass the sort's buffers")
    if buffers is not None:
        given = () if idx is None else (idx,)
        check_plan(state.plan, pass_index, keys, (*given, *buffers[0], *buffers[1]))
    if resolve_impl(keys, impl) == "reference":
        if buffers is None:
            return _lookback_pass_ref(*live_input(keys, idx, length), state, pass_index, cfg)
        route = planned_route(state.plan, pass_index, (None, *buffers))
        if route is not None:
            source, destination = route
            if source is None:  # the input
                source = live_input(keys, idx, length)
            for dst, src in zip(destination, _lookback_pass_ref(*source, state, pass_index, cfg)):
                dst.copy_(src)
        return None
    if buffers is None:
        out, scratch, plan = (torch.empty_like(keys), torch.empty_like(keys)), (None, None), None
    else:
        (out, scratch), plan = buffers, state.plan
    if block is None:
        block = sort_args(SortArgs(keys, idx, out, length))
    check_block(block, keys)
    launch(
        "grs_lookback_scatter", keys, block.data_ptr(), *map(data_ptr, scratch), keys.numel(),
        pass_index * cfg.radix_bits, cfg.radix, data_ptr(plan), pass_index,
        state.bases.data_ptr(), state.lookback.data_ptr(), state.lookback.numel(),
    )
    bucketize_scatter_lookback.launches += 1
    return None if buffers is not None else out


bucketize_scatter_lookback.launches = 0
