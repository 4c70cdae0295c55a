"""Scatter runs, and the fused sort's pass: K1, the offsets scan, K2 and K3 in one kernel.

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

The JAX package's fused pass runs K1, the offsets scan, ``bucketize_tiles``
and then ``scatter_runs``, the bucketized tiles going through device memory
between the last two.  The port's fused sort runs each pass as one kernel,
``bucketize_scatter_lookback`` (``csrc/bucketize_scatter.cu``), whose run
offsets come from no table.  A block takes a partition of
``sort_plan.LOOKBACK_PARTITION`` keys and keeps it in shared memory, so it
reads and writes each key once; its run of digit r starts at the pass's
digit base (``sort_plan.sort_plan``) plus the counts of r in the partitions
before it, which the kernel finds by a decoupled look-back over the
partitions.  A stable partition by digit has one answer, so the plain
version computes it tile by tile as the JAX package does
(``_bucketize_scatter_ref``, ``scatter_runs``' of ``bucketize_tiles``' and
the JAX pair's oracle in the tests).  ``bucketize_tiles`` and
``scatter_runs`` stay as the counterparts of the JAX package's two
functions.

The look-back pass reads the sort's input and writes its result R where the
sort's argument block says (``sort_plan.sort_args``), so one graph serves
every call of a shape.  In every buffer it reads, the rows from the sort's
live length on are pad rows (PAD_KEY, PAD_INDEX), and with no index given
it makes the input's: the JAX package's re-padding and index column, with
no pass over the buffer.  Pads stay at the tail in every pass, so a pass
walks only the live partitions (``sort_plan.lookback_rows``) and writes its
destination's live rows; the last pass that runs also writes R's rows from
the length on as pads, once a sort.  An eager launch's grid covers the
host's live length (and a wave of blocks for that fill); one captured in a
CUDA graph covers the padded length, so that its replays serve every live
length.  The plain version builds the input with torch
(``sort_plan.live_input``), runs the pass on it and writes the same rows.
"""

from __future__ import annotations

import torch

from gpuradixsort_tpu_torch.config import EngineConfig, resolve_impl
from gpuradixsort_tpu_torch.core.table import int32_bits
from gpuradixsort_tpu_torch.kernels._build import launch
from gpuradixsort_tpu_torch.kernels.bucketize import _bucketize_ref
from gpuradixsort_tpu_torch.kernels.radix import _tile_histograms_ref, check_keys, data_ptr
from gpuradixsort_tpu_torch.kernels.sort_plan import (
    SortArgs,
    SortPlan,
    check_block,
    check_length,
    check_plan,
    last_planned,
    live_input,
    lookback_words,
    planned_route,
    sort_args,
)

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


def _lookback_offsets_ref(hist: torch.Tensor, bases: torch.Tensor) -> torch.Tensor:
    """Plain version of the look-back's run offsets: bases[r] + hist[:t, r].sum().

    hist: (num_tiles, radix) tile histograms; bases: (radix,) the pass's
    digit bases.  The exclusive scan runs over the transposed table's rows.
    """
    by_digit = hist.t().to(torch.int64).contiguous()
    excl = torch.cumsum(by_digit, dim=1) - by_digit + bases.to(torch.int64)[:, None]
    return excl.t().to(torch.int32).contiguous()


def _lookback_pass_ref(keys, idx, state: SortPlan, pass_index: int, cfg: EngineConfig):
    """Plain version: ``_bucketize_scatter_ref`` of the tiles' histograms and look-back offsets."""
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

    The output of ``scatter_runs(*bucketize_tiles(keys, idx, shift, cfg),
    hist, offsets, cfg)`` at ``shift = pass_index * cfg.radix_bits``, hist
    the keys' tile histograms and offsets ``state.bases[pass_index]`` plus
    the exclusive sum of hist over the tiles: where ``state`` is the
    ``sort_plan`` of keys with the same multiset, as in a sort, that is
    ``global_offsets(hist)``.

    In whatever buffer the pass reads, the input (``keys``, ``idx``), R or
    S, its rows from ``length`` (all of them by default) on read as
    (PAD_KEY, PAD_INDEX), and with ``idx`` None the input's element e's
    index is e: the input of ``sort_plan.live_input(keys, idx, length)``, as
    ``sort_plan(keys, cfg, skipped, length=length)`` counts it.  The pass
    writes its destination's rows below ``length``; the last pass the plan
    runs, and a call without ``buffers``, also write the rows from there on
    as pads.

    ``state``'s look-back scratch serves each pass index once: a launch
    leaves that pass's tickets and status words used (``sort_plan`` clears
    them for a sort).  With ``buffers``, the sort's result R and scratch S
    as two (keys, idx) pairs, the call is pass ``pass_index`` of the sort:
    it reads and writes the buffers ``state.plan`` names, never the same,
    or, where the plan skips it, writes nothing; it returns None.  Without
    ``buffers`` it reads the input
    and returns a new output.  On the card the kernel reads the input, the
    length and R from ``block``, the sort's argument block of them
    (``sort_plan.sort_args``), which this call writes itself (one more
    launch) where it is None; a block comes with ``buffers``, whose R it
    names.  An eager launch's grid covers ``length``, which must be the
    block's; one made while the stream captures a CUDA graph covers every
    row, so that the graph serves any length the block holds.
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
        route = planned_route(state.plan, pass_index, ((keys, idx), *buffers))
        if route is not None:
            source, destination = route
            rows = keys.numel() if last_planned(state.plan, pass_index) else length
            out = _lookback_pass_ref(*live_input(*source, length), state, pass_index, cfg)
            for dst, src in zip(destination, out):
                dst[:rows].copy_(src[:rows])
        return None
    if buffers is None:
        out, scratch, plan = (torch.empty_like(keys), torch.empty_like(keys)), (None, None), None
    else:
        (out, scratch), plan = buffers, state.plan
    if block is None:
        block = sort_args(SortArgs(keys, idx, out, length))
    check_block(block, keys)
    rows = keys.numel() if torch.cuda.is_current_stream_capturing() else length
    launch(
        "grs_lookback_scatter", keys, block.data_ptr(), *map(data_ptr, scratch), keys.numel(),
        rows, pass_index * cfg.radix_bits, cfg.radix, data_ptr(plan), pass_index,
        cfg.num_passes, state.bases.data_ptr(), state.lookback.data_ptr(),
        state.lookback.numel(),
    )
    bucketize_scatter_lookback.launches += 1
    return None if buffers is not None else out


bucketize_scatter_lookback.launches = 0
