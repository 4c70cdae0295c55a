"""The AND and the OR of every key, and the fused sort's pass plan made from them.

The fused sort's constant-digit skip (``ops/sort.py``).  The JAX package
decides in every pass, on the device, whether the pass's digit has one value
over the whole padded buffer (a ``lax.cond`` in
``gpuradixsort_tpu/ops/sort.py::_fused_pass``); it has no Pallas kernel for
it.  Passes only permute the keys, so the AND and the OR of the keys before
the first pass answer it for every pass at once.  On a CUDA tensor
``key_bits`` and ``pass_plan`` launch ``csrc/key_bits.cu``, which for a plan
also turns the two words into the plan on the card; on a CPU tensor they run
the plain versions, which reduce one bit plane at a time (PyTorch has no
bitwise reduction) and build the plan on the host from ``pass_mask``.

The plan is one int32 a pass (``kernels/radix.py::plan_entry``): -1 where
the pass is skipped, else the buffer it reads and the one it writes.  A
pass cannot scatter into the buffer it reads, so the passes that run
ping-pong between the sort's result R and its scratch S, assigned from the
last pass that runs backwards (R, S, R, ...) so that the last one writes R;
the first reads the sort's input, which is never written.  With no varying
digit the last pass runs from the input into R: its digit is constant, so
it copies the input.

A fused sort also needs every pass's digit counts, which the JAX package
sums from K1's tile histograms in each pass.  A pass keeps the keys'
multiset, so the counts of the input serve every pass: ``sort_plan``
counts them in the same read of the keys (``sort_plan_kernel``) and writes
beside the plan each pass's digit bases, the exclusive prefix of its counts,
from which the fused pass finds its run offsets by look-back
(``kernels/scatter.py::bucketize_scatter_lookback``).  The look-back's
scratch (a status word a partition of ``LOOKBACK_PARTITION`` keys and
digit, and a ticket a pass) lies in the same allocation and is cleared by
the same memset, once a sort.

A fused sort's per-call inputs, its input keys and index, its result R and
its live length, reach its kernels through an argument block on the card
(``SortArgs``, ``sort_args``), written once a sort before the plan, so that
a cached graph of the sort reads the caller's keys where they lie and
writes a result the caller owns.  ``sort_plan`` reads only the live keys
and counts the rows from the length on as pads (PAD_KEY) without reading
them; the look-back pass reads them as pads too and, where the block names
no index, makes the index (``kernels/scatter.py``).  The plain versions
re-pad the keys and make the index with torch (``live_input``), as the JAX
package does before its sort.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gpuradixsort_tpu_torch.config import PAD_INDEX, PAD_KEY, EngineConfig, resolve_impl
from gpuradixsort_tpu_torch.core.table import int32_bits, uint32_as_int32, wrap_int32
from gpuradixsort_tpu_torch.kernels._build import launch
from gpuradixsort_tpu_torch.kernels.radix import (
    INPUT,
    PLAN_SKIP,
    RESULT,
    SCRATCH,
    check_keys,
    data_ptr,
    digits_of,
    plan_entry,
)


def _check_keys(keys: torch.Tensor) -> None:
    if keys.dtype != torch.uint32 or keys.dim() != 1 or not keys.is_contiguous():
        raise ValueError(
            f"keys must be a contiguous 1-D torch.uint32 tensor, got {keys.dtype} of "
            f"shape {tuple(keys.shape)}"
        )


def _key_bits_ref(keys: torch.Tensor) -> torch.Tensor:
    """Plain version: each of the 32 bit planes' ``all`` and ``any``."""
    wide = int32_bits(keys).to(torch.int64) & 0xFFFFFFFF
    planes = (((wide >> b) & 1).bool() for b in range(32))  # one bit plane at a time
    bits = torch.stack([torch.stack([p.all(), p.any()]) for p in planes])  # (32, 2)
    shifts = torch.arange(32, device=keys.device)[:, None]
    return wrap_int32((bits.to(torch.int64) << shifts).sum(dim=0)).view(torch.uint32)


def key_bits(keys: torch.Tensor, impl: str | None = None) -> torch.Tensor:
    """(2,) uint32 on ``keys``' device: the AND and the OR of every key.

    ``keys``: a contiguous 1-D uint32 tensor of any length; an empty one
    gives all-ones and zero.
    """
    _check_keys(keys)
    if resolve_impl(keys, impl) == "reference":
        return _key_bits_ref(keys)
    out = torch.empty(2, dtype=torch.uint32, device=keys.device)
    launch("grs_key_bits", keys, keys.data_ptr(), keys.numel(), out.data_ptr(), None, 0, 0, None)
    key_bits.launches += 1
    return out


key_bits.launches = 0


def _mask_of(words: torch.Tensor, cfg: EngineConfig) -> int:
    """The pass mask of the keys' AND and OR, read back to the host."""
    all_bits, any_bits = (w & 0xFFFFFFFF for w in int32_bits(words).tolist())
    varying = any_bits & ~all_bits  # 0 for an empty buffer, as no bucket is filled
    return sum(1 << p for p in range(cfg.num_passes)
               if (varying >> (p * cfg.radix_bits)) & (cfg.radix - 1))


def pass_mask(keys: torch.Tensor, cfg: EngineConfig) -> int:
    """Bit p set where pass p of a fused sort of the padded ``keys`` runs.

    The JAX package skips pass p when the pass's histogram has one non-empty
    bucket, pad keys included.  A pass keeps the multiset of the keys, so
    that holds before the first pass exactly where digit p's bits agree in
    the AND and the OR of every key.  The host counterpart of the plan: it
    reads the two words back, which the sort itself never does.
    """
    return _mask_of(key_bits(keys), cfg)


def plan_of_mask(mask: int, num_passes: int) -> list[int]:
    """The pass plan of a pass mask, as ``csrc/key_bits.cu`` builds it on the card."""
    runs = [p for p in range(num_passes) if (mask >> p) & 1] or [num_passes - 1]  # or the copy
    plan, source = [PLAN_SKIP] * num_passes, INPUT
    for i, p in enumerate(runs):  # R for the last, S for the one before, ...
        destination = SCRATCH if (len(runs) - 1 - i) % 2 else RESULT
        plan[p] = plan_entry(source, destination)
        source = destination
    return plan


def pass_plan(keys: torch.Tensor, cfg: EngineConfig, skipped: torch.Tensor,
              impl: str | None = None) -> torch.Tensor:
    """(cfg.num_passes,) int32 on ``keys``' device: the pass plan of a fused sort of ``keys``.

    Also adds the number of passes the JAX package would skip (the copy of
    an all-constant buffer not counted as run) to ``skipped``, an int64 (1,)
    counter on the same device.  On the card nothing is read back.
    """
    _check_keys(keys)
    if skipped.dtype != torch.int64 or skipped.shape != (1,) or skipped.device != keys.device:
        raise ValueError(f"skipped must be an int64 tensor of shape (1,) on {keys.device}")
    if resolve_impl(keys, impl) == "reference":
        mask = _mask_of(_key_bits_ref(keys), cfg)
        skipped += cfg.num_passes - bin(mask).count("1")
        return torch.tensor(plan_of_mask(mask, cfg.num_passes), dtype=torch.int32,
                            device=keys.device)
    words = torch.empty(2, dtype=torch.uint32, device=keys.device)
    plan = torch.empty(cfg.num_passes, dtype=torch.int32, device=keys.device)
    launch("grs_key_bits", keys, keys.data_ptr(), keys.numel(), words.data_ptr(),
           plan.data_ptr(), cfg.num_passes, cfg.radix_bits, skipped.data_ptr())
    key_bits.launches += 1
    return plan


class SortArgs(NamedTuple):
    """A fused sort's per-call inputs: the host tuple its argument block on the card holds.

    ``keys``: the padded input keys, 1-D uint32; ``idx``: the input index,
    of the same length, or None where the sort makes it (element e's index
    e); ``result``: the (keys, idx) buffers of the sort's result R, or
    (None, None) for a launch that writes none; ``length``: the live rows,
    0 to the padded length.  The input's rows from ``length`` on are pad
    rows, read as PAD_KEY with index PAD_INDEX whatever they hold.
    """

    keys: torch.Tensor
    idx: torch.Tensor | None
    result: tuple
    length: int


ARGS_WORDS = 5  # int64 words of the block: csrc/warp.cuh's SortArgs


def check_length(length: int | None, keys: torch.Tensor) -> int:
    """A sort's live length, all of ``keys`` where None; raises outside 0..keys.numel()."""
    length = keys.numel() if length is None else int(length)
    if not 0 <= length <= keys.numel():
        raise ValueError(f"length {length} is not within the {keys.numel()} padded keys")
    return length


def _check_args(args: SortArgs) -> None:
    _check_keys(args.keys)
    check_length(args.length, args.keys)
    for t in (args.idx, *args.result):
        if t is not None and (t.dtype != torch.uint32 or t.shape != args.keys.shape
                              or t.device != args.keys.device or not t.is_contiguous()):
            raise ValueError(f"a sort's index and result must be contiguous torch.uint32 of "
                             f"shape {tuple(args.keys.shape)} on {args.keys.device}")


def check_block(block: torch.Tensor, like: torch.Tensor) -> None:
    """Check an argument block for a sort of ``like``'s device."""
    if (block.dtype != torch.int64 or block.shape != (ARGS_WORDS,) or block.device != like.device
            or not block.is_contiguous()):
        raise ValueError(f"block must be a sort_args block, (ARGS_WORDS,) int64 on {like.device}")


def _args_words(args: SortArgs) -> list[int]:
    """What the block holds: the input's, its index's and R's addresses (0 for none), the length."""
    return [*(data_ptr(t) or 0 for t in (args.keys, args.idx, *args.result)), args.length]


def sort_args(args: SortArgs, block: torch.Tensor | None = None,
              impl: str | None = None) -> torch.Tensor:
    """A fused sort's argument block: (ARGS_WORDS,) int64 on the keys' device.

    On the card one launch of ``csrc/key_bits.cu``'s ``grs_sort_args``, a
    single thread, writes ``args`` into ``block`` (a new one if None) on the
    current stream: its arguments are copied at the launch, so nothing on
    the host is read later, as when a graph replays.  The plain version
    makes the same words on the host (the four addresses, 0 for a missing
    buffer, then the length) and copies them to the keys' device.
    """
    _check_args(args)
    if resolve_impl(args.keys, impl) == "reference":
        return torch.tensor(_args_words(args), dtype=torch.int64, device=args.keys.device)
    if block is None:
        block = torch.empty(ARGS_WORDS, dtype=torch.int64, device=args.keys.device)
    check_block(block, args.keys)
    launch("grs_sort_args", args.keys, block.data_ptr(),
           *(data_ptr(t) for t in (args.keys, args.idx, *args.result)), args.length,
           args.keys.numel())
    sort_args.launches += 1
    return block


sort_args.launches = 0


def live_input(keys: torch.Tensor, idx: torch.Tensor | None, length: int):
    """Plain version of how a fused sort reads its input: (keys, idx), both uint32.

    ``where(pos < length, key, PAD_KEY)`` and ``where(pos < length, index,
    PAD_INDEX)``, the index ``pos`` where ``idx`` is None: what the JAX
    package's sorts build with ``jnp.where``, ``jnp.arange`` and
    ``pad_to_tile`` before the passes.
    """
    pos = torch.arange(keys.numel(), dtype=torch.int32, device=keys.device)
    live = pos < length
    out_keys = torch.where(live, int32_bits(keys), uint32_as_int32(PAD_KEY))
    out_idx = torch.where(live, pos if idx is None else int32_bits(idx),
                          uint32_as_int32(PAD_INDEX))
    return out_keys.view(torch.uint32), out_idx.view(torch.uint32)


class SortPlan(NamedTuple):
    """A fused sort's plan and digit bases on its keys' device, and its look-back's scratch."""

    plan: torch.Tensor  # (num_passes,) int32, as pass_plan's
    counts: torch.Tensor  # (num_passes, radix) int32: keys whose digit p is r, pads included
    bases: torch.Tensor  # (num_passes, radix) int32: counts[p, :r].sum()
    lookback: torch.Tensor  # int32: the look-back's status words and tickets


LOOKBACK_PARTITION = 4096  # keys a look-back block takes (csrc/bucketize_scatter.cu)


def lookback_partitions(padded: int) -> int:
    """Partitions of a look-back pass over ``padded`` keys; the last may be ragged."""
    return -(-padded // LOOKBACK_PARTITION)


def lookback_words(num_tiles: int, cfg: EngineConfig) -> int:
    """int32 words of a fused sort's look-back scratch (``csrc/bucketize_scatter.cu``).

    A 64-bit status word a (partition, digit), which every pass reuses (its
    tag names the pass), then a ticket a pass.
    """
    return 2 * lookback_partitions(num_tiles * cfg.tile) * cfg.radix + cfg.num_passes


# int32 words in which csrc/key_bits.cu sums the counts: a 128-byte line a
# counter, and one for the AND, the OR and the blocks that finished.
COUNT_LINES = (128 + 1) * 32


def state_layout(num_tiles: int, cfg: EngineConfig) -> dict:
    """Where ``sort_plan``'s one int32 allocation keeps each part on the card.

    The AND and OR words, the plan, the bases (which ``csrc/key_bits.cu``
    writes after the plan), then, 8-byte aligned, what its memset clears:
    the counts, the lines it sums them in and the look-back's scratch.
    Slices of int32 words, and the total.
    """
    passes, table = cfg.num_passes, cfg.num_passes * cfg.radix
    head = 2 + passes + table
    counts = head + head % 2
    lines = counts + table
    lookback = lines + COUNT_LINES
    total = lookback + lookback_words(num_tiles, cfg)
    return {"words": slice(0, 2), "plan": slice(2, 2 + passes), "bases": slice(2 + passes, head),
            "counts": slice(counts, lines), "lines": slice(lines, lookback),
            "lookback": slice(lookback, total), "total": total}


def _digit_counts_ref(keys: torch.Tensor, cfg: EngineConfig) -> torch.Tensor:
    """Plain version: every pass's digit counts over the keys, one bincount a pass."""
    return torch.stack([
        torch.bincount(digits_of(keys, p * cfg.radix_bits, cfg.radix), minlength=cfg.radix)
        for p in range(cfg.num_passes)]).to(torch.int32)


def _digit_bases_ref(counts: torch.Tensor) -> torch.Tensor:
    """Plain version: each pass's exclusive prefix of its digit counts."""
    wide = counts.to(torch.int64)
    return (torch.cumsum(wide, dim=1) - wide).to(torch.int32)


def sort_plan(keys: torch.Tensor, cfg: EngineConfig, skipped: torch.Tensor,
              impl: str | None = None, length: int | None = None,
              block: torch.Tensor | None = None) -> SortPlan:
    """The pass plan of a fused sort of the padded ``keys``, its digit counts and bases.

    ``keys``: a padded buffer (a whole number of tiles), digits of 1, 2 or 4
    bits; its rows from ``length`` (all of them by default) on are pad
    rows, counted as PAD_KEY whatever they hold.  Reads the live keys once
    for the plan (``pass_plan``'s of the re-padded buffer, whose skipped
    passes it adds to ``skipped`` alike) and for every pass's digit counts,
    then writes each pass's bases, and clears the look-back's scratch for a
    sort's passes, each of which it serves once.  On the card one memset and
    one launch of ``csrc/key_bits.cu`` and nothing read back; the kernel
    reads the keys' address and the length from ``block``, the sort's
    argument block of them (``sort_args``), which this call writes itself
    (one more launch) where it is None.
    """
    num_tiles = check_keys("keys", keys, cfg)
    length = check_length(length, keys)
    if cfg.radix_bits not in (1, 2, 4):
        raise ValueError("sort_plan counts digits of 1, 2 or 4 bits")
    if skipped.dtype != torch.int64 or skipped.shape != (1,) or skipped.device != keys.device:
        raise ValueError(f"skipped must be an int64 tensor of shape (1,) on {keys.device}")
    passes, radix = cfg.num_passes, cfg.radix
    if resolve_impl(keys, impl) == "reference":
        keys, _ = live_input(keys, None, length)
        counts = _digit_counts_ref(keys, cfg)
        return SortPlan(pass_plan(keys, cfg, skipped, impl="reference"), counts,
                        _digit_bases_ref(counts),
                        torch.zeros(lookback_words(num_tiles, cfg), dtype=torch.int32,
                                    device=keys.device))
    if block is None:
        block = sort_args(SortArgs(keys, None, (None, None), length))
    check_block(block, keys)
    at = state_layout(num_tiles, cfg)
    state = torch.empty(at["total"], dtype=torch.int32, device=keys.device)
    launch("grs_sort_plan", keys, block.data_ptr(), keys.numel(), state.data_ptr(),
           state[at["plan"]].data_ptr(), passes, cfg.radix_bits, skipped.data_ptr(),
           state[at["counts"].start:].data_ptr(), 4 * (at["total"] - at["counts"].start))
    sort_plan.launches += 1
    return SortPlan(state[at["plan"]], state[at["counts"]].view(passes, radix),
                    state[at["bases"]].view(passes, radix), state[at["lookback"]])


sort_plan.launches = 0
