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
"""

from __future__ import annotations

import torch

from gpuradixsort_tpu_torch.config import EngineConfig, resolve_impl
from gpuradixsort_tpu_torch.core.table import int32_bits, wrap_int32
from gpuradixsort_tpu_torch.kernels._build import launch
from gpuradixsort_tpu_torch.kernels.radix import INPUT, PLAN_SKIP, RESULT, SCRATCH, plan_entry


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
    launch("grs_key_bits", keys, keys.data_ptr(), keys.numel(), out.data_ptr(), None, 0, 0,
           None)
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
