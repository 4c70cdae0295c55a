"""The AND and the OR of every key: which bits of a key buffer vary.

The fused sort's constant-digit skip (``ops/sort.py``).  The JAX package
decides in every pass, on the device, whether the pass's digit has one value
over the whole padded buffer (a ``lax.cond`` in
``gpuradixsort_tpu/ops/sort.py::_fused_pass``); it has no Pallas kernel for
it.  Passes only permute the keys, so the AND and the OR of the keys before
the first pass answer it for every pass at once.  On a CUDA tensor
``key_bits`` launches ``csrc/key_bits.cu``; on a CPU tensor it runs the plain
version, which reduces one bit plane at a time (PyTorch has no bitwise
reduction).
"""

from __future__ import annotations

import torch

from gpuradixsort_tpu_torch.config import resolve_impl
from gpuradixsort_tpu_torch.core.table import int32_bits, wrap_int32
from gpuradixsort_tpu_torch.kernels._build import launch


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
    if keys.dtype != torch.uint32 or keys.dim() != 1 or not keys.is_contiguous():
        raise ValueError(
            f"keys must be a contiguous 1-D torch.uint32 tensor, got {keys.dtype} of "
            f"shape {tuple(keys.shape)}"
        )
    if resolve_impl(keys, impl) == "reference":
        return _key_bits_ref(keys)
    out = torch.empty(2, dtype=torch.uint32, device=keys.device)
    launch("grs_key_bits", keys, keys.data_ptr(), keys.numel(), out.data_ptr())
    key_bits.launches += 1
    return out


key_bits.launches = 0
