"""Exclusive prefix scan of a 1-D int32 vector, with its total.

The PyTorch counterpart of ``gpuradixsort_tpu/kernels/scan.py``.  On a CUDA
tensor ``exclusive_scan`` launches ``csrc/scan.cu``, one pass with decoupled
look-back; on a CPU tensor it runs the plain version, a cumsum.  Sums wrap
modulo 2^32, as int32 sums do in ``jnp.cumsum``.

The JAX package zero-pads the input to a whole tile for its grid.  Zeros
change neither the scan nor the total, so the CUDA kernel masks its ragged
edge instead and reads nothing past ``n``.

The look-back's scratch (a chunk counter and one status word a chunk) comes
in the output's allocation; the kernel's entry point clears it on the stream
before each launch, so calls share no state, also on several streams or
under CUDA graph capture.
"""

from __future__ import annotations

import torch

from gpuradixsort_tpu_torch.config import resolve_impl
from gpuradixsort_tpu_torch.core.table import wrap_int32
from gpuradixsort_tpu_torch.kernels._build import launch

# Elements a block of csrc/scan.cu scans, which checks it: the scratch is sized by it.
CHUNK = 8192


def scratch_words(n: int) -> int:
    """64-bit scratch words a length-n scan needs: the chunk counter, then a status word a chunk."""
    return -(-n // CHUNK) + 1


def _exclusive_scan_ref(x: torch.Tensor):
    """Plain version: an int64 cumsum, wrapped back to int32."""
    wide = x.to(torch.int64)
    incl = torch.cumsum(wide, dim=0)
    return wrap_int32(incl - wide), wrap_int32(incl[-1])


def exclusive_scan(
    x: torch.Tensor, impl: str | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exclusive prefix scan of a 1-D integer tensor.

    Returns ``(scan, total)``: int32 ``scan[i] = sum(x[:i])`` and the 0-d
    int32 grand total, on ``x``'s device.  Any length works.  The JAX
    package's ``cfg`` sets its tile padding only, so the port takes none.
    """
    if x.dim() != 1 or x.dtype.is_floating_point or x.dtype == torch.bool:
        raise ValueError(f"x must be a 1-D integer tensor, got {x.dtype} of shape "
                         f"{tuple(x.shape)}")
    impl = resolve_impl(x, impl)
    n = x.shape[0]
    if n == 0:
        return (torch.zeros(0, dtype=torch.int32, device=x.device),
                torch.zeros((), dtype=torch.int32, device=x.device))
    if impl == "reference":
        return _exclusive_scan_ref(x)
    x = x.to(torch.int32).contiguous()
    # One allocation: the scan and the total, padded to 8 bytes, then the scratch.
    head = (n + 2) // 2 * 2
    out = torch.empty(head + 2 * scratch_words(n), dtype=torch.int32, device=x.device)
    launch("grs_exclusive_scan", x, x.data_ptr(), out.data_ptr(), n, CHUNK,
           out[head:].data_ptr())
    exclusive_scan.launches += 1
    return out[:n], out[n]


exclusive_scan.launches = 0
