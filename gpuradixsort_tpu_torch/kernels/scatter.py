"""Scatter runs: the global stable scatter of the bucketized tiles.

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
"""

from __future__ import annotations

import torch

from gpuradixsort_tpu_torch.config import EngineConfig, resolve_impl
from gpuradixsort_tpu_torch.core.table import int32_bits
from gpuradixsort_tpu_torch.kernels._build import launch
from gpuradixsort_tpu_torch.kernels.radix import check_keys, check_plan, data_ptr, planned_source


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


def scatter_runs(
    bk: torch.Tensor,
    bi: torch.Tensor,
    hist: torch.Tensor,
    offsets: torch.Tensor,
    cfg: EngineConfig,
    impl: str | None = None,
    plan: torch.Tensor | None = None,
    pass_index: int = 0,
    result: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, torch.Tensor, bool]:
    """Scatter bucketized tiles to their global stable positions.

    bk, bi: (num_tiles * tile,) uint32, each tile digit-major.  hist,
    offsets: (num_tiles, radix) int32 per-tile counts and global offsets
    (``global_offsets``).  Returns (keys, indices, overflow=False).

    With ``plan`` the call is pass ``pass_index`` of a fused sort: the pass
    writes the sort's result buffer ``result`` (also where the pass read it:
    bucketize has already copied it into bk, bi), or, where the plan skips
    it, writes nothing; it returns ``result``.
    """
    num_tiles = check_keys("bk", bk, cfg)
    check_keys("bi", bi, cfg)
    for name, t in (("hist", hist), ("offsets", offsets)):
        shape = (num_tiles, cfg.radix)
        if t.dtype != torch.int32 or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"{name} must be contiguous int32 of shape {shape}, got "
                f"{t.dtype} of shape {tuple(t.shape)}"
            )
    if any(t.device != bk.device for t in (bi, hist, offsets)):
        raise ValueError("bk, bi, hist and offsets must be on one device")
    if plan is not None:
        check_plan(plan, pass_index, bk, result or (None,))
    if resolve_impl(bk, impl) == "reference":
        if plan is None:
            return (*_scatter_runs_ref(bk, bi, hist, offsets, cfg), False)
        if planned_source(plan, pass_index, (bk, bi)) is not None:  # the pass runs
            for dst, src in zip(result, _scatter_runs_ref(bk, bi, hist, offsets, cfg)):
                dst.copy_(src)
        return (*result, False)
    out_keys, out_idx = result if plan is not None else (torch.empty_like(bk), torch.empty_like(bi))
    launch(
        "grs_scatter_runs", bk, bk.data_ptr(), bi.data_ptr(), hist.data_ptr(),
        offsets.data_ptr(), out_keys.data_ptr(), out_idx.data_ptr(), num_tiles,
        cfg.tile, cfg.radix, data_ptr(plan), pass_index,
    )
    scatter_runs.launches += 1
    return out_keys, out_idx, False


scatter_runs.launches = 0
