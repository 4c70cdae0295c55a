"""The join's probe: each probe key's place among the build side's sorted keys, ``join_probe``.

Replaces no Pallas kernel: the JAX package's ``join`` probes with
``jnp.searchsorted``, clips the positions and compares the build key at
each (``gpuradixsort_tpu/ops/join.py``).  On CUDA tensors ``join_probe``
launches ``csrc/join_probe.cu`` once: it reads the uint32 keys as they lie,
searches only the rows below the probe's live length (rounded up to a tile
of ``TILE_ROWS``), and writes the int32 positions and the int32 keep mask
together.  The rows past the live length are searched as PAD_KEY and are
pads: their position is the clipped lower bound of PAD_KEY, their keep 0,
written with no read of the key.  On CPU tensors it runs the plain version,
``_join_probe_ref``: ``torch.searchsorted`` of int64-widened keys over the
live rows only, and the pad values past them.
"""

from __future__ import annotations

import torch

from gpuradixsort_tpu_torch.config import PAD_KEY, resolve_impl
from gpuradixsort_tpu_torch.core.table import wide_keys
from gpuradixsort_tpu_torch.kernels._build import launch

TILE_ROWS = 2048  # rows the kernel walks at a time: csrc/join_probe.cu's kTileRows
KEY_DTYPES = (torch.uint32, torch.int32)


def walked_rows(live: int, n: int) -> int:
    """The rows of an ``n``-row probe of ``live`` live rows that the kernel searches."""
    return min(-(-live // TILE_ROWS) * TILE_ROWS, n)


def probe_bytes(n: int, live: int, nb: int, positions: bool = True) -> int:
    """The probe's HBM bytes: the live keys read, keep (and pos) written, the build keys read."""
    out = 4 + 4 * positions
    return live * 4 + n * out + nb * 4


def _check(keys: torch.Tensor, live: int, build: torch.Tensor) -> None:
    for name, t in (("keys", keys), ("build", build)):
        if t.dim() != 1 or t.dtype not in KEY_DTYPES:
            raise ValueError(f"{name} must be 1-D uint32 (or its int32 view), got {t.dtype} of "
                             f"shape {tuple(t.shape)}")
    if build.device != keys.device:
        raise ValueError(f"build lies on {build.device}, keys on {keys.device}")
    if not 0 <= live <= keys.numel():
        raise ValueError(f"live must lie in [0, {keys.numel()}], got {live}")
    if build.numel() > 2**31 - 1:
        raise ValueError(f"a build side of {build.numel()} keys is more than int32 positions "
                         "can name")


def _join_probe_ref(keys: torch.Tensor, live: int, build: torch.Tensor, positions: bool,
                    negate: bool) -> tuple[torch.Tensor | None, torch.Tensor]:
    """The plain version: ``torch.searchsorted`` of the live rows, the pad values past them."""
    n, nb = keys.numel(), build.numel()
    dev = keys.device
    bkeys = wide_keys(build)
    pkeys = wide_keys(keys[:live])
    pad = torch.tensor([PAD_KEY], dtype=torch.int64, device=dev)
    found = torch.searchsorted(bkeys, torch.cat([pkeys, pad]), side="left")
    safe = found.clamp(0, max(nb - 1, 0))
    if nb:
        matched = (found[:live] < nb) & (bkeys[safe[:live]] == pkeys)
    else:
        matched = torch.zeros(live, dtype=torch.bool, device=dev)
    keep = torch.zeros(n, dtype=torch.int32, device=dev)
    keep[:live] = matched != negate
    if not positions:
        return None, keep
    pos = torch.empty(n, dtype=torch.int32, device=dev)
    pos[:live] = safe[:live].to(torch.int32)
    pos[live:] = safe[live].to(torch.int32)
    return pos, keep


def join_probe(keys: torch.Tensor, live: int, build: torch.Tensor, positions: bool = True,
               negate: bool = False, impl: str | None = None
               ) -> tuple[torch.Tensor | None, torch.Tensor]:
    """(pos, keep) of each of the ``n`` probe ``keys`` among the sorted ``build`` keys.

    ``keys``: the probe's 1-D uint32 key column (or its int32 view), ``n``
    padded rows of which the first ``live`` (a host integer) are read;
    ``build``: the build side's ``nb`` live keys, sorted ascending as
    uint32, on the same device.  Below ``live``, ``pos[i]`` is the lower
    bound of ``keys[i]`` among the build keys, clipped to ``[0, max(nb - 1,
    0)]``, and ``keep[i]`` is 1 where ``build[pos[i]] == keys[i]`` (0 where
    ``negate``, an anti join's mask).  From ``live`` on, the rows are pads:
    ``pos`` the clipped lower bound of PAD_KEY, ``keep`` 0.  Both int32 of
    ``n`` rows; ``pos`` is None unless ``positions``.

    On the card, one launch of ``csrc/join_probe.cu``.
    """
    _check(keys, live, build)
    if resolve_impl(keys, impl) == "reference":
        return _join_probe_ref(keys, live, build, positions, negate)
    n = keys.numel()
    keys, build = keys.contiguous(), build.contiguous()
    keep = torch.empty(n, dtype=torch.int32, device=keys.device)
    pos = torch.empty(n, dtype=torch.int32, device=keys.device) if positions else None
    if n:
        launch("grs_join_probe", keys, keys.data_ptr(), n, live, build.data_ptr(), build.numel(),
               pos.data_ptr() if positions else None, keep.data_ptr(), int(negate))
        join_probe.launches += 1
    return pos, keep


join_probe.launches = 0
