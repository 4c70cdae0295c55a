"""Engine-wide configuration: tile geometry, digit width and sentinels.

The PyTorch counterpart of ``gpuradixsort_tpu/config.py``.  The layout
constants are kept although the GPU kernels need no (8, 128) tiling: padded
lengths and per-tile tables must line up with the JAX package's so that the
parity tests compare buffers of one length.

Kernel dispatch follows the tensor's device: a CUDA tensor goes to the
hand-written CUDA kernel, a CPU tensor to the plain PyTorch version.  Each
kernel wrapper also takes ``impl="cuda"`` or ``impl="reference"`` so that
tests and ``chip_smoke.py`` can hold a kernel against its plain version on
the same card.  No environment switch can route a CUDA tensor to the plain
version.

Host values (numpy arrays, lists) and the entry points go to the CUDA card
unless the caller passes ``device="cpu"`` (``default_device``); without a
card they raise rather than run on the CPU.
"""

from __future__ import annotations

import dataclasses

import torch

# Minor dimension of the JAX package's (rows, 128) view of every buffer.  A
# tile is ``tile_rows * LANES`` contiguous elements of the 1-D buffer.
LANES = 128

# Tiles per Pallas grid step in the JAX package; buffers are padded to this
# many tiles (``EngineConfig.block``).
TILES_PER_STEP = 8

# Sentinel key for pad rows: sorts after every live key.
PAD_KEY = 0xFFFFFFFF

# Sentinel original-row index carried by pad rows.
PAD_INDEX = 0xFFFFFFFF

IMPLS = ("cuda", "reference")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Tile geometry and radix parameters shared by host code and kernels."""

    # Digit width per radix pass.  4 -> 16 buckets, 8 passes for uint32 keys.
    radix_bits: int = 4
    # Rows of 128 elements per tile.  tile = tile_rows * LANES elements.
    tile_rows: int = 8
    # Sort key bit-width.
    key_bits: int = 32

    def __post_init__(self):
        if self.key_bits % self.radix_bits != 0:
            raise ValueError(
                f"radix_bits={self.radix_bits} must divide key_bits={self.key_bits}"
            )
        if self.radix_bits not in (1, 2, 4, 8):
            raise ValueError("radix_bits must be one of (1, 2, 4, 8)")
        if self.tile_rows < 1:
            raise ValueError("tile_rows must be >= 1")

    @property
    def radix(self) -> int:
        """Number of digit buckets per pass (2**radix_bits)."""
        return 1 << self.radix_bits

    @property
    def tile(self) -> int:
        """Elements per tile: one CUDA block's share of the buffer."""
        return self.tile_rows * LANES

    @property
    def block(self) -> int:
        """Padding granularity, equal to the JAX package's grid step."""
        return self.tile * TILES_PER_STEP

    @property
    def num_passes(self) -> int:
        """LSD passes needed to cover the full key width."""
        return self.key_bits // self.radix_bits


DEFAULT_CONFIG = EngineConfig()

# 1 bit per pass, 32 passes: the closest analog of the reference's pipeline,
# kept as a cross-check oracle.
REFERENCE_PARITY_CONFIG = EngineConfig(radix_bits=1)


def config_from_jax(cfg) -> EngineConfig:
    """The port's EngineConfig for a ``gpuradixsort_tpu`` EngineConfig."""
    return EngineConfig(
        radix_bits=cfg.radix_bits, tile_rows=cfg.tile_rows, key_bits=cfg.key_bits
    )


def default_device(device=None) -> torch.device:
    """``device`` if the caller gave one, else the current CUDA card.

    Raises when no device is given and there is no card: the port runs on
    the CPU only when asked (``device="cpu"``), never as a quiet fall-back.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card: pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())


def resolve_impl(t: torch.Tensor, impl: str | None) -> str:
    """Pick a kernel implementation for a tensor.

    ``None`` follows the device: ``"cuda"`` for a CUDA tensor, ``"reference"``
    (the plain PyTorch version) for a CPU tensor.  ``"cuda"`` on a tensor
    that is not on a CUDA device raises; there is no fall-back.
    """
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    if impl is None:
        return "cuda" if t.is_cuda else "reference"
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "cuda" and not t.is_cuda:
        raise ValueError(f"impl='cuda' needs a CUDA tensor, got one on {t.device}")
    return impl
