"""Helpers of the plain references: uint32 columns moved through int32 bits."""

from __future__ import annotations

import numpy as np
import torch


def wide(t: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer column as int64 values (uint32 unsigned)."""
    if t.dtype == torch.uint32:
        return t.view(torch.int32).long() & 0xFFFFFFFF
    return t.long()


def pick(t: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """t[index]; PyTorch gathers no uint32 on the CPU, so uint32 moves as int32 bits."""
    if t.dtype == torch.uint32:
        return t.view(torch.int32)[index].view(torch.uint32)
    return t[index]


def by_key(keys: torch.Tensor, size: int) -> torch.Tensor:
    """The row of each key in 0..size-1 (int64), -1 where no row has it."""
    k = wide(keys)
    out = torch.full((size,), -1, dtype=torch.int64, device=k.device)
    out[k] = torch.arange(k.shape[0], device=k.device)
    return out


def host(columns: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """Columns on the host as numpy arrays, uint32 kept uint32."""
    out = {}
    for name, t in columns.items():
        if t.dtype == torch.uint32:
            out[name] = t.view(torch.int32).cpu().numpy().view(np.uint32)
        else:
            out[name] = t.cpu().numpy()
    return out
