"""Bridge from the JAX package's trees to the port's: a param or cache tree
as nested dicts of numpy arrays (``jax.tree.map(np.asarray, tree)``)
becomes the same tree of torch tensors, key for key."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _tensor(a, device: torch.device,
            dtype: Optional[torch.dtype]) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":       # numpy has no bf16: go via f32
        t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def _convert(tree, device, dtype):
    if isinstance(tree, dict):
        return {k: _convert(v, device, dtype) for k, v in tree.items()}
    return _tensor(tree, device, dtype)


def params_from_numpy(tree: dict, device: str | torch.device,
                      dtype: Optional[torch.dtype] = None) -> dict:
    """Param tree of numpy arrays -> tensors on ``device``; ``dtype`` casts
    the floating leaves."""
    return _convert(tree, torch.device(device), dtype)


def caches_from_numpy(tree: dict, device: str | torch.device) -> dict:
    """Cache tree of numpy arrays (K/V and int32 slot positions) -> tensors
    on ``device`` in their own dtypes."""
    return _convert(tree, torch.device(device), None)
