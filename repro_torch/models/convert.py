"""Bridge from the JAX package's trees to the port's: a param or cache tree
as nested dicts of numpy arrays (``jax.tree.map(np.asarray, tree)``)
becomes the same tree of torch tensors, key for key."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _tensor(a) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":       # numpy has no bf16: go via f32
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


# Leaves the JAX package makes in float32 whatever the param dtype: the
# mLSTM gate projections and biases, the MoE ``router``, Mamba's ``a_log``,
# and the sLSTM bias ``b`` (the mixer that also holds the recurrent ``r``).
_F32_LEAVES = frozenset({"w_i", "w_f", "b_i", "b_f", "router", "a_log"})


def _f32_by_design(parent: dict, key: str) -> bool:
    return key in _F32_LEAVES or (key == "b" and "r" in parent)


def _cast(tree: dict, dtype: torch.dtype) -> dict:
    return {k: _cast(v, dtype) if isinstance(v, dict)
            else v if not v.is_floating_point() or _f32_by_design(tree, k)
            else v.to(dtype)
            for k, v in tree.items()}


def params_from_numpy(tree: dict, device: str | torch.device,
                      dtype: Optional[torch.dtype] = None) -> dict:
    """Param tree of numpy arrays -> tensors on ``device``.  ``dtype`` casts
    every floating leaf but those the JAX package keeps in float32 by design
    (xLSTM's ``w_i``, ``w_f``, ``b_i``, ``b_f`` and the sLSTM bias ``b``,
    the MoE ``router``, Mamba's ``a_log``), whatever the source tree's
    dtype."""
    dev = torch.device(device)
    out = _map(tree, _tensor)
    if dtype is not None:
        out = _cast(out, dtype)
    return _map(out, lambda t: t.to(dev))


def caches_from_numpy(tree: dict, device: str | torch.device) -> dict:
    """Cache tree of numpy arrays (K/V and int32 slot positions) -> tensors
    on ``device`` in their own dtypes."""
    dev = torch.device(device)
    return _map(tree, lambda a: _tensor(a).to(dev))


def opt_state_from_numpy(tree: dict, device: str | torch.device) -> dict:
    """The JAX optimizer state as numpy ({"m", "v": trees like the params,
    in the moment dtype; "step": int32 scalar}) -> tensors on ``device``,
    key for key, each in its own dtype."""
    dev = torch.device(device)
    return _map(tree, lambda a: _tensor(a).to(dev))
