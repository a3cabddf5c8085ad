"""Tree checkpointing: flat .npz payload + JSON manifest (port of the JAX
package's ``checkpoint/store.py``, in the same on-disk format).

Leaves are addressed by the JAX key-path string of their dict path
(``"['dec0']['p0']['mixer']['wq']"``, ``"['m']['embed']"``, ``"['step']"``),
flattened in the JAX order (sorted dict keys), so a checkpoint of either
package loads in the other.  A tree is nested dicts, lists or tuples of
torch tensors or numpy arrays.  A bfloat16 tensor is written as the JAX
store writes a bfloat16 array: its raw 2-byte words (numpy ``|V2``) with
``"bfloat16"`` in the manifest; and, as there, such a leaf does not
restore (``|V2`` is not bfloat16, and there is no cast from it).

Durability contract (the JAX store's):

* ``save`` stages the payload and manifest in a temporary sibling
  directory and swaps it into place with ``os.replace``, so an
  interrupted save can never leave a torn checkpoint at ``path``.  The
  overwrite path briefly parks the previous checkpoint at
  ``<path>.old.<pid>`` between two renames; a failed swap rolls it back.
* ``restore`` refuses dtype mismatches by default, naming the leaf; pass
  ``cast=True`` to convert every leaf to the reference dtype.  Shapes are
  always validated.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, NamedTuple, Optional

import numpy as np
import torch


class ShapeDtype(NamedTuple):
    """A leaf's shape and numpy dtype without its data: a reference leaf
    for :func:`restore`, as ``jax.ShapeDtypeStruct`` is for the JAX
    store."""

    shape: tuple
    dtype: Any


def _flatten_with_path(tree: Any, path: str = ""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten_with_path(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)) and not isinstance(tree,
                                                            ShapeDtype):
        for i, v in enumerate(tree):
            yield from _flatten_with_path(v, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def _dtype_name(leaf: Any) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return str(np.dtype(leaf.dtype))


def _to_numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:       # raw 2-byte words, as numpy
            return t.view(torch.int16).numpy().view(np.dtype("V2"))
        return t.numpy()
    return np.asarray(leaf)


def _flatten(tree: Any) -> tuple[dict[str, np.ndarray], dict[str, str]]:
    flat, names = {}, {}
    for key, leaf in _flatten_with_path(tree):
        flat[key] = _to_numpy(leaf)
        names[key] = _dtype_name(leaf)
    return flat, names


def _pid_alive(pid: int) -> bool:
    """Whether the pid a litter suffix names still runs (own pid counts)."""
    if pid == os.getpid():
        return True
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True         # exists, owned by someone else
    return True


def save(path: str, tree: Any, metadata: Optional[dict] = None) -> None:
    """Write the checkpoint via a staged temp dir + ``os.replace`` swap
    (see the module docstring for the exact durability guarantees)."""
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    # clear litter an earlier pid's interrupted save may have left beside
    # this checkpoint, only from pids no longer alive, and a parked .old
    # sibling only once a complete checkpoint exists at path
    base = os.path.basename(path)
    for entry in os.listdir(parent) if os.path.isdir(parent) else ():
        stale_tmp = entry.startswith(f"{base}.tmp.")
        stale_old = entry.startswith(f"{base}.old.") and os.path.isdir(path)
        suffix = entry.rsplit(".", 1)[-1]
        # only suffixes that are literal pids are our litter
        if (stale_tmp or stale_old) and suffix.isdigit() and \
                not _pid_alive(int(suffix)):
            shutil.rmtree(os.path.join(parent, entry), ignore_errors=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    try:
        flat, names = _flatten(tree)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        manifest = {
            "leaves": {
                k: {"shape": list(v.shape), "dtype": names[k]}
                for k, v in flat.items()
            },
            "metadata": metadata or {},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        if os.path.isdir(path):
            # os.replace cannot overwrite a non-empty directory: park the
            # old checkpoint aside, swap the new one in, then drop the old;
            # roll the previous one back if the swap fails
            old = f"{path}.old.{os.getpid()}"
            if os.path.isdir(old):
                shutil.rmtree(old)
            os.replace(path, old)
            try:
                os.replace(tmp, path)
            except BaseException:
                os.replace(old, path)           # roll back the previous
                raise
            shutil.rmtree(old)
        else:
            os.replace(tmp, path)
    finally:
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)


def load_metadata(path: str) -> dict:
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)["metadata"]


def _restore_leaf(key: str, arr: np.ndarray, ref: Any, cast: bool):
    if tuple(arr.shape) != tuple(ref.shape):
        raise ValueError(
            f"{key}: checkpoint shape {arr.shape} != expected "
            f"{tuple(ref.shape)}")
    want = _dtype_name(ref)
    if arr.dtype.kind == "V" or str(arr.dtype) != want:
        if not cast:
            raise ValueError(
                f"{key}: checkpoint dtype {arr.dtype} != expected {want} "
                "(pass cast=True to convert explicitly)")
        if arr.dtype.kind == "V":           # raw words: numpy cannot cast
            raise ValueError("No cast function available.")
    if not isinstance(ref, torch.Tensor):
        return arr.astype(np.dtype(ref.dtype)) if cast else arr
    out = torch.from_numpy(np.array(arr, copy=True))
    return out.to(device=ref.device, dtype=ref.dtype)


def restore(path: str, reference: Any, *, cast: bool = False) -> Any:
    """Restore into the structure of ``reference`` (a tree of tensors,
    numpy arrays or :class:`ShapeDtype`).  Tensor leaves restore to tensors
    on the reference leaf's device, the others to numpy arrays.  Shape
    mismatches always raise; dtype mismatches raise a ``ValueError`` naming
    the leaf unless ``cast=True`` explicitly opts into converting leaves to
    the reference dtypes."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    data = np.load(os.path.join(path, "arrays.npz"))

    def build(ref: Any, prefix: str):
        if isinstance(ref, dict):
            return {k: build(ref[k], f"{prefix}[{k!r}]") for k in sorted(ref)}
        if isinstance(ref, (list, tuple)) and not isinstance(ref,
                                                             ShapeDtype):
            return type(ref)(build(v, f"{prefix}[{i}]")
                             for i, v in enumerate(ref))
        if ref is None:
            return None
        if prefix not in manifest["leaves"]:
            raise KeyError(f"checkpoint missing leaf {prefix}")
        return _restore_leaf(prefix, data[prefix], ref, cast)

    return build(reference, "")


def exists(path: str) -> bool:
    return os.path.exists(os.path.join(path, "manifest.json"))
