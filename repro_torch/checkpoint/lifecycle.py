"""Device-lifecycle checkpointing (DESIGN.md §16); port of the JAX
package's ``checkpoint/lifecycle.py`` whose one change is the reference
tree's leaves: the store's :class:`~.store.ShapeDtype` in place of
JAX's shape/dtype struct.

Round-trips the churn plane's state through the flat pytree store: the
per-device lifecycle codes (``DeviceLifecycle.value`` — the enum's
integer values ARE the wire encoding, never reorder them), the derived
alive mask, and the task ids of orphans whose recovery was still pending
when the snapshot was cut.  A restore mid-drain therefore resumes
recovery instead of silently forgetting the orphans: the driver gets the
pending ids back and re-runs its settle pass.

The tree rides the same ``store.save``/``store.restore`` machinery as
every other checkpoint, so shapes are always validated and dtypes refuse
to cast unless the caller opts in — a truncated mask or a float-smuggled
code array fails loudly, leaf-named.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np

from ..core.calendar import DeviceLifecycle, NetworkState
from . import store
from .store import ShapeDtype

_CODES = np.array([m.value for m in DeviceLifecycle], dtype=np.int8)
_UP = np.int8(DeviceLifecycle.UP.value)


def lifecycle_tree(state: NetworkState,
                   pending_orphans: Sequence[int] = ()) -> dict[str, Any]:
    """Build the checkpoint pytree for ``state``'s lifecycle plane."""
    return {
        "alive_mask": state.alive_mask(),
        "lifecycle": state.lifecycle_codes(),
        "pending_orphans": np.asarray(sorted(pending_orphans),
                                      dtype=np.int64),
    }


def lifecycle_reference(n_devices: int, n_orphans: int) -> dict[str, Any]:
    """Shape/dtype skeleton ``store.restore`` validates against."""
    return {
        "alive_mask": ShapeDtype((n_devices,), np.bool_),
        "lifecycle": ShapeDtype((n_devices,), np.int8),
        "pending_orphans": ShapeDtype((n_orphans,), np.int64),
    }


def save_lifecycle(path: str, state: NetworkState,
                   pending_orphans: Sequence[int] = (),
                   metadata: Optional[dict] = None) -> None:
    """Snapshot the lifecycle plane (+ pending orphan ids) at ``path``.

    ``n_devices``/``n_orphans`` land in the manifest metadata so a
    restore can size its reference tree without out-of-band knowledge.
    """
    tree = lifecycle_tree(state, pending_orphans)
    meta = dict(metadata or {})
    meta.update({
        "kind": "device_lifecycle",
        "n_devices": len(state.devices),
        "n_orphans": int(tree["pending_orphans"].shape[0]),
    })
    store.save(path, tree, metadata=meta)


def restore_lifecycle(path: str, state: NetworkState) -> list[int]:
    """Apply a lifecycle snapshot onto ``state``; returns the pending
    orphan task ids the driver must resume recovering.

    Validation beyond the store's shape/dtype checks: the snapshot must
    be a lifecycle checkpoint for a fleet of ``state``'s size, every
    code must be a known :class:`DeviceLifecycle` value, and the stored
    alive mask must agree with the codes (a disagreement means the
    payload was edited or torn — refuse rather than guess).
    """
    meta = store.load_metadata(path)
    if meta.get("kind") != "device_lifecycle":
        raise ValueError(
            f"{path}: not a device-lifecycle checkpoint "
            f"(kind={meta.get('kind')!r})")
    n_devices = meta.get("n_devices")
    if n_devices != len(state.devices):
        raise ValueError(
            f"{path}: checkpoint is for {n_devices} devices, state has "
            f"{len(state.devices)}")
    ref = lifecycle_reference(len(state.devices),
                              int(meta.get("n_orphans", 0)))
    tree = store.restore(path, ref)
    codes = tree["lifecycle"]
    if not np.isin(codes, _CODES).all():
        bad = sorted(set(codes.tolist()) - set(_CODES.tolist()))
        raise ValueError(f"{path}: unknown lifecycle codes {bad}")
    if not np.array_equal(tree["alive_mask"], codes == _UP):
        raise ValueError(
            f"{path}: alive_mask disagrees with lifecycle codes")
    state.apply_lifecycle_codes(codes)
    return tree["pending_orphans"].tolist()
