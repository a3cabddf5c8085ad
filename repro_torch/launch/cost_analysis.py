"""Per-device cost of one step, counted while it runs on abstract shards.

Counterpart of the JAX package's ``launch/hlo_analysis.py``.  There is no
HLO to parse here: PyTorch runs the step eagerly, so :class:`Recorder`, a
dispatch mode, sees every operation on the local shards that DTensor runs
(the dry run's tensors are ``meta``: shapes, no data) and counts, per
device:

- FLOPs: ``torch.utils.flop_counter``'s formulas on each local operation's
  shapes, under the placements DTensor chose (a replicated product costs
  every device its whole count), plus the operations that the
  hand-written kernels report from their ``meta`` branch
  (``kernels/_shard.py``);
- bytes: each non-view operation's tensor inputs read once and outputs
  written once, plus the kernels' reported bytes;
- collectives: each functional collective DTensor issues, as (kind, result
  bytes, group size), turned into wire bytes by the formulas of
  ``hlo_analysis.collective_bytes``;
- the peak of live local bytes, counted by storage (a view adds nothing),
  from the step's arguments on: an estimate, since a storage is dropped
  only when Python frees its last tensor.

The operations DTensor runs on global-shape ``meta`` tensors to propagate
shardings are skipped (they run inside ``_sharding_prop.py``).

compute term    = FLOPs / peak FLOP/s of the combo's dtype
memory term     = bytes / HBM bandwidth
collective term = wire bytes / link bandwidth

H100 SXM constants (NVIDIA's H100 datasheet, dense, no sparsity): HBM3
3.35 TB/s; 989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s f32.  The
link constant is one 400 Gb/s NIC a GPU (50 GB/s), DGX H100's network:
both production meshes span many 8-GPU nodes.  Inside a node NVLink gives
450 GB/s a direction, which a mesh laid out to keep its model axis in one
node would see instead.
"""
from __future__ import annotations

import sys
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # FLOP/s a GPU
HBM_BW = 3.35e12                                      # bytes/s a GPU
LINK_BW = 50e9                                        # bytes/s a GPU

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all")
# functional collective op name -> kind
_KIND = {"all_gather_into_tensor": "all-gather",
         "all_gather_into_tensor_out": "all-gather",
         "reduce_scatter_tensor": "reduce-scatter",
         "all_reduce": "all-reduce",
         "all_to_all_single": "all-to-all"}
# allocations: no bytes moved
_NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "wait_tensor", "detach", "alias"}


def wire_bytes(kind: str, size: float, n: int) -> float:
    """Per-device wire bytes of one collective whose result is ``size``
    bytes over a group of ``n`` (ring / bidirectional formulas)."""
    n = max(2, n)
    if kind == "all-gather":
        return size * (n - 1) / n         # result is the gathered size
    if kind == "all-reduce":
        return 2 * size * (n - 1) / n     # reduce-scatter + all-gather
    if kind == "reduce-scatter":
        return size * (n - 1)             # result is the scattered size
    if kind == "all-to-all":
        return size * (n - 1) / n
    return size                           # collective-permute


@dataclass
class CollectiveStats:
    by_kind: dict = field(default_factory=dict)   # wire bytes per kind
    count: int = 0

    @property
    def total_bytes(self) -> float:
        return sum(self.by_kind.values())


def collective_stats(records) -> CollectiveStats:
    """Wire bytes per kind of (kind, result bytes, group size) records."""
    stats = CollectiveStats()
    for kind, size, n in records:
        stats.by_kind[kind] = stats.by_kind.get(kind, 0.0) + \
            wire_bytes(kind, size, n)
        stats.count += 1
    return stats


def _in_sharding_prop() -> bool:
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.endswith("_sharding_prop.py"):
            return True
        f = f.f_back
    return False


def tensors(tree):
    """The tensors of a tree of dicts, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tensors(v)
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from tensors(v)


def _group_size(func, args) -> int:
    name = func._overloadpacket.__name__
    if name.startswith(("all_gather", "reduce_scatter")):
        return int(args[1] if name.startswith("all_gather") else args[2])
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(args[-1]).size()


class Recorder(TorchDispatchMode):
    """Counts what one device does while the block runs (see the module
    docstring).  ``live_from(tree)`` seeds the live bytes with the step's
    arguments."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flop_registry = flop_registry
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.collectives: list = []        # (kind, result bytes, group)
        self.kernels: dict = {}            # name -> [calls, flops, bytes]
        self._live: dict = {}              # storage cdata -> (ref, bytes)
        self.live_bytes = 0
        self.peak_bytes = 0

    def live_from(self, tree) -> None:
        from torch.distributed.tensor import DTensor
        for t in tensors(tree):
            self._track(t.to_local() if isinstance(t, DTensor) else t)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def kernel(self, name: str, flops: float, n_bytes: float) -> None:
        """The kernels' meta branches report here (``_shard.recording``)."""
        calls = self.kernels.setdefault(name, [0, 0.0, 0.0])
        calls[0] += 1
        calls[1] += flops
        calls[2] += n_bytes
        self.flops += flops
        self.hbm_bytes += n_bytes

    def _track(self, t: torch.Tensor) -> None:
        from torch.multiprocessing.reductions import StorageWeakRef
        st = t.untyped_storage()
        ref = StorageWeakRef(st)
        if ref.cdata not in self._live:
            n = st.nbytes()
            self._live[ref.cdata] = (ref, n)
            self.live_bytes += n

    def _prune(self) -> None:
        for key, (ref, n) in list(self._live.items()):
            if ref.expired():
                del self._live[key]
                self.live_bytes -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented          # count DTensor's local ops
        out = func(*args, **kwargs)
        if _in_sharding_prop():
            return out
        packet = func._overloadpacket
        name = packet.__name__
        kind = _KIND.get(name)
        if kind is not None:
            size = sum(t.numel() * t.element_size() for t in tensors(out))
            self.collectives.append((kind, size, _group_size(func, args)))
        if packet in self._flop_registry:
            self.flops += self._flop_registry[packet](*args, **kwargs,
                                                      out_val=out)
        if not func.is_view and name not in _NO_BYTES:
            self.hbm_bytes += sum(t.numel() * t.element_size()
                                  for t in (*tensors(args), *tensors(out)))
        self._prune()
        for t in tensors(out):
            self._track(t)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        return out


@dataclass
class Roofline:
    flops: float                 # per-device FLOPs
    hbm_bytes: float             # per-device bytes accessed
    coll_bytes: float            # per-device collective wire bytes
    chips: int
    dtype: str = "bfloat16"
    collectives: dict = field(default_factory=dict)
    n_collectives: int = 0
    model_flops: float = 0.0     # analytic 6ND-style global model FLOPs

    @property
    def compute_s(self) -> float:
        return self.flops / PEAK_FLOPS[self.dtype]

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.coll_bytes / LINK_BW

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / FLOPs (per-device basis): below 1 where the step
        does more arithmetic than the model needs (recompute, replicated
        products, dense MoE dispatch)."""
        if not self.flops:
            return 0.0
        return (self.model_flops / self.chips) / self.flops

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    def summary(self) -> dict:
        return {
            "flops_per_device": self.flops,
            "hbm_bytes_per_device": self.hbm_bytes,
            "collective_bytes_per_device": self.coll_bytes,
            "n_collectives": self.n_collectives,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
            "collectives_by_kind": self.collectives,
        }


def roofline(rec: Recorder, chips: int, dtype: str,
             model_flops: float = 0.0) -> Roofline:
    stats = collective_stats(rec.collectives)
    return Roofline(flops=rec.flops, hbm_bytes=rec.hbm_bytes,
                    coll_bytes=stats.total_bytes, chips=chips, dtype=dtype,
                    collectives=stats.by_kind, n_collectives=stats.count,
                    model_flops=model_flops)


def analytic_model_flops(cfg, shape) -> float:
    """MODEL_FLOPS: 6*N*D for training (N = active non-embed params),
    2*N*D for prefill, 2*N per generated token for decode."""
    n_active = cfg.param_count(active_only=True)
    n_active -= cfg.padded_vocab * cfg.d_model
    if not cfg.tie_embeddings:
        n_active -= cfg.padded_vocab * cfg.d_model
    n_active = max(n_active, 1)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch      # one token per sequence
