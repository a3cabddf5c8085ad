"""The hand-written kernels on DTensors and on ``meta`` tensors.

A wrapper given a DTensor runs its kernel on each device's shard through
``torch.distributed.tensor.experimental.local_map``.  The placements come
from the kernel's rule (:func:`local_call`): the batch dim may stay
sharded, the head dims may stay sharded where q's and k/v's sit on the same
mesh dims (each shard then holds whole GQA groups), and everything else is
redistributed to ``Replicate`` first, a collective that DTensor issues and
a recorder sees.

A wrapper given ``meta`` tensors (the dry run's abstract shards) launches
nothing and counts no launch: it returns empty outputs of the kernel's
shapes and reports the kernel's operations and bytes (the counts
``chip_smoke.py`` bounds it by) to the recorder set by :func:`recording`.

Plain CPU and CUDA tensors never reach this module: a wrapper's type check
sends only DTensors here.
"""
from __future__ import annotations

import math
from contextlib import contextmanager
from contextvars import ContextVar
from typing import Callable, Optional, Sequence

import torch

# While :func:`recording` is active: called as fn(name, flops, n_bytes) for
# every kernel call on meta tensors.
_recorder: ContextVar[Optional[Callable]] = ContextVar("kernel_recorder",
                                                       default=None)


@contextmanager
def recording(fn: Callable):
    """Within the block, each kernel call on ``meta`` tensors reports
    ``fn(name, flops, n_bytes)``: what one device's launch would do."""
    token = _recorder.set(fn)
    try:
        yield
    finally:
        _recorder.reset(token)


def meta_launch(name: str, flops: float, n_bytes: float) -> None:
    rec = _recorder.get()
    if rec is not None:
        rec(name, float(flops), float(n_bytes))


class _MetaOp(torch.autograd.Function):
    """A step on meta tensors that runs nothing: empty outputs, and its
    work (and in the backward its gradient's) reported."""

    @staticmethod
    def forward(ctx, name, outs, costs, *inputs):
        ctx.name, ctx.bwd = name, costs[1]
        ctx.like = [(x.shape, x.dtype) for x in inputs]
        meta_launch(name, *costs[0])
        return tuple(torch.empty(shape, dtype=dt, device="meta")
                     for shape, dt in outs)

    @staticmethod
    def backward(ctx, *grads):
        meta_launch(ctx.name + "_bwd", *ctx.bwd)
        return (None, None, None,
                *(torch.empty(shape, dtype=dt, device="meta")
                  for shape, dt in ctx.like))


def meta_op(name: str, inputs: Sequence[torch.Tensor], outs: Sequence,
            fwd: tuple[float, float], bwd: tuple[float, float]) -> tuple:
    """Outputs of ``outs`` ((shape, dtype) each) for a step on the meta
    tensors ``inputs`` that is not run; ``fwd`` and ``bwd`` (FLOPs, bytes)
    are reported for it and, where autograd reaches it, its gradient."""
    return _MetaOp.apply(name, tuple(outs), (fwd, bwd), *inputs)


def nbytes(*ts: Optional[torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def is_dtensor(t) -> bool:
    if type(t) is torch.Tensor:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


# Dims of a kernel argument or output: (batch dim, head dim), either None.
Dims = Optional[tuple[Optional[int], Optional[int]]]


def _roles(mesh, args: Sequence, arg_dims: Sequence[Dims]) -> list:
    """Per mesh dim: 0 where every argument with a batch dim is sharded on
    it there, 1 where every argument with a head dim is, else None; a role
    whose mesh dims do not divide every such dim is dropped."""
    from torch.distributed.tensor import Shard

    dts = [(a, d) for a, d in zip(args, arg_dims)
           if d is not None and is_dtensor(a)]
    roles: list = []
    for i in range(mesh.ndim):
        role = None
        for r in (0, 1):
            has = [(a, d[r]) for a, d in dts if d[r] is not None]
            if has and all(a.placements[i] == Shard(dim) for a, dim in has):
                role = r
        roles.append(role)
    for r in (0, 1):
        n = math.prod(mesh.size(i) for i, x in enumerate(roles) if x == r)
        sizes = [a.shape[d[r]] for a, d in zip(args, arg_dims)
                 if d is not None and d[r] is not None
                 and isinstance(a, torch.Tensor)]
        if any(s % n for s in sizes):
            roles = [None if x == r else x for x in roles]
    return roles


def _placements(roles: list, dims: Dims) -> tuple:
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Shard(dims[r]) if dims is not None and r is not None
                 and dims[r] is not None else Replicate() for r in roles)


def local_call(fn: Callable, args: Sequence, arg_dims: Sequence[Dims],
               out_dims: Sequence[Dims]):
    """``fn(*args)`` on each device's shards through ``local_map``: batch
    and head dims keep their sharding where the rule allows, every other
    DTensor argument is redistributed to ``Replicate`` first.  Plain tensor
    arguments pass as they are (the same on every rank).  ``out_dims``
    gives each flat output's dims; the outputs are DTensors."""
    from torch.distributed.tensor.experimental import local_map

    mesh = next(a.device_mesh for a in args if is_dtensor(a))
    roles = _roles(mesh, args, arg_dims)
    in_pl = tuple(_placements(roles, d) if is_dtensor(a) else None
                  for a, d in zip(args, arg_dims))
    out_pl = tuple(list(_placements(roles, d)) for d in out_dims)
    if len(out_pl) == 1:              # one output: its placements alone
        out_pl = out_pl[0]
    return local_map(fn, out_placements=out_pl, in_placements=in_pl,
                     device_mesh=mesh, redistribute_inputs=True)(*args)


def reshape(x, shape):
    """``x.reshape(shape)`` for a DTensor whose sharded dims a reshape would
    split or merge unevenly (DTensor refuses, in the forward or in the
    gradient's backward reshape): every dim from the first one the reshape
    changes is gathered first, and the result's placements are pinned so
    its gradient arrives in them."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    shape = tuple(shape)
    p = 0
    while p < min(x.ndim, len(shape)) and x.shape[p] == shape[p]:
        p += 1
    pl = [Replicate() if isinstance(q, Shard) and q.dim >= p else q
          for q in x.placements]
    y = x.redistribute(placements=pl).reshape(shape)
    return DTensor.from_local(y.to_local(grad_placements=y.placements),
                              y.device_mesh, y.placements, run_check=False,
                              shape=y.shape, stride=y.stride())


DATA_AXES = ("pod", "data")


def unshard(t, axes: Sequence[str] = DATA_AXES):
    """A DTensor weight gathered over the data-parallel mesh axes before
    use (FSDP: its shards on ``axes`` all-gathered, its tensor-parallel
    shards kept); anything else as it is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate, Shard

    names = t.device_mesh.mesh_dim_names or ()
    pl = [Replicate() if isinstance(p, Shard) and names[i] in axes else p
          for i, p in enumerate(t.placements)]
    return t if pl == list(t.placements) else t.redistribute(placements=pl)


def vocab_lookup(table, ids):
    """``table[ids]`` for a DTensor table [V, d]: where its vocab dim is
    sharded, each shard looks up the ids in its range (zero rows for the
    others) and the rows are a partial sum over those mesh dims; the ids
    keep their sharding on their leading dim, the rest is gathered."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    if not is_dtensor(ids):
        ids = DTensor.from_local(ids, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    vocab = [i for i, p in enumerate(table.placements) if p == Shard(0)]
    t_pl = [Shard(0) if i in vocab else Replicate() for i in range(mesh.ndim)]
    i_pl = [p if i not in vocab and p == Shard(0) else Replicate()
            for i, p in enumerate(ids.placements)]
    o_pl = [Partial() if i in vocab else p for i, p in enumerate(i_pl)]

    def local(tab, idx):
        rel, ok = _in_shard(mesh, vocab, tab.shape[0], idx)
        return tab[rel] * ok[..., None].to(tab.dtype)

    return local_map(local, out_placements=o_pl, in_placements=(t_pl, i_pl),
                     device_mesh=mesh, redistribute_inputs=True)(table, ids)


def _in_shard(mesh, vocab_dims: list, n: int, idx):
    """(idx relative to this rank's vocab shard of n entries, clamped into
    it; whether it falls there): the shard's offset is its linear index
    over ``vocab_dims`` in mesh order."""
    coord = mesh.get_coordinate()
    start = 0
    for i in vocab_dims:
        start = start * mesh.size(i) + coord[i]
    rel = idx - start * n
    return rel.clamp(0, n - 1), (rel >= 0) & (rel < n)


def vocab_gather(logits, idx):
    """``logits[..., idx]`` per position (``torch.gather`` over the last
    axis) for DTensor logits [B, T, V] and ids [B, T]: where the vocab is
    sharded each shard takes the ids in its range (0 for the others) as a
    partial sum over those mesh dims; the batch keeps its sharding where
    the ids share it, the rest is gathered."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = logits.device_mesh
    if not is_dtensor(idx):
        idx = DTensor.from_local(idx, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    last = logits.ndim - 1
    vocab = [i for i, p in enumerate(logits.placements) if p == Shard(last)]
    batch = [i for i in range(mesh.ndim) if i not in vocab
             and logits.placements[i] == Shard(0) == idx.placements[i]]
    l_pl = [Shard(last) if i in vocab else Shard(0) if i in batch
            else Replicate() for i in range(mesh.ndim)]
    i_pl = [Shard(0) if i in batch else Replicate() for i in range(mesh.ndim)]
    o_pl = [Partial() if i in vocab else p for i, p in enumerate(i_pl)]

    def local(lg, ids):
        rel, ok = _in_shard(mesh, vocab, lg.shape[-1], ids)
        return torch.gather(lg, -1, rel[..., None])[..., 0] * ok.to(lg.dtype)

    return local_map(local, out_placements=o_pl, in_placements=(l_pl, i_pl),
                     device_mesh=mesh, redistribute_inputs=True)(logits, idx)


def settle(x):
    """A residual-stream activation [B, T, d] between layers: its partial
    sums reduced and every shard gathered but those of its batch or
    sequence dim over the data-parallel axes (tensor parallelism keeps it
    so between layers); anything but a DTensor as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    names = x.device_mesh.mesh_dim_names or ()
    pl = [p if isinstance(p, Shard) and p.dim in (0, 1)
          and names[i] in DATA_AXES else Replicate()
          for i, p in enumerate(x.placements)]
    return x if pl == list(x.placements) else x.redistribute(placements=pl)


def reduce_partial(x):
    """A DTensor with its partial sums reduced (``Replicate`` where it was
    ``Partial``), its shards kept; anything else as it is.  Before an
    elementwise op with a sharded operand, which DTensor would otherwise
    try to turn into a partial sum."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Partial, Replicate

    pl = [Replicate() if isinstance(p, Partial) else p for p in x.placements]
    return x if pl == list(x.placements) else x.redistribute(placements=pl)


def along(fn: Callable, x, dim: Optional[int] = None):
    """``fn(x)`` for an op that acts along ``dim`` of the DTensor ``x`` and
    elementwise over its other dims (a pad, a running sum; with ``dim``
    None an elementwise op): each shard runs it with a shard on ``dim``
    gathered and partial sums reduced first; the result keeps those
    placements, and its gradient runs on the shards too (for ops whose
    backward DTensor has no rule for)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    dim = None if dim is None else dim % x.ndim
    pl = [Replicate() if isinstance(p, Partial)
          or (isinstance(p, Shard) and p.dim == dim) else p
          for p in x.placements]
    return local_map(fn, out_placements=pl, in_placements=(pl,),
                     device_mesh=x.device_mesh, redistribute_inputs=True)(x)
