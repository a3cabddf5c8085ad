"""AdamW with linear warmup and cosine decay, on trees of tensors (port of
the JAX package's ``training/optimizer.py``; no ``torch.optim`` class).

The same function as the JAX one: clipping by the global norm of the
gradients, bias correction, decoupled weight decay on every leaf with more
than one dimension (``p.ndim > 1``: a stage's stacked norm scales
``[repeats, d]`` and biases ``[repeats, H, hd]`` decay too, as in the JAX
package; only the unstacked ``final_norm``/``enc_norm`` scales are
skipped), moments kept in ``moment_dtype`` and f32 arithmetic.  The update
runs in place on the param and moment tensors under ``torch.no_grad()``,
the way ``torch.optim`` updates, instead of building new trees.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    moment_dtype: str = "float32"


def tree_leaves(tree):
    """Leaves of a tree of dicts in the JAX flatten order (sorted keys)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k])
    else:
        yield tree


def tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_frac * lr, in f32."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1.0 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def init_opt_state(cfg: AdamWConfig, params: dict) -> dict:
    """{"m", "v"}: zeros like each param in ``moment_dtype``; "step": an
    int32 scalar tensor, on the params' device."""
    dt = getattr(torch, cfg.moment_dtype)
    zeros = lambda p: torch.zeros(p.shape, dtype=dt,  # noqa: E731
                                  device=p.device)
    dev = next(tree_leaves(params)).device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for leaf in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: dict, grads: dict,
                 opt_state: dict) -> tuple[dict, dict, dict]:
    """One AdamW step, in place on ``params`` and the moments of
    ``opt_state``.  Returns (params, opt_state, {"grad_norm", "lr"}), the
    same dicts it was given."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - b1 ** step.to(torch.float32)
    bc2 = 1.0 - b2 ** step.to(torch.float32)

    def upd(p, g, m, v):
        g = g.float() * scale
        m_new = b1 * m.float() + (1 - b1) * g
        v_new = b2 * v.float() + (1 - b2) * torch.square(g)
        delta = (m_new / bc1) / (torch.sqrt(v_new / bc2) + cfg.eps)
        # decoupled weight decay (skip 1-d params: norms, biases)
        if p.ndim > 1:
            delta = delta + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        m.copy_(m_new)
        v.copy_(v_new)

    tree_map(upd, params, grads, opt_state["m"], opt_state["v"])
    opt_state["step"] = step
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
