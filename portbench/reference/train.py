"""Plain training steps: next-token cross entropy of a reference model (a
module of this package with ``Precision``, ``hidden`` and ``head``) and
AdamW as the train cell's traffic file states it.

Loss: the mean over positions whose label is >= 0 of logsumexp(logits) -
logit[label], the logits over the published vocabulary (``head``).
AdamW (Loshchilov and Hutter, decoupled decay): the gradient scaled to the
global norm ``grad_clip`` where it is above it; m, v with bias correction;
lr = lr_max * min(step / warmup, 1) * (min_frac + (1 - min_frac) * (1 +
cos(pi * progress)) / 2) after warmup; decay on the leaves of more than one
dimension.
"""
from __future__ import annotations

import math

import torch



def leaves(tree: dict, prefix: str = ""):
    """(path, tensor) of a tree, keys sorted."""
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from leaves(v, path)
        else:
            yield path, v


def loss_of(model, w: dict, dims, tokens: torch.Tensor,
            labels: torch.Tensor, p) -> torch.Tensor:
    hs = model.hidden(w, dims, tokens, p, remat=True)
    logits = p.mm(hs.reshape(-1, hs.shape[-1]), model.head(w, dims, p))
    lab = labels.reshape(-1).long()
    ok = lab >= 0
    gold = logits.gather(1, lab.clamp(min=0)[:, None])[:, 0]
    per = torch.logsumexp(logits, dim=-1) - gold
    return (per * ok).sum() / ok.sum().clamp(min=1)


def lr_at(opt: dict, step: int) -> float:
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    prog = min(max((step - opt["warmup_steps"])
                   / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0),
               1.0)
    frac = opt["min_lr_frac"] + (1 - opt["min_lr_frac"]) * 0.5 * (
        1 + math.cos(math.pi * prog))
    return opt["lr"] * warm * frac


def run_steps(model, w: dict, dims, batches: list, opt: dict,
              precision: str = "f32") -> dict:
    """len(batches) AdamW steps from ``w`` (changed in place) -> {"loss":
    [per step], "grad": {leaf: norm of step 1's clipped gradient},
    "delta": {leaf: norm of the change after the last step}}."""
    dev = w["embed"].device
    p = model.Precision(precision, dev)
    names = [n for n, _ in leaves(w)]
    params = [t for _, t in leaves(w)]
    start = [t.detach().clone() for t in params]
    m = [torch.zeros_like(t) for t in params]
    v = [torch.zeros_like(t) for t in params]
    out = {"loss": [], "grad": {}, "delta": {}}
    b1, b2 = opt["b1"], opt["b2"]
    for step, batch in enumerate(batches, start=1):
        for t in params:
            t.requires_grad_(True)
        tokens = torch.as_tensor(batch["tokens"], device=dev).long()
        labels = torch.as_tensor(batch["labels"], device=dev).long()
        with p.active():
            loss = loss_of(model, w, dims, tokens, labels, p)
            grads = torch.autograd.grad(loss, params)
        out["loss"].append(float(loss.detach()))
        with torch.no_grad():
            gnorm = torch.sqrt(sum(g.double().square().sum() for g in grads))
            scale = min(opt["grad_clip"] / (float(gnorm) + 1e-9), 1.0)
            lr = lr_at(opt, step)
            bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
            for i, (t, g) in enumerate(zip(params, grads)):
                g = g * scale
                if step == 1:
                    out["grad"][names[i]] = float(g.double().norm())
                m[i].mul_(b1).add_(g, alpha=1 - b1)
                v[i].mul_(b2).addcmul_(g, g, value=1 - b2)
                upd = (m[i] / bc1) / ((v[i] / bc2).sqrt() + opt["eps"])
                if t.dim() > 1:
                    upd = upd + opt["weight_decay"] * t
                t.sub_(lr * upd)
            del grads
    with torch.no_grad():
        for n, t, s in zip(names, params, start):
            out["delta"][n] = float((t - s).double().norm())
            t.requires_grad_(False)
    return out
