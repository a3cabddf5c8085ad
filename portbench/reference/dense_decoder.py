"""A dense decoder (Qwen2 / Phi-3 family) in plain PyTorch.

Pre-norm blocks: RMSNorm, GQA attention with RoPE (half-split rotation,
``theta``), optional QKV bias and sliding window, softmax in f32 with scale
1/sqrt(head_dim); RMSNorm, SwiGLU MLP (silu(x Wg) * (x Wu)) Wd.  A final
RMSNorm and the head (the embedding table, transposed, where tied).
Attention runs in blocks of query rows, so a long prompt fits.

Weights come as the benchmark's tree (the layout the port takes):
``embed [V_table, d]``, ``final_norm.scale``, optional ``lm_head [d,
V_table]``, and one stacked stage ``dec0.p0`` whose leaves carry the layer
index first.  ``dims`` holds the configuration's published numbers.

Precision: ``"f32"`` is full f32 products (TF32 off); ``"tf32"`` is the
control, every product at TF32's 10-bit mantissa (on a card TF32 itself, on
the CPU its inputs rounded, and in a backward its gradients too).
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch

Q_BLOCK = 1024


@dataclass(frozen=True)
class Dims:
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    rope_theta: float
    norm_eps: float
    tied: bool
    window: int = 0          # 0: full causal

    @classmethod
    def from_published(cls, pub: dict) -> "Dims":
        h = pub["num_attention_heads"]
        return cls(
            n_layers=pub["num_hidden_layers"], d_model=pub["hidden_size"],
            n_heads=h, n_kv_heads=pub["num_key_value_heads"],
            head_dim=pub.get("head_dim") or pub["hidden_size"] // h,
            d_ff=pub["intermediate_size"], vocab_size=pub["vocab_size"],
            rope_theta=float(pub["rope_theta"]),
            norm_eps=float(pub["rms_norm_eps"]),
            tied=bool(pub["tie_word_embeddings"]),
            window=int(pub.get("sliding_window") or 0))


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x (f32) rounded to TF32's 10 explicit mantissa bits."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.matmul(_round_tf32(a), _round_tf32(b))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = _round_tf32(g)
        return (torch.matmul(g, _round_tf32(b).transpose(-1, -2)),
                torch.matmul(_round_tf32(a).transpose(-1, -2), g))


class Precision:
    def __init__(self, name: str, device: torch.device):
        if name not in ("f32", "tf32"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        self.emulate = name == "tf32" and device.type != "cuda"

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a [..., m, k] @ b [..., k, n] with equal batch dims or a 2-D b."""
        if not self.emulate:
            return torch.matmul(a, b)
        if b.dim() == 2 and a.dim() > 2:
            lead = a.shape[:-1]
            return _TF32MatMul.apply(a.reshape(-1, a.shape[-1]),
                                     b).reshape(*lead, b.shape[-1])
        return _TF32MatMul.apply(a, b)

    @contextlib.contextmanager
    def active(self):
        """TF32 on for the products of the block where the card has it."""
        old = (torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32)
        on = self.name == "tf32" and not self.emulate
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on
        try:
            yield self
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = old


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x [B, T, N, D]: rotate the halves (x1, x2) by pos * theta^(-2i/D)."""
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                       device=x.device) / d)
    ang = pos.float()[:, None] * inv                 # [T, D/2]
    cos, sin = ang.cos()[:, None, :], ang.sin()[:, None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _layer(w: dict, i: int) -> dict:
    st = w["dec0"]["p0"]
    return {"n1": st["norm1"]["scale"][i], "n2": st["norm2"]["scale"][i],
            **{k: v[i] for k, v in st["mixer"].items()},
            **{k: v[i] for k, v in st["ffn"].items()}}


def attention(q, k, v, dims: Dims, p: Precision) -> torch.Tensor:
    """q [B, T, H, D], k/v [B, T, KV, D] at positions 0..T-1 -> [B, T, H, D],
    causal (and windowed), query rows in blocks."""
    b, t, h, d = q.shape
    kv = dims.n_kv_heads
    g = h // kv
    # [B*KV, G, T, D] queries of each KV group; [B*KV, T, D] keys, values
    qg = q.reshape(b, t, kv, g, d).permute(0, 2, 3, 1, 4).reshape(
        b * kv, g, t, d)
    kk = k.permute(0, 2, 1, 3).reshape(b * kv, t, d)
    vv = v.permute(0, 2, 1, 3).reshape(b * kv, t, d)
    pos = torch.arange(t, device=q.device)
    outs = []
    for s in range(0, t, Q_BLOCK):
        e = min(s + Q_BLOCK, t)
        lo = 0 if dims.window <= 0 else max(0, s - dims.window + 1)
        qb = qg[:, :, s:e].reshape(b * kv, g * (e - s), d)
        sc = p.mm(qb, kk[:, lo:e].transpose(1, 2)) * d ** -0.5
        sc = sc.reshape(b * kv, g, e - s, e - lo)
        qp, kp = pos[s:e, None], pos[None, lo:e]
        ok = kp <= qp
        if dims.window > 0:
            ok = ok & (kp > qp - dims.window)
        sc = sc.masked_fill(~ok, float("-inf"))
        pr = torch.softmax(sc, dim=-1).reshape(b * kv, g * (e - s), e - lo)
        outs.append(p.mm(pr, vv[:, lo:e]).reshape(b * kv, g, e - s, d))
    o = torch.cat(outs, dim=2)                       # [B*KV, G, T, D]
    return o.reshape(b, kv, g, t, d).permute(0, 3, 1, 2, 4).reshape(
        b, t, h, d)


def block(x: torch.Tensor, lw: dict, dims: Dims, p: Precision,
          keep: list | None = None) -> torch.Tensor:
    """One layer; where ``keep`` is given, its K (rotated) and V
    [B, T, KV, D] are appended to it."""
    b, t, dm = x.shape
    h, kv, hd = dims.n_heads, dims.n_kv_heads, dims.head_dim
    pos = torch.arange(t, device=x.device)
    a = rmsnorm(x, lw["n1"], dims.norm_eps)
    q = p.mm(a, lw["wq"].reshape(dm, h * hd)).reshape(b, t, h, hd)
    k = p.mm(a, lw["wk"].reshape(dm, kv * hd)).reshape(b, t, kv, hd)
    v = p.mm(a, lw["wv"].reshape(dm, kv * hd)).reshape(b, t, kv, hd)
    if "bq" in lw:
        q, k, v = q + lw["bq"], k + lw["bk"], v + lw["bv"]
    q, k = rope(q, pos, dims.rope_theta), rope(k, pos, dims.rope_theta)
    if keep is not None:
        keep += [k, v]
    o = attention(q, k, v, dims, p).reshape(b, t, h * hd)
    x = x + p.mm(o, lw["wo"])
    f = rmsnorm(x, lw["n2"], dims.norm_eps)
    hid = torch.nn.functional.silu(p.mm(f, lw["wg"])) * p.mm(f, lw["wu"])
    return x + p.mm(hid, lw["wd"])


def hidden(w: dict, dims: Dims, tokens: torch.Tensor, p: Precision, *,
           remat: bool = False) -> torch.Tensor:
    """tokens [B, T] -> the final normed hidden states [B, T, d]; ``remat``
    recomputes each layer in the backward (so a long batch fits)."""
    x = w["embed"][tokens]
    for i in range(dims.n_layers):
        lw = _layer(w, i)
        if remat:
            x = torch.utils.checkpoint.checkpoint(
                block, x, lw, dims, p, use_reentrant=False)
        else:
            x = block(x, lw, dims, p)
    return rmsnorm(x, w["final_norm"]["scale"], dims.norm_eps)


def head(w: dict, dims: Dims, p: Precision) -> torch.Tensor:
    """[d, vocab_size]: the output head over the published vocabulary (rows
    of a table padded beyond it are no tokens of the model)."""
    table = w["embed"].t() if dims.tied else w["lm_head"]
    return table[:, : dims.vocab_size]


@torch.no_grad()
def serve_outputs(w: dict, dims: Dims, tokens: torch.Tensor, at: list,
                  precision: str = "f32") -> tuple:
    """tokens [T] -> (f32 logits [len(at), vocab_size] at positions ``at``,
    the logits that predict the token after each; the last layer's K
    (rotated) and V [T, KV, D] at every position: what a KV cache holds)."""
    p = Precision(precision, tokens.device)
    with p.active():
        x = w["embed"][tokens[None]]
        kv: list = []
        for i in range(dims.n_layers):
            x = block(x, _layer(w, i), dims, p,
                      kv if i == dims.n_layers - 1 else None)
        hs = rmsnorm(x, w["final_norm"]["scale"], dims.norm_eps)[0, at]
        logits = p.mm(hs, head(w, dims, p))
        return logits, kv[0][0], kv[1][0]
