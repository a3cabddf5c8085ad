"""Model configuration for the 10 assigned architectures.

A :class:`ModelConfig` fully describes one architecture as a sequence of
*stages*.  Each stage is a (pattern of layers) x (repeat count); repeated
stages are executed with ``jax.lax.scan`` over stacked parameters so the HLO
stays O(1) in depth (a 61-layer model must compile for 512 placeholder
devices on one CPU core).

Layer mixers supported: GQA/MHA attention (optional QKV bias, optional
sliding window), MLA (DeepSeek multi-head latent attention), Mamba selective
SSM, mLSTM and sLSTM (xLSTM).  FFNs: dense SwiGLU/GeLU MLP, MoE
(shared + routed top-k with capacity-based dispatch), or none.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Optional

# --------------------------------------------------------------------------- #
# Sub-configs                                                                 #
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int                       # routed experts
    top_k: int
    d_expert: int                        # per-expert FFN hidden size
    n_shared: int = 0                    # always-on shared experts
    capacity_factor: float = 1.25
    router: str = "softmax"              # "softmax" | "sigmoid" (DeepSeek-V3)
    router_aux_weight: float = 0.001     # load-balance aux loss weight


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek multi-head latent attention (arXiv:2405.04434 / 2412.19437)."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 0                 # 0 => direct q projection
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0                     # 0 => ceil(d_model / 16)


@dataclass(frozen=True)
class XLSTMConfig:
    """mLSTM/sLSTM block dims (arXiv:2405.04517)."""

    proj_factor_mlstm: float = 2.0       # mLSTM up-projection
    conv_kernel: int = 4
    ffn_proj_factor: float = 1.3333      # post-sLSTM gated FFN


@dataclass(frozen=True)
class LayerDef:
    """One layer inside a stage pattern."""

    mixer: str                           # attn | mla | mamba | mlstm | slstm
    ffn: str                             # dense | moe | none
    cross_attn: bool = False             # decoder layer with cross-attention


@dataclass(frozen=True)
class StageDef:
    pattern: tuple[LayerDef, ...]
    repeats: int

    @property
    def n_layers(self) -> int:
        return len(self.pattern) * self.repeats


# --------------------------------------------------------------------------- #
# ModelConfig                                                                 #
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                       # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int = 0                    # 0 => d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # Sliding-window attention (tokens). 0 = full causal attention.  The
    # long_500k shape switches dense archs to `long_context_window`.
    sliding_window: int = 0
    long_context_window: int = 8192

    # Stage structure. Empty => homogeneous dense decoder derived from
    # n_layers (pattern [attn+dense] x n_layers).
    stages: tuple[StageDef, ...] = ()

    # Mixture-of-experts / MLA / SSM sub-configs (None when unused).
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    mamba: Optional[MambaConfig] = None
    xlstm: Optional[XLSTMConfig] = None

    # Encoder-decoder (audio): encoder stage list; 0 layers => decoder-only.
    encoder_stages: tuple[StageDef, ...] = ()

    # Modality frontend stubs (brief carve-out): embeddings arrive
    # precomputed with this dim; a learned projector maps them to d_model.
    modality: str = "text"               # text | vision | audio
    modality_embed_dim: int = 0          # dim of the stub-provided embeddings
    n_modality_tokens: int = 0           # prepended per sequence (vision)

    # DeepSeek-V3 multi-token prediction (optional extra head, training only)
    mtp_depth: int = 0

    # Beyond-paper §Perf lever: chunkwise-parallel mLSTM (linear-attention
    # chunk form).  0 = off -> naive T x T decay-masked parallel form.
    # Removes the quadratic decay/score matrices from HBM traffic and cuts
    # masked-out FLOPs; exactly equivalent to the naive form (same
    # stabiliser semantics) — see tests/test_layers_equivalence.py.
    mlstm_chunk: int = 0

    # Beyond-paper §Perf lever: blocked online-softmax attention for
    # full-sequence passes (0 = off -> naive T x T materialisation).  The
    # pure-JAX analogue of the flash_attention Pallas kernel; removes the
    # quadratic score tensor from HBM traffic.
    attn_chunk: int = 0

    # Numeric / padding policy
    param_dtype: str = "float32"
    activation_dtype: str = "float32"
    vocab_pad_multiple: int = 512        # pad embedding table so 16 | vocab

    source: str = ""                     # citation for the config

    # ------------------------------------------------------------------ #
    def __post_init__(self) -> None:
        if not self.stages:
            object.__setattr__(
                self,
                "stages",
                (StageDef((LayerDef("attn", "dense"),), self.n_layers),),
            )
        total = sum(s.n_layers for s in self.stages)
        if total != self.n_layers:
            raise ValueError(
                f"{self.name}: stages cover {total} layers != n_layers={self.n_layers}"
            )

    # ------------------------------------------------------------------ #
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def is_encoder_decoder(self) -> bool:
        return bool(self.encoder_stages)

    @property
    def n_encoder_layers(self) -> int:
        return sum(s.n_layers for s in self.encoder_stages)

    @property
    def mamba_d_inner(self) -> int:
        assert self.mamba is not None
        return self.mamba.expand * self.d_model

    @property
    def mamba_dt_rank(self) -> int:
        assert self.mamba is not None
        return self.mamba.dt_rank or max(1, math.ceil(self.d_model / 16))

    @property
    def uses_attention(self) -> bool:
        defs = [l for s in self.stages for l in s.pattern]
        return any(l.mixer in ("attn", "mla") for l in defs)

    @property
    def subquadratic_native(self) -> bool:
        """True when decode state is O(1) per token (SSM / hybrid-with-window)."""
        return self.arch_type in ("ssm", "hybrid")

    def with_sliding_window(self, window: int) -> "ModelConfig":
        return replace(self, sliding_window=window)

    def layer_defs(self) -> list[LayerDef]:
        out: list[LayerDef] = []
        for s in self.stages:
            out.extend(list(s.pattern) * s.repeats)
        return out

    # Parameter count (embedding + per-layer), for 6ND roofline numbers.
    def param_count(self, active_only: bool = False) -> int:
        d, hd = self.d_model, self.resolved_head_dim
        n_q, n_kv = self.n_heads, self.n_kv_heads

        def attn_params() -> int:
            return d * hd * n_q + 2 * d * hd * n_kv + n_q * hd * d

        def mla_params() -> int:
            m = self.mla
            assert m is not None
            q_in = (
                d * m.q_lora_rank + m.q_lora_rank * n_q * (m.nope_head_dim + m.rope_head_dim)
                if m.q_lora_rank
                else d * n_q * (m.nope_head_dim + m.rope_head_dim)
            )
            kv = d * (m.kv_lora_rank + m.rope_head_dim)
            kv += m.kv_lora_rank * n_q * (m.nope_head_dim + m.v_head_dim)
            out = n_q * m.v_head_dim * d
            return q_in + kv + out

        def mamba_params() -> int:
            di, ds, dt = self.mamba_d_inner, self.mamba.d_state, self.mamba_dt_rank
            return (
                d * 2 * di                      # in_proj
                + di * self.mamba.d_conv        # conv
                + di * (dt + 2 * ds)            # x_proj
                + dt * di                       # dt_proj
                + di * ds                       # A
                + di                            # D
                + di * d                        # out_proj
            )

        def mlstm_params() -> int:
            di = int(self.xlstm.proj_factor_mlstm * d)
            return d * 2 * di + di * self.xlstm.conv_kernel + 3 * di * di // self.n_heads \
                + 3 * di + di * d

        def slstm_params() -> int:
            h = d
            per_head = (h // self.n_heads) ** 2
            return 4 * h * h + 4 * self.n_heads * per_head + \
                int(2 * self.xlstm.ffn_proj_factor * h * h)

        def ffn_params(kind: str) -> int:
            if kind == "dense":
                return 3 * d * self.d_ff
            if kind == "moe":
                m = self.moe
                assert m is not None
                routed = m.n_experts if not active_only else m.top_k
                shared = m.n_shared
                return 3 * d * m.d_expert * (routed + shared) + d * m.n_experts
            return 0

        total = 0
        mixers = {
            "attn": attn_params,
            "mla": mla_params,
            "mamba": mamba_params,
            "mlstm": mlstm_params,
            "slstm": slstm_params,
        }
        for ld in self.layer_defs():
            total += mixers[ld.mixer]()
            total += ffn_params(ld.ffn)
            if ld.cross_attn:
                total += attn_params()
            total += 2 * d                     # norms
        for s in self.encoder_stages:
            for ld in s.pattern * s.repeats:
                total += mixers[ld.mixer]() + ffn_params(ld.ffn) + 2 * d
        total += self.padded_vocab * d         # embedding
        if not self.tie_embeddings:
            total += self.padded_vocab * d     # lm head
        if self.modality_embed_dim:
            total += self.modality_embed_dim * d + d * d  # 2-layer projector
        return total
