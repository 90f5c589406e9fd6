"""Architecture configuration dataclasses (one instance per assigned arch).

The JAX package's ``models/config.py``, copied: plain dataclasses, which
the port keeps its own copy of (it imports nothing of the JAX package).

All fields mirror the public configs cited in the assignment; reduced
`smoke` variants shrink width/depth/vocab but keep the family's structure
(MoE stays MoE, hybrid stays hybrid) so smoke tests exercise the same code
paths as the full configs.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_expert: int
    n_shared: int = 0            # shared (always-on) experts, deepseek-style
    dense_residual_ff: int = 0   # arctic-style parallel dense MLP width
    first_dense: int = 0         # leading dense layers (deepseek-v3: 3)
    dense_ff: int = 0            # ff width of those dense layers
    capacity_factor: float = 1.25
    group_tokens: int = 1024     # GShard dispatch group size
    aux_loss_coef: float = 0.01
    dispatch: str = "einsum"     # einsum (GShard baseline) | gather (opt)


@dataclasses.dataclass(frozen=True)
class MLACfg:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    n_groups: int = 1
    chunk: int = 256
    attn_every: int = 6          # zamba2: shared attn block cadence


@dataclasses.dataclass(frozen=True)
class XLSTMCfg:
    m_per_s: int = 7             # mLSTM blocks per sLSTM block
    proj_factor: float = 2.0     # mLSTM up-projection
    conv_kernel: int = 4


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    # attention flavour
    window: int = 0              # sliding window size (local layers)
    local_global: tuple[int, int] | None = None  # e.g. (5, 1) for gemma3
    qk_norm: bool = False
    rope_theta: float = 1e4
    rope_theta_global: float = 1e6
    tie_embed: bool = False
    embed_scale: bool = False    # gemma: x *= sqrt(d_model)
    # family extensions
    moe: MoECfg | None = None
    mla: MLACfg | None = None
    ssm: SSMCfg | None = None
    xlstm: XLSTMCfg | None = None
    mtp: bool = False            # deepseek multi-token prediction head
    mtp_loss_weight: float = 0.3
    # encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_frames: int = 1500   # stub-encoded audio frame count
    frontend_dim: int = 0        # stub frontend input feature dim
    # vlm
    n_patches: int = 0           # stub patch-embedding count (internvl)
    # norm / act
    act: str = "swiglu"          # swiglu | gelu
    norm_eps: float = 1e-6
    # distribution hints
    param_mode: str = "replicated"   # replicated | fsdp
    supports_long_context: bool = False
    remat: bool = True
    # which serve shapes apply (encoder-only archs would drop decode)
    has_decoder: bool = True

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def param_count(self) -> int:
        """Approximate parameter count (sanity checks / roofline 6ND)."""
        d, L = self.d_model, self.n_layers
        emb = self.vocab * d * (1 if self.tie_embed else 2)
        per_layer = 0
        # attention
        if self.mla is not None:
            m = self.mla
            qk = m.qk_nope_head_dim + m.qk_rope_head_dim
            per_layer += d * m.q_lora_rank + m.q_lora_rank * self.n_heads * qk
            per_layer += d * (m.kv_lora_rank + m.qk_rope_head_dim)
            per_layer += m.kv_lora_rank * self.n_heads * (
                m.qk_nope_head_dim + m.v_head_dim)
            per_layer += self.n_heads * m.v_head_dim * d
        elif self.family not in ("ssm", "hybrid"):
            per_layer += d * self.hd * (self.n_heads + 2 * self.n_kv_heads)
            per_layer += self.n_heads * self.hd * d
        # ffn / experts
        if self.moe is not None:
            e = self.moe
            expert = 3 * d * e.d_expert
            per_layer += e.n_experts * expert + e.n_shared * expert
            per_layer += d * e.n_experts                     # router
            if e.dense_residual_ff:
                per_layer += 3 * d * e.dense_residual_ff
        elif self.d_ff:
            mult = 3 if self.act == "swiglu" else 2
            per_layer += mult * d * self.d_ff
        n_moe = L - (self.moe.first_dense if self.moe else 0)
        total = emb + per_layer * (n_moe if self.moe else L)
        if self.moe and self.moe.first_dense:
            mult = 3 if self.act == "swiglu" else 2
            dense_l = (d * self.hd * (self.n_heads + 2 * self.n_kv_heads)
                       + self.n_heads * self.hd * d
                       + mult * d * self.moe.dense_ff)
            if self.mla is not None:
                m = self.mla
                qk = m.qk_nope_head_dim + m.qk_rope_head_dim
                dense_l = (d * m.q_lora_rank
                           + m.q_lora_rank * self.n_heads * qk
                           + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                           + m.kv_lora_rank * self.n_heads
                           * (m.qk_nope_head_dim + m.v_head_dim)
                           + self.n_heads * m.v_head_dim * d
                           + mult * d * self.moe.dense_ff)
            total += self.moe.first_dense * dense_l
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE top-k), for MODEL_FLOPS = 6*N_act*D."""
        if self.moe is None:
            return self.param_count()
        e = self.moe
        full = self.param_count()
        expert = 3 * self.d_model * e.d_expert
        n_moe = self.n_layers - e.first_dense
        inactive = n_moe * (e.n_experts - e.top_k) * expert
        return full - inactive


@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    """One assigned input-shape cell."""
    name: str                    # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                    # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeCfg("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCfg("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCfg("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCfg("long_500k", "decode", 524288, 1),
}
