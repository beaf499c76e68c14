"""Model configuration schema covering all ten assigned architectures.

One `ModelConfig` expresses dense GQA transformers (glm4, internlm2,
tinyllama), parallel-block no-bias models (command-r), MoE (granite-moe ×2),
hybrid Mamba2 + shared-attention (zamba2), M-RoPE VLM backbones (qwen2-vl),
audio decoders over EnCodec tokens (musicgen), and sLSTM/mLSTM stacks
(xlstm). A copy of the JAX package's `models/config.py`, so the port reads
the same widths without importing it; the block *pattern* strings name the
assemblies the JAX package's `models/blocks.py` builds.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    # TD-Orch dispatch knobs (§DESIGN: tokens = tasks, experts = chunks)
    dispatch: str = "tdorch"  # tdorch | push | pull | dense
    capacity_factor: float = 1.25
    num_hot: int = 4  # H hottest experts served by pull/replication
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01
    gemm_impl: str = "ragged"  # Phase-3 grouped compute (see core.spmd)
    # expert-parallel padding: when |model| axis doesn't divide num_experts
    # (granite-3b: 40 experts on 16 shards) the weight tables are padded
    # with never-routed dummy experts (router logits masked to −inf)
    num_experts_padded: Optional[int] = None

    @property
    def padded(self) -> int:
        return self.num_experts_padded or self.num_experts


@dataclasses.dataclass(frozen=True)
class SSMConfig:  # Mamba2
    d_state: int = 64
    expand: int = 2
    head_dim: int = 64
    d_conv: int = 4
    chunk: int = 128
    # dtype of the intra-chunk (c×c) decay/contribution tensors — the
    # dominant HBM-traffic term of the chunked SSD (exponent math stays f32)
    intra_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    slstm_every: int = 8  # every k-th block is sLSTM, rest mLSTM
    proj_factor: float = 2.0  # mLSTM up-projection
    ff_factor: float = 4.0 / 3.0  # sLSTM post-FFN
    chunk: int = 128  # chunkwise-parallel mLSTM window


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    vocab_size: int
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    # block pattern: dense | parallel | moe | zamba2 | xlstm
    pattern: str = "dense"
    head_dim: Optional[int] = None
    rope_theta: float = 10_000.0
    rope_kind: str = "standard"  # standard | mrope | none
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    attn_qkv_bias: bool = False
    attn_logit_softcap: Optional[float] = None
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    shared_attn_every: int = 6  # zamba2: shared attn block cadence
    # modality frontend stub (qwen2-vl, musicgen): model accepts precomputed
    # (B, S, d_model) embeddings from input_specs() instead of token ids
    modality_stub: bool = False
    sub_quadratic: bool = False  # may run the long_500k shape
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        assert self.n_heads % max(self.n_kv_heads, 1) == 0, "GQA group mismatch"

    # ---- derived sizes ----------------------------------------------------
    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def param_count(self) -> int:
        """Analytic parameter count (used for 6·N·D roofline checks)."""
        d, V = self.d_model, self.vocab_size
        n = V * d  # embed
        if not self.tie_embeddings:
            n += d * V
        n += d  # final norm
        per_layer = 0
        if self.pattern in ("dense", "parallel", "moe"):
            per_layer += d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
            if self.attn_qkv_bias:
                per_layer += self.q_dim + 2 * self.kv_dim
            per_layer += d  # input norm
            if self.pattern != "parallel":
                per_layer += d  # post-attn norm
            if self.pattern == "moe":
                m = self.moe
                per_layer += m.num_experts * (2 * d * m.d_ff_expert
                                              + m.d_ff_expert * d)
                per_layer += d * m.num_experts  # router
            else:
                per_layer += 3 * d * self.d_ff
            n += per_layer * self.n_layers
        elif self.pattern == "zamba2":
            s = self.ssm
            d_in = s.expand * d
            nh = d_in // s.head_dim
            # in_proj (z,x) + BC proj + dt proj + conv + out_proj + A/D + norm
            per_mamba = d * 2 * d_in + d * 2 * s.d_state + d * nh \
                + (d_in + 2 * s.d_state) * s.d_conv + d_in * d + 2 * nh + d
            n += per_mamba * self.n_layers
            # one shared attention + MLP block
            n += d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d \
                + 3 * d * self.d_ff + 2 * d
        elif self.pattern == "xlstm":
            x = self.xlstm
            d_up = int(d * x.proj_factor)
            nh = self.n_heads
            # mLSTM: up(2×), q/k/v (d_up×d_up each head-block-diag ~ d_up·hd),
            # gates (2 per head from d_up), out norm + down
            hd = d_up // nh
            per_m = 2 * d * d_up + 3 * d_up * hd + 2 * d_up * nh + d_up * d + 2 * d
            n_s = self.n_layers // x.slstm_every if x.slstm_every else 0
            n_m = self.n_layers - n_s
            d_ff_s = int(d * x.ff_factor)
            per_s = 4 * (d * d + d * d // nh) + 2 * d * d_ff_s + d * d_ff_s + 2 * d
            n += n_m * per_m + n_s * per_s
        return int(n)

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top-k experts count)."""
        if self.pattern != "moe":
            return self.param_count()
        m = self.moe
        d = self.d_model
        full = self.param_count()
        all_experts = self.n_layers * m.num_experts * 3 * d * m.d_ff_expert
        active = self.n_layers * m.top_k * 3 * d * m.d_ff_expert
        return int(full - all_experts + active)
