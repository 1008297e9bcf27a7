"""Model architecture configs: the dense GQA families, MLA and MoE.

The port's own copy of the fields of dynamo_tpu/models/config.py that the
dense GQA forward (Llama with the Qwen2, Qwen3, OLMo-2, Granite, Gemma
1/2/3, Mistral and Phi-3 branches), the MLA (DeepSeek) forward and the
single-card MoE block read, with the same names and defaults, so a config
built here and one built there describe the same model. The
expert-parallel capacity factor (`moe_capacity_factor`) is not here: the
port has no expert mesh.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict


@dataclass(frozen=True)
class ModelConfig:
    name: str = "tiny"
    vocab_size: int = 512
    dim: int = 64
    n_layers: int = 2
    n_heads: int = 4
    n_kv_heads: int = 2
    ffn_dim: int = 128
    max_seq_len: int = 2048
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # Qwen2 q/k/v projection biases
    attn_bias: bool = False
    # Qwen3 per-head RMSNorm on q and k before RoPE
    qk_norm: bool = False
    # OLMo-2: the qk-norm's statistics over the full projection width
    # (weight [H * hd], before the head reshape); only with qk_norm
    qk_norm_wide: bool = False
    # Gemma family:
    #   gelu_tanh MLP activation (GeGLU) instead of SiLU
    act: str = "silu"  # "silu" | "gelu_tanh"
    #   embeddings scaled by sqrt(dim) after lookup
    embed_scale: bool = False
    # Granite multipliers: the embedding multiplier (wins over
    # embed_scale), the residual-branch multiplier, the softmax scale
    # given directly (wins over query_pre_attn_scalar) and a divider of
    # the final logits
    embed_multiplier: float = 0.0
    residual_multiplier: float = 1.0
    attn_scale: float = 0.0
    logits_divider: float = 1.0
    #   RMSNorm weights are zero-centered: output = normed * (1 + w)
    norm_zero_centered: bool = False
    #   Gemma-2 sandwich norms: post-attention and post-FFW RMSNorms on
    #   the residual branches (in addition to the pre-norms)
    post_norms: bool = False
    #   OLMo-2 has no pre-norms: the sublayer reads the raw residual and
    #   only the post norms apply (needs post_norms=True)
    pre_norms: bool = True
    #   attention-score soft capping: s = cap * tanh(s / cap); 0 = off
    attn_logit_softcap: float = 0.0
    #   final-logit soft capping; 0 = off
    final_logit_softcap: float = 0.0
    #   attention scale = query_pre_attn_scalar^-0.5 (0 -> head_dim^-0.5)
    query_pre_attn_scalar: float = 0.0
    #   sliding-window attention; 0 = all-global. Layer l is GLOBAL when
    #   l % sw_period == sw_global_residue, else it slides (Gemma-2: period
    #   2, residue 1, even layers sliding; Mistral: period 1, residue 1,
    #   every layer sliding)
    sliding_window: int = 0
    sw_period: int = 2
    sw_global_residue: int = 1
    #   Gemma-3 dual RoPE: sliding layers rotate with this base, global
    #   layers with rope_theta (and its scaling); 0 = one RoPE
    rope_local_theta: float = 0.0
    # explicit head_dim when it differs from dim // n_heads
    head_dim_override: int = 0
    # MoE (0 experts = dense): n_experts routed experts of width
    # moe_ffn_dim, n_experts_active chosen a token (models/moe.py)
    n_experts: int = 0
    n_experts_active: int = 0
    moe_ffn_dim: int = 0
    # always-active shared experts, one dense FFN of width shared_ffn_dim
    # (explicit when it is not n_shared_experts * moe_ffn_dim)
    n_shared_experts: int = 0
    shared_expert_ffn_dim: int = 0
    # router scoring: softmax over the top-k logits (Mixtral, Qwen) or
    # sigmoid gates renormalised over the top-k (DeepSeek-V3)
    moe_scoring: str = "softmax"
    # HF norm_topk_prob: False keeps the softmax over all experts without
    # renormalising the chosen ones (Qwen2-MoE)
    moe_norm_topk: bool = True
    # DeepSeek-V3: a selection bias (e_score_correction_bias) and the
    # routed_scaling_factor on the mixing weights
    moe_router_bias: bool = False
    moe_routed_scale: float = 1.0
    # first k layers use a dense FFN instead of MoE (HF first_k_dense_replace)
    n_dense_layers: int = 0
    n_expert_groups: int = 0
    topk_groups: int = 0
    # RoPE long-context scaling (HF rope_scaling): "none" | "linear" |
    # "llama3" | "yarn"
    rope_scaling: str = "none"
    rope_factor: float = 1.0
    rope_orig_max_seq: int = 0  # original_max_position_embeddings
    rope_beta_fast: float = 32.0
    rope_beta_slow: float = 1.0
    rope_mscale: float = 1.0
    rope_mscale_all_dim: float = 0.0
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    # MLA (DeepSeek V2/V3/R1): the KV cache holds one latent c_kv
    # (kv_lora_rank) plus the shared RoPE key (qk_rope_head_dim) per token
    attn_type: str = "gqa"  # "gqa" | "mla"
    kv_lora_rank: int = 0  # d_c: KV latent dim
    q_lora_rank: int = 0  # query compression rank (0 = direct q proj)
    qk_rope_head_dim: int = 0  # decoupled positional key dim (shared head)
    qk_nope_head_dim: int = 0  # per-head content key dim
    v_head_dim: int = 0

    def __post_init__(self):
        if not self.pre_norms and not self.post_norms:
            raise ValueError(
                "pre_norms=False requires post_norms=True (OLMo-2 style: "
                "the branch outputs are normed instead of the inputs)")

    @property
    def head_dim(self) -> int:
        return self.head_dim_override or (self.dim // self.n_heads)

    @property
    def is_mla(self) -> bool:
        return self.attn_type == "mla"

    @property
    def mla_cache_dim(self) -> int:
        return self.kv_lora_rank + self.qk_rope_head_dim

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def shared_ffn_dim(self) -> int:
        return self.shared_expert_ffn_dim or self.n_shared_experts * self.moe_ffn_dim

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)


PRESETS: Dict[str, ModelConfig] = {
    # test-size model (CPU CI)
    "tiny": ModelConfig(),
    # test-size MoE: softmax top-2 of 4 experts; with a sigmoid-scored
    # shared expert (the DeepSeek style without V3's bias and groups)
    "tiny-moe": ModelConfig(
        name="tiny-moe", n_experts=4, n_experts_active=2, moe_ffn_dim=96
    ),
    "tiny-moe-shared": ModelConfig(
        name="tiny-moe-shared", n_experts=4, n_experts_active=2,
        moe_ffn_dim=96, n_shared_experts=1, moe_scoring="sigmoid",
    ),
    "llama-3.2-1b": ModelConfig(
        name="llama-3.2-1b",
        vocab_size=128256,
        dim=2048,
        n_layers=16,
        n_heads=32,
        n_kv_heads=8,
        ffn_dim=8192,
        max_seq_len=131072,
        rope_theta=500000.0,
        tie_embeddings=True,
        rope_scaling="llama3", rope_factor=32.0, rope_orig_max_seq=8192,
    ),
    # the port's first full-width model: head_dim 128, 24 query heads over
    # 8 KV heads (G = 3), ~6.4 GB in bf16
    "llama-3.2-3b": ModelConfig(
        name="llama-3.2-3b",
        vocab_size=128256,
        dim=3072,
        n_layers=28,
        n_heads=24,
        n_kv_heads=8,
        ffn_dim=8192,
        max_seq_len=131072,
        rope_theta=500000.0,
        tie_embeddings=True,
        rope_scaling="llama3", rope_factor=32.0, rope_orig_max_seq=8192,
    ),
    "llama-3.1-8b": ModelConfig(
        name="llama-3.1-8b",
        vocab_size=128256,
        dim=4096,
        n_layers=32,
        n_heads=32,
        n_kv_heads=8,
        ffn_dim=14336,
        max_seq_len=131072,
        rope_scaling="llama3", rope_factor=8.0, rope_orig_max_seq=8192,
    ),
    # test-size Qwen2 (q/k/v biases) and Qwen3 (per-head qk-norm)
    "tiny-qwen2": ModelConfig(name="tiny-qwen2", attn_bias=True),
    "tiny-qwen3": ModelConfig(
        name="tiny-qwen3", qk_norm=True, head_dim_override=32,
    ),
    # MLA test models (CPU tests of the DeepSeek attention family)
    "tiny-mla": ModelConfig(
        name="tiny-mla", attn_type="mla", kv_lora_rank=32,
        qk_rope_head_dim=16, qk_nope_head_dim=32, v_head_dim=32,
    ),
    "tiny-mla-q": ModelConfig(  # with query compression (V3-style q path)
        name="tiny-mla-q", attn_type="mla", kv_lora_rank=32, q_lora_rank=48,
        qk_rope_head_dim=16, qk_nope_head_dim=32, v_head_dim=32,
    ),
    "tiny-mla-moe": ModelConfig(
        name="tiny-mla-moe", n_layers=3, attn_type="mla", kv_lora_rank=32,
        qk_rope_head_dim=16, qk_nope_head_dim=32, v_head_dim=32,
        n_experts=4, n_experts_active=2, moe_ffn_dim=96,
        n_shared_experts=1, moe_scoring="sigmoid",
        moe_router_bias=True, moe_routed_scale=2.5, n_dense_layers=1,
    ),
    # Gemma-2 test model (CPU tests of the Gemma family: GeGLU, scaled
    # embeddings, zero-centered sandwich norms, softcaps, sliding window)
    "tiny-gemma2": ModelConfig(
        name="tiny-gemma2", tie_embeddings=True, act="gelu_tanh",
        embed_scale=True, norm_zero_centered=True, post_norms=True,
        attn_logit_softcap=50.0, final_logit_softcap=30.0,
        query_pre_attn_scalar=16.0, sliding_window=8, rope_theta=10000.0,
    ),
    # Gemma-3 test model (qk-norm, a 2:1 local/global window pattern, dual
    # RoPE bases; the production pattern is 5:1 with period 6)
    "tiny-gemma3": ModelConfig(
        name="tiny-gemma3", n_layers=3, tie_embeddings=True,
        act="gelu_tanh", embed_scale=True, norm_zero_centered=True,
        post_norms=True, qk_norm=True, query_pre_attn_scalar=16.0,
        sliding_window=8, sw_period=3, sw_global_residue=2,
        rope_theta=100000.0, rope_local_theta=10000.0,
    ),
    # Qwen 2.5 7B: q/k/v biases, 28 query heads over 4 KV heads (G = 7)
    "qwen2.5-7b": ModelConfig(
        name="qwen2.5-7b",
        vocab_size=152064,
        dim=3584,
        n_layers=28,
        n_heads=28,
        n_kv_heads=4,
        ffn_dim=18944,
        max_seq_len=32768,
        rope_theta=1000000.0,
        norm_eps=1e-6,
        attn_bias=True,
    ),
    # Qwen3 8B: per-head qk-norm
    "qwen3-8b": ModelConfig(
        name="qwen3-8b",
        vocab_size=151936,
        dim=4096,
        n_layers=36,
        n_heads=32,
        n_kv_heads=8,
        ffn_dim=12288,
        max_seq_len=40960,
        rope_theta=1000000.0,
        norm_eps=1e-6,
        qk_norm=True,
        head_dim_override=128,
    ),
    # Granite 3.1 8B: the Llama layout with Granite's four multipliers
    "granite-3.1-8b": ModelConfig(
        name="granite-3.1-8b",
        vocab_size=49155,
        dim=4096,
        n_layers=40,
        n_heads=32,
        n_kv_heads=8,
        ffn_dim=12800,
        max_seq_len=131072,
        rope_theta=10000000.0,
        norm_eps=1e-5,
        tie_embeddings=True,
        embed_multiplier=12.0,
        residual_multiplier=0.22,
        attn_scale=0.0078125,
        logits_divider=16.0,
    ),
    # OLMo-2 7B: post norms only, qk-norm over the full projection width
    "olmo-2-7b": ModelConfig(
        name="olmo-2-7b",
        vocab_size=100352,
        dim=4096,
        n_layers=32,
        n_heads=32,
        n_kv_heads=32,
        ffn_dim=11008,
        max_seq_len=4096,
        rope_theta=500000.0,
        norm_eps=1e-6,
        pre_norms=False,
        post_norms=True,
        qk_norm=True,
        qk_norm_wide=True,
    ),
    # Phi-3 mini 4k: head dim 96 (3072 over 32 heads), MHA, a 2047-token
    # window on every layer
    "phi-3-mini-4k": ModelConfig(
        name="phi-3-mini-4k",
        vocab_size=32064,
        dim=3072,
        n_layers=32,
        n_heads=32,
        n_kv_heads=32,
        ffn_dim=8192,
        max_seq_len=4096,
        rope_theta=10000.0,
        norm_eps=1e-5,
        sliding_window=2047,
        sw_period=1,
        sw_global_residue=1,
    ),
    # Mistral 7B v0.1: a 4096-token window on every layer (period 1:
    # l % 1 == 1 never holds, so no layer is global)
    "mistral-7b": ModelConfig(
        name="mistral-7b",
        vocab_size=32000,
        dim=4096,
        n_layers=32,
        n_heads=32,
        n_kv_heads=8,
        ffn_dim=14336,
        max_seq_len=32768,
        rope_theta=10000.0,
        norm_eps=1e-5,
        sliding_window=4096,
        sw_period=1,
        sw_global_residue=1,
    ),
    # Gemma 1 7B: GeGLU, scaled embeddings, zero-centred norms, MHA with
    # head dim 256 wider than dim / n_heads; no post norms, no caps
    "gemma-7b": ModelConfig(
        name="gemma-7b",
        vocab_size=256000,
        dim=3072,
        n_layers=28,
        n_heads=16,
        n_kv_heads=16,
        ffn_dim=24576,
        max_seq_len=8192,
        rope_theta=10000.0,
        norm_eps=1e-6,
        tie_embeddings=True,
        act="gelu_tanh",
        embed_scale=True,
        norm_zero_centered=True,
        head_dim_override=256,
    ),
    # Gemma 2 9B: head_dim 256, 16 query heads over 8 KV heads (G = 2), a
    # 4096-token window on the even layers, ~18.5 GB in bf16
    "gemma-2-9b": ModelConfig(
        name="gemma-2-9b",
        vocab_size=256000,
        dim=3584,
        n_layers=42,
        n_heads=16,
        n_kv_heads=8,
        ffn_dim=14336,
        max_seq_len=8192,
        rope_theta=10000.0,
        norm_eps=1e-6,
        tie_embeddings=True,
        head_dim_override=256,
        act="gelu_tanh",
        embed_scale=True,
        norm_zero_centered=True,
        post_norms=True,
        attn_logit_softcap=50.0,
        final_logit_softcap=30.0,
        query_pre_attn_scalar=256.0,
        sliding_window=4096,
    ),
    # Qwen3 30B-A3B: 48 MoE layers of 128 experts, top 8, expert width 768;
    # 32 query heads over 4 KV heads (G 8) at head dim 128 with qk-norm.
    # 30.5 B parameters, 61 GB in bf16: one 80 GB card holds it alone
    "qwen3-30b-a3b": ModelConfig(
        name="qwen3-30b-a3b",
        vocab_size=151936,
        dim=2048,
        n_layers=48,
        n_heads=32,
        n_kv_heads=4,
        ffn_dim=6144,  # unused (all layers MoE)
        max_seq_len=40960,
        rope_theta=1000000.0,
        norm_eps=1e-6,
        qk_norm=True,
        head_dim_override=128,
        n_experts=128,
        n_experts_active=8,
        moe_ffn_dim=768,
    ),
    # Mixtral 8x7B: 8 experts, top 2, expert width 14336. 46.7 B parameters,
    # 93 GB in bf16, more than one card holds; 46.7 GB with --quantize int8
    # (models/quant.py, ROADMAP A.6), which one 80 GB card serves
    "mixtral-8x7b": ModelConfig(
        name="mixtral-8x7b",
        vocab_size=32000,
        dim=4096,
        n_layers=32,
        n_heads=32,
        n_kv_heads=8,
        ffn_dim=14336,
        max_seq_len=32768,
        rope_theta=1000000.0,
        norm_eps=1e-5,
        n_experts=8,
        n_experts_active=2,
        moe_ffn_dim=14336,
        moe_scoring="softmax",
        moe_norm_topk=True,
    ),
    # DeepSeek-V3/R1 (671B-A37B): MLA + 256-expert MoE (sigmoid gates, a
    # selection bias, 8 groups keeping 4, routed scale 2.5, one shared
    # expert) with the first 3 layers dense. One card holds its first MoE
    # layer: get_config("deepseek-v3").with_(n_layers=4)
    "deepseek-v3": ModelConfig(
        name="deepseek-v3",
        vocab_size=129280,
        dim=7168,
        n_layers=61,
        n_heads=128,
        n_kv_heads=128,
        ffn_dim=18432,
        max_seq_len=163840,
        rope_theta=10000.0,
        norm_eps=1e-6,
        attn_type="mla",
        kv_lora_rank=512,
        q_lora_rank=1536,
        qk_rope_head_dim=64,
        qk_nope_head_dim=128,
        v_head_dim=128,
        n_experts=256,
        n_experts_active=8,
        moe_ffn_dim=2048,
        n_shared_experts=1,
        moe_scoring="sigmoid",
        moe_router_bias=True,
        moe_routed_scale=2.5,
        n_dense_layers=3,
        n_expert_groups=8,
        topk_groups=4,
        rope_scaling="yarn",
        rope_factor=40.0,
        rope_orig_max_seq=4096,
        rope_beta_fast=32.0,
        rope_beta_slow=1.0,
        rope_mscale=1.0,
        rope_mscale_all_dim=1.0,
    ),
    # Llama 3.1 70B (G 8): served only across ranks (--tensor-parallel);
    # its bf16 weights (141 GB) fit no one card
    "llama-3.1-70b": ModelConfig(
        name="llama-3.1-70b",
        vocab_size=128256,
        dim=8192,
        n_layers=80,
        n_heads=64,
        n_kv_heads=8,
        ffn_dim=28672,
        max_seq_len=131072,
        rope_scaling="llama3", rope_factor=8.0, rope_orig_max_seq=8192,
    ),
}


def get_config(name: str) -> ModelConfig:
    if name not in PRESETS:
        raise KeyError(f"unknown model config {name!r}; have {sorted(PRESETS)}")
    return PRESETS[name]
