"""Llama-family transformer over a paged KV cache: dense GQA layers (with
the branches of the other dense families), and the MLA (DeepSeek) layer
with a dense FFN.

Port of the dense GQA and the MLA branches of dynamo_tpu/models/llama.py
`forward`: embed, RMSNorm, q/k/v, RoPE, KV write, paged attention (MLA:
models/mla.py over the latent pool), wo, SwiGLU, final norm, last-position
gather and f32 logits, with the reference's `ragged=` branch (the flat
step of the fused mixed dispatch; GQA only, as there). The dense families'
branches, each as the reference has it: Qwen2's q/k/v biases (added after
the product, in the params' dtype); Qwen3's per-head qk-norm before RoPE
and OLMo-2's over the full projection width, with OLMo-2's post norms
only (`pre_norms=False`); Granite's embedding and residual multipliers,
attention scale and logit divider; Gemma's embedding scaled by sqrt(dim),
zero-centred norms, GeGLU, Gemma-2's post-attention and post-FFN norms,
each layer's sliding window (a Python int per layer, toolkit.layer_window;
Mistral and Phi-3 slide on every layer) with the score scale and soft cap
on every attention route, and the final-logit soft cap; Gemma-3's second
RoPE base on its sliding layers (toolkit.layer_rope). MoE layers are not
ported (ROADMAP A.9): MoE configs raise. Params are
a plain dict of tensors in the reference's stacked layout ({"embed",
"norm_f", "layers": {"wq": [L, in, out], ...}}, x @ W), so one checkpoint
tree serves both packages. The layer loop is a Python loop over that
stack; matrix products go to torch.matmul, attention to the ops/ kernels.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.mla import mla_attention
from dynamo_tpu_torch.models.toolkit import (
    apply_rope,
    gqa_score_scale,
    kv_rows,
    layer_rope,
    layer_window,
    paged_attention_ref,
    pool_layer,
    pool_values,
    rms_norm,
    rope_tables,
    write_kv,
)
from dynamo_tpu_torch.ops.flash_prefill import prefill_paged_attention
from dynamo_tpu_torch.ops.paged_attention import decode_paged_attention
from dynamo_tpu_torch.ops.ragged_paged_attention import (
    ragged_paged_attention,
    ragged_paged_attention_ref,
    ragged_token_index,
)

Params = Dict[str, Any]

# attention paths of `forward`: "kernel" dispatches to the ops/ wrappers
# (the Hopper kernels on CUDA tensors, their plain versions on CPU
# tensors); "ref" runs the gather reference, the port of the JAX "jnp" path
ATTN_IMPLS = ("kernel", "ref")


def _refuse_moe(c: ModelConfig) -> None:
    if c.is_moe:
        raise NotImplementedError(
            f"{c.name}: MoE layers are not ported yet (ROADMAP A.9); serve "
            "the dense layers with .with_(n_layers=n_dense_layers, n_experts=0)")


def init_params(config: ModelConfig, seed: int, dtype, device) -> Params:
    """Random-init params from a seeded generator on `device` (weights
    ~ N(0, 1/fan_in), biases 0, norms 1, or 0 where they are
    zero-centred). Same tree and scales as the reference's init_params;
    the numbers differ (another generator)."""
    c = config
    _refuse_moe(c)
    g = torch.Generator(device=device).manual_seed(seed)
    hd, L = c.head_dim, c.n_layers

    def w(fan_in, *shape):
        x = torch.randn(shape, generator=g, device=device, dtype=torch.float32)
        return x.mul_(fan_in ** -0.5).to(dtype)

    def norm(*shape):
        # zero-centred norms (Gemma) store w with output normed * (1 + w)
        fill = 0.0 if c.norm_zero_centered else 1.0
        return torch.full(shape, fill, dtype=torch.float32, device=device)

    # draws in the order of the dense tree: embed, then the layers
    embed = w(c.dim, c.vocab_size, c.dim)
    if c.is_mla:
        # KV compressed to a per-token latent + the shared RoPE key; q
        # optionally compressed too
        H, dn, dr, dv = c.n_heads, c.qk_nope_head_dim, c.qk_rope_head_dim, c.v_head_dim
        layers = {
            "wkv_a": w(c.dim, L, c.dim, c.kv_lora_rank + dr),
            "kv_norm": norm(L, c.kv_lora_rank),
            "wkv_b": w(c.kv_lora_rank, L, c.kv_lora_rank, H * (dn + dv)),
            "wo": w(H * dv, L, H * dv, c.dim),
        }
        if c.q_lora_rank:
            layers["wq_lat"] = w(c.dim, L, c.dim, c.q_lora_rank)
            layers["q_lat_norm"] = norm(L, c.q_lora_rank)
            layers["wq_up"] = w(c.q_lora_rank, L, c.q_lora_rank, H * (dn + dr))
        else:
            layers["wq"] = w(c.dim, L, c.dim, H * (dn + dr))
    else:
        layers = {
            "wq": w(c.dim, L, c.dim, c.n_heads * hd),
            "wk": w(c.dim, L, c.dim, c.n_kv_heads * hd),
            "wv": w(c.dim, L, c.dim, c.n_kv_heads * hd),
            "wo": w(c.n_heads * hd, L, c.n_heads * hd, c.dim),
        }
        if c.attn_bias:  # Qwen2
            layers["bq"] = torch.zeros(L, c.n_heads * hd, dtype=dtype, device=device)
            layers["bk"] = torch.zeros(L, c.n_kv_heads * hd, dtype=dtype, device=device)
            layers["bv"] = torch.zeros(L, c.n_kv_heads * hd, dtype=dtype, device=device)
        if c.qk_norm:  # per head (Qwen3, Gemma-3) or full width (OLMo-2)
            wide = c.qk_norm_wide
            layers["q_norm"] = norm(L, c.n_heads * hd if wide else hd)
            layers["k_norm"] = norm(L, c.n_kv_heads * hd if wide else hd)
    if c.pre_norms or c.is_mla:
        layers["attn_norm"] = norm(L, c.dim)
        layers["mlp_norm"] = norm(L, c.dim)
    layers.update({
        "w_gate": w(c.dim, L, c.dim, c.ffn_dim),
        "w_up": w(c.dim, L, c.dim, c.ffn_dim),
        "w_down": w(c.ffn_dim, L, c.ffn_dim, c.dim),
    })
    if c.post_norms:  # Gemma-2 sandwich norms on the residual branches
        layers["post_attn_norm"] = norm(L, c.dim)
        layers["post_mlp_norm"] = norm(L, c.dim)
    params: Params = {"embed": embed, "norm_f": norm(c.dim), "layers": layers}
    if not c.tie_embeddings:
        params["lm_head"] = w(c.dim, c.dim, c.vocab_size)
    return params


def forward(
    config: ModelConfig,
    params: Params,
    tokens: torch.Tensor,  # [B, S]
    positions: torch.Tensor,  # [B, S] absolute positions (padding = -1)
    k_pool,  # [L, NP, PS, Hk, D] (or its int8 dict); the last page takes padding
    v_pool,
    page_table: Optional[torch.Tensor] = None,  # [B, MP] int32
    kv_lens: Optional[torch.Tensor] = None,  # [B] int32 context AFTER this step
    last_index: Optional[Union[int, torch.Tensor]] = None,  # int or [B]
    attn_impl: str = "kernel",
    ragged: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """One forward pass (prefill chunk S > 1 or decode S = 1). Writes this
    step's K/V into the pools in place, attends over the full context and
    returns f32 logits [B, S, V], or [B, 1, V] at `last_index` only.
    Padding tokens' K/V land in the pools' last page (see kv_rows): the
    caller never hands that page out.

    `ragged=(seg_page_table [SEG, MP], seg_kv_lens [SEG], meta [5, NW])`
    (ops/ragged_paged_attention.build_ragged_metadata, default q block)
    makes it the flat mixed step: tokens and positions come in [1, T] and
    page_table / kv_lens are not used. Each token's KV write goes through
    its segment's table row (the step viewed as B=T, S=1), with the token's
    segment derived from `meta` on the device rather than uploaded as a
    [T, MP] table; attention is ragged; last_index holds the flat
    per-segment last-token indices [SEG] and the logits come back
    [1, SEG, V]. MLA configs refuse `ragged=`, as the reference does; their
    v_pool is the 1-wide stub and is not written. Int8 dict pools
    (models/quant.py) quantize on write and reach the kernels' int8
    bodies (the "ref" path dequantizes on its gather)."""
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}")
    c = config
    _refuse_moe(c)
    B, S = tokens.shape
    hd = c.head_dim
    G = c.n_heads // c.n_kv_heads
    lp = params["layers"]
    L, NP, PS = pool_values(k_pool).shape[:3]
    zc = c.norm_zero_centered
    # the scale and soft cap of every GQA attention route (None and 0 for
    # Llama: the kernels' defaults)
    attn_kw = dict(scale=gqa_score_scale(c), softcap=c.attn_logit_softcap)
    act = ((lambda x: F.gelu(x, approximate="tanh")) if c.act == "gelu_tanh"
           else F.silu)

    def in_dtype(x: float, like: torch.Tensor) -> float:
        # a multiplier rounded through the activations' dtype, as the
        # reference's jnp.asarray(m, h.dtype)
        return float(torch.tensor(x, dtype=like.dtype))

    h = params["embed"][tokens.long()]  # [B, S, E]
    if c.embed_multiplier:  # Granite
        h = h * in_dtype(c.embed_multiplier, h)
    elif c.embed_scale:  # Gemma: sqrt(dim)
        h = h * in_dtype(c.dim ** 0.5, h)
    safe_pos = positions.clamp(min=0)
    # one cos/sin table, or Gemma-3's two (global, local) picked per layer
    ropes = rope_tables(c, safe_pos, c.qk_rope_head_dim if c.is_mla else hd)
    # Granite's branch multiplier in the activations' dtype (1 elsewhere)
    rm = in_dtype(c.residual_multiplier, h)
    if ragged is not None:
        if B != 1:
            raise ValueError("ragged forward takes a single flat [1, T] row")
        if c.is_mla:
            raise NotImplementedError(
                "ragged mixed forward is not supported for MLA models")
        seg_pt, seg_kvl, meta = ragged
        tok_seg, _ = ragged_token_index(meta, S)
        rows = kv_rows(seg_pt[tok_seg], positions.view(S, 1), NP, PS)
        ragged_attn = (ragged_paged_attention_ref if attn_impl == "ref"
                       else ragged_paged_attention)
    else:
        rows = kv_rows(page_table, positions, NP, PS)
        # prefill-kernel metadata: valid tokens are a contiguous run from
        # s=0 (ModelRunner contract), so start/len fully describe them
        q_start = safe_pos[:, 0].to(torch.int32).contiguous()
        q_len = (positions >= 0).sum(1, dtype=torch.int32)

    for l in range(c.n_layers):
        if c.is_mla:
            attn = mla_attention(c, lp, h, k_pool, l, rows, page_table,
                                 ropes[0], safe_pos, kv_lens, q_start,
                                 q_len, attn_impl)
        else:
            # OLMo-2 (pre_norms=False): the sublayer reads the raw residual
            x = (rms_norm(h, lp["attn_norm"][l], c.norm_eps, zero_centered=zc)
                 if c.pre_norms else h)
            q, k, v = x @ lp["wq"][l], x @ lp["wk"][l], x @ lp["wv"][l]
            if c.attn_bias:  # Qwen2: after the product, in the params' dtype
                q, k, v = q + lp["bq"][l], k + lp["bk"][l], v + lp["bv"][l]
            if c.qk_norm and c.qk_norm_wide:  # OLMo-2: over the full width
                q = rms_norm(q, lp["q_norm"][l], c.norm_eps, zero_centered=zc)
                k = rms_norm(k, lp["k_norm"][l], c.norm_eps, zero_centered=zc)
            q = q.view(B, S, c.n_heads, hd)
            k = k.view(B, S, c.n_kv_heads, hd)
            v = v.view(B, S, c.n_kv_heads, hd)
            if c.qk_norm and not c.qk_norm_wide:  # Qwen3, Gemma-3: per head
                q = rms_norm(q, lp["q_norm"][l], c.norm_eps, zero_centered=zc)
                k = rms_norm(k, lp["k_norm"][l], c.norm_eps, zero_centered=zc)
            cos, sin = ropes[layer_rope(c, l)]
            q = apply_rope(q, cos, sin)
            k = apply_rope(k, cos, sin)
            write_kv(k_pool, l, k, rows)
            write_kv(v_pool, l, v, rows)
            qg = q.view(B, S, c.n_kv_heads, G, hd)
            win = layer_window(c, l)
            k_l, v_l = pool_layer(k_pool, l), pool_layer(v_pool, l)
            if ragged is not None:
                attn = ragged_attn(qg[0], k_l, v_l, seg_pt, seg_kvl, meta, win,
                                   **attn_kw)[None]
            elif attn_impl == "ref":
                attn = paged_attention_ref(
                    qg, k_l, v_l, page_table, safe_pos, kv_lens, window=win,
                    **attn_kw)
            elif S == 1:
                attn = decode_paged_attention(
                    qg[:, 0], k_l, v_l, page_table, kv_lens, win,
                    **attn_kw)[:, None]
            else:
                attn = prefill_paged_attention(
                    qg, k_l, v_l, page_table, q_start, q_len, kv_lens, win,
                    **attn_kw)
            attn = attn.reshape(B, S, c.n_heads * hd)
        attn_out = attn @ lp["wo"][l]
        if c.post_norms:  # Gemma-2, OLMo-2: norm the branch before the residual
            attn_out = rms_norm(attn_out, lp["post_attn_norm"][l], c.norm_eps,
                                zero_centered=zc)
        if rm != 1.0:  # Granite: scale the branch
            attn_out = attn_out * rm
        h = h + attn_out
        x = (rms_norm(h, lp["mlp_norm"][l], c.norm_eps, zero_centered=zc)
             if c.pre_norms or c.is_mla else h)
        gate = act(x @ lp["w_gate"][l])
        ffw = (gate * (x @ lp["w_up"][l])) @ lp["w_down"][l]
        if c.post_norms:
            ffw = rms_norm(ffw, lp["post_mlp_norm"][l], c.norm_eps,
                           zero_centered=zc)
        if rm != 1.0:
            ffw = ffw * rm
        h = h + ffw

    if last_index is not None:
        if isinstance(last_index, int):
            h = h[:, last_index:last_index + 1]
        elif ragged is not None:  # flat per-segment last tokens
            h = h[:, last_index.long()]
        else:  # per-row last positions
            idx = last_index.long().view(B, 1, 1).expand(B, 1, h.shape[-1])
            h = torch.gather(h, 1, idx)
    h = rms_norm(h, params["norm_f"], c.norm_eps, zero_centered=zc)
    lm_head = params.get("lm_head")
    logits = (h @ (params["embed"].T if lm_head is None else lm_head)).float()
    if c.logits_divider != 1.0:  # Granite
        logits = logits / c.logits_divider
    if c.final_logit_softcap:
        cap = c.final_logit_softcap
        logits = cap * torch.tanh(logits / cap)
    return logits
