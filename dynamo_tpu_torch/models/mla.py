"""Multi-head latent attention (DeepSeek V2/V3/R1): the MLA family's one
divergence from the dense layer, attention in absorbed form over a
per-token latent cache instead of full-head K/V pools.

Port of dynamo_tpu/models/mla.py `_mla_attention` (bf16 or int8 latent
pool, no tensor parallelism). Per token the pool caches one [d_c + d_rh]
vector: the RMS-normed KV latent c_kv, then the RoPE'd shared key k_R.
W_UK is absorbed into the query (q_abs = q_nope @ W_UK), so scores are
q_abs . c_kv + q_R . k_R, i.e. paged attention with one KV head, all
query heads in its group, keys = the latent and values = its first d_c
columns; W_UV then lifts the attended latent to per-head values. The absorption and the lift
are batched matrix products left to torch.einsum, as the reference leaves
them to XLA; attention goes to ops/mla_attention.py.

The int8 latent pool ({"q", "s"}, models/quant.py): decode goes to the
int8 MLA decode kernel on every CUDA tensor (the reference takes its
Pallas kernel only under DYN_MLA_INT8_KERNEL), prefill and the "ref" path
to the reference's gather over the dequantized latent, the values being
{"q": q[..., :d_c], "s": s} (one scale a vector, so the column slice
keeps it exact). As there, there is no int8 prefill kernel.
"""

from __future__ import annotations

from typing import Tuple

import torch

from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.toolkit import (
    apply_rope,
    attn_score_scale,
    is_quantized,
    paged_attention_ref,
    pool_layer,
    rms_norm,
    write_kv,
)
from dynamo_tpu_torch.ops.mla_attention import (
    decode_mla_attention,
    prefill_mla_attention,
)


def mla_attention(
    c: ModelConfig,
    lp,  # the stacked layer params
    h: torch.Tensor,  # [B, S, E] residual stream
    k_pool,  # [L, NP, PS, 1, d_c + d_rh] latent pool, or its int8 dict
    l: int,  # layer index
    rows: torch.Tensor,  # [B*S] token cells to write (toolkit.kv_rows)
    page_table: torch.Tensor,  # [B, MP] int32
    rope_cs: Tuple[torch.Tensor, torch.Tensor],  # cos/sin [B, S, 1, d_rh/2]
    safe_pos: torch.Tensor,  # [B, S] positions, padding clamped to 0
    kv_lens: torch.Tensor,  # [B] int32 context after this step
    q_start: torch.Tensor,  # [B] int32 (prefill kernel metadata)
    q_len: torch.Tensor,  # [B] int32
    attn_impl: str,  # "kernel" | "ref"
) -> torch.Tensor:
    """Writes this step's latents into layer `l` of the pool in place and
    returns the attention output [B, S, H * d_v] (before wo)."""
    B, S = safe_pos.shape
    H = c.n_heads
    dn, dr, dv, dc = (c.qk_nope_head_dim, c.qk_rope_head_dim, c.v_head_dim,
                      c.kv_lora_rank)
    cos, sin = rope_cs

    x = rms_norm(h, lp["attn_norm"][l], c.norm_eps)
    if c.q_lora_rank:
        q_lat = rms_norm(x @ lp["wq_lat"][l], lp["q_lat_norm"][l], c.norm_eps)
        q = q_lat @ lp["wq_up"][l]
    else:
        q = x @ lp["wq"][l]
    q = q.view(B, S, H, dn + dr)
    q_nope, q_r = q[..., :dn], apply_rope(q[..., dn:], cos, sin)

    kv = x @ lp["wkv_a"][l]  # [B, S, d_c + d_rh]
    c_kv = rms_norm(kv[..., :dc], lp["kv_norm"][l], c.norm_eps)
    k_r = apply_rope(kv[..., None, dc:], cos, sin)[..., 0, :]
    write_kv(k_pool, l, torch.cat([c_kv, k_r], -1)[:, :, None, :], rows)
    lat_l = pool_layer(k_pool, l)
    quantized = is_quantized(lat_l)

    wkv_b = lp["wkv_b"][l].view(dc, H, dn + dv)
    w_uk, w_uv = wkv_b[..., :dn], wkv_b[..., dn:]
    q_abs = torch.einsum("bshn,chn->bshc", q_nope, w_uk)  # [B, S, H, d_c]
    qp = torch.cat([q_abs, q_r], -1)  # [B, S, H, d_c + d_rh]
    scale = attn_score_scale(c, dn + dr)
    if attn_impl == "ref" or (quantized and S > 1):
        # the gather; an int8 latent's values keep its per-vector scale
        val = ({"q": lat_l["q"][..., :dc], "s": lat_l["s"]} if quantized
               else lat_l[..., :dc])
        attn_lat = paged_attention_ref(
            qp[:, :, None], lat_l, val, page_table, safe_pos, kv_lens,
            scale)[:, :, 0]
    elif S == 1:
        attn_lat = decode_mla_attention(
            qp[:, 0].contiguous(), lat_l, page_table, kv_lens, dc=dc,
            scale=scale)[:, None]
    else:
        attn_lat = prefill_mla_attention(
            qp, lat_l, page_table, q_start, q_len, kv_lens, dc=dc, scale=scale)
    attn = torch.einsum("bshc,chv->bshv", attn_lat, w_uv)
    return attn.reshape(B, S, H * dv)
