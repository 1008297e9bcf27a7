"""Carry a parameter tree into the port.

The reference's params are a stacked numpy-convertible tree
({"embed", "norm_f", "lm_head"?, "layers": {"wq": [L, in, out], ...}};
MLA layers hold wkv_a, kv_norm, wkv_b, wo and wq or wq_lat, q_lat_norm,
wq_up; the dense families' branches add bq, bk, bv (Qwen2), q_norm and
k_norm (per head [L, hd], or OLMo-2's full width [L, H * hd]) and
post_attn_norm, post_mlp_norm (Gemma-2, OLMo-2; OLMo-2 has no
attn_norm or mlp_norm)) in x @ W layout; the port's forward reads exactly
that layout, so this is a checked copy onto the device. Norm weights stay
f32, as in the reference; matrices and biases take `dtype`.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from dynamo_tpu_torch.models.config import ModelConfig

NORMS = ("norm_f", "attn_norm", "mlp_norm", "kv_norm", "q_lat_norm",
         "post_attn_norm", "post_mlp_norm", "q_norm", "k_norm")


def _expected_shapes(c: ModelConfig) -> Dict[str, tuple]:
    hd, L = c.head_dim, c.n_layers
    shapes = {"embed": (c.vocab_size, c.dim), "norm_f": (c.dim,)}
    if c.is_mla:
        H, dn, dr, dv = c.n_heads, c.qk_nope_head_dim, c.qk_rope_head_dim, c.v_head_dim
        shapes.update({
            "wkv_a": (L, c.dim, c.kv_lora_rank + dr),
            "kv_norm": (L, c.kv_lora_rank),
            "wkv_b": (L, c.kv_lora_rank, H * (dn + dv)),
            "wo": (L, H * dv, c.dim),
        })
        if c.q_lora_rank:
            shapes.update({
                "wq_lat": (L, c.dim, c.q_lora_rank),
                "q_lat_norm": (L, c.q_lora_rank),
                "wq_up": (L, c.q_lora_rank, H * (dn + dr)),
            })
        else:
            shapes["wq"] = (L, c.dim, H * (dn + dr))
    else:
        shapes.update({
            "wq": (L, c.dim, c.n_heads * hd),
            "wk": (L, c.dim, c.n_kv_heads * hd),
            "wv": (L, c.dim, c.n_kv_heads * hd),
            "wo": (L, c.n_heads * hd, c.dim),
        })
        if c.attn_bias:
            shapes.update({"bq": (L, c.n_heads * hd), "bk": (L, c.n_kv_heads * hd),
                           "bv": (L, c.n_kv_heads * hd)})
        if c.qk_norm:
            wide = c.qk_norm_wide
            shapes["q_norm"] = (L, c.n_heads * hd if wide else hd)
            shapes["k_norm"] = (L, c.n_kv_heads * hd if wide else hd)
    if c.pre_norms or c.is_mla:
        shapes["attn_norm"] = shapes["mlp_norm"] = (L, c.dim)
    shapes.update({
        "w_gate": (L, c.dim, c.ffn_dim),
        "w_up": (L, c.dim, c.ffn_dim),
        "w_down": (L, c.ffn_dim, c.dim),
    })
    if c.post_norms:
        shapes["post_attn_norm"] = (L, c.dim)
        shapes["post_mlp_norm"] = (L, c.dim)
    if not c.tie_embeddings:
        shapes["lm_head"] = (c.dim, c.vocab_size)
    return shapes


def params_from_numpy(tree: Mapping[str, Any], config: ModelConfig,
                      device, dtype=torch.bfloat16) -> Dict[str, Any]:
    """numpy (or array-like) tree -> the port's params dict on `device`.
    Raises on a missing or an extra leaf (a branch the config does not
    run) or a shape that does not match `config`."""
    want = _expected_shapes(config)
    flat = {k: v for k, v in tree.items() if k != "layers"}
    flat.update(tree["layers"])
    extra = sorted(set(flat) - set(want))
    if extra:
        raise KeyError(f"param tree has leaves {config.name} does not use: {extra}")

    def conv(name):
        if name not in flat:
            raise KeyError(f"param tree lacks {name!r}")
        arr = np.asarray(flat[name], dtype=np.float32)
        if arr.shape != want[name]:
            raise ValueError(f"{name}: shape {arr.shape}, config wants {want[name]}")
        t = torch.tensor(arr)  # a copy: the source may be read-only
        return t.to(device=device, dtype=torch.float32 if name in NORMS else dtype)

    top = {"embed", "norm_f", "lm_head"}
    out: Dict[str, Any] = {n: conv(n) for n in want if n in top}
    out["layers"] = {n: conv(n) for n in want if n not in top}
    return out
