"""Transformer building blocks: RMSNorm, RoPE (with llama3 and yarn
scaling, and Gemma-3's second base for sliding layers), the attention
score scale, each layer's sliding window, the
token-major paged KV pool (the latent pool for MLA; bf16 or the int8 dict
of models/quant.py) and its writer, and the plain gather attention that
every attention kernel is held against.

Port of dynamo_tpu/models/toolkit.py. Layouts and numerics follow it: the
pool is [L, NP, PS, Hk, D], norms and rope angles run in f32, and the
reference attention rounds its scores and probabilities through the query
dtype where the JAX einsums do.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch

from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.quant import kv_dequantize, kv_quantize

NEG_INF = -1e30
KV_QUANTIZE_MODES = ("int8",)


def kv_pool_shapes(config: ModelConfig, num_pages: int, page_size: int,
                   tp: int = 1):
    """The k and v pools' shapes (make_kv_pool); under tensor parallelism
    (tp ranks) one rank's, its Hk / tp heads."""
    if config.is_mla:
        return ((config.n_layers, num_pages, page_size, 1, config.mla_cache_dim),
                (config.n_layers, num_pages, page_size, 1, 1))
    shape = (config.n_layers, num_pages, page_size, config.n_kv_heads // tp,
             config.head_dim)
    return shape, shape


def kv_pool_bytes(config: ModelConfig, num_pages: int, page_size: int, dtype,
                  kv_quantize: Optional[str] = None, tp: int = 1) -> int:
    """Bytes make_kv_pool allocates (int8: codes and f32 scales), on one
    of tp ranks."""
    item = torch.empty((), dtype=dtype).element_size()
    total = 0
    for shape in kv_pool_shapes(config, num_pages, page_size, tp):
        n = math.prod(shape)
        total += n + 4 * (n // shape[-1]) if kv_quantize else n * item
    return total


def make_kv_pool(
    config: ModelConfig, num_pages: int, page_size: int, dtype, device,
    kv_quantize: Optional[str] = None, tp: int = 1,
):
    """Two zeroed pools [L, NP, PS, Hk, D], token-major: one page is one
    contiguous PS*Hk*D slab, and one token's [Hk, D] row is contiguous.

    MLA models cache one latent vector per token: the "k" pool is
    [L, NP, PS, 1, d_c + d_rh] and the "v" pool a 1-wide stub
    [L, NP, PS, 1, 1], so every page-indexed path (transfer, host tier)
    keeps its k/v shape contract.

    kv_quantize="int8" makes each pool the dict {"q": int8 [L, NP, PS, Hk,
    D], "s": f32 [L, NP, PS, Hk]} (models/quant.py), the MLA stub too.
    Under tensor parallelism (tp ranks) each is one rank's, Hk / tp heads
    (parallel/mesh.py: the reference's kv_pool_sharding_tree)."""
    if kv_quantize is not None and kv_quantize not in KV_QUANTIZE_MODES:
        raise ValueError(f"unknown kv_quantize mode {kv_quantize!r}")
    k_shape, v_shape = kv_pool_shapes(config, num_pages, page_size, tp)

    def zeros(shape):
        if kv_quantize is None:
            return torch.zeros(shape, dtype=dtype, device=device)
        return {"q": torch.zeros(shape, dtype=torch.int8, device=device),
                "s": torch.zeros(shape[:-1], dtype=torch.float32, device=device)}

    return zeros(k_shape), zeros(v_shape)


def is_quantized(pool) -> bool:
    """An int8 dict pool (or one layer of it)."""
    return isinstance(pool, dict)


def pool_values(pool) -> torch.Tensor:
    """The tensor that carries a pool's shape: the pool, or its "q"."""
    return pool["q"] if isinstance(pool, dict) else pool


def pool_layer(pool, l: int):
    """Layer l of a stacked pool: a view [NP, PS, Hk, D], or the dict of
    the layer's "q" and "s" views."""
    if isinstance(pool, dict):
        return {"q": pool["q"][l], "s": pool["s"][l]}
    return pool[l]


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float,
             zero_centered: bool = False) -> torch.Tensor:
    """RMSNorm in f32, cast back to the input dtype. zero_centered
    (Gemma): the weights store w and the output is normed * (1 + w)."""
    xf = x.float()
    normed = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    w = weight + 1.0 if zero_centered else weight
    return (normed * w).to(x.dtype)


def _yarn_mscale(scale: float, mscale: float) -> float:
    if scale <= 1.0 or mscale == 0.0:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def rope_mscale(config: Optional[ModelConfig]) -> float:
    """yarn's cos/sin magnitude mscale(factor, mscale) /
    mscale(factor, mscale_all_dim); 1 for every other scaling."""
    if config is None or config.rope_scaling != "yarn":
        return 1.0
    m = _yarn_mscale(config.rope_factor, config.rope_mscale)
    if config.rope_mscale_all_dim:
        m = m / _yarn_mscale(config.rope_factor, config.rope_mscale_all_dim)
    return m


def attn_score_scale(config: ModelConfig, qk_dim: int) -> float:
    """Softmax scale incl. yarn's mscale^2 correction (DeepSeek:
    qk_dim^-0.5 * mscale(factor, mscale_all_dim)^2)."""
    scale = qk_dim ** -0.5
    if config.rope_scaling == "yarn" and config.rope_mscale_all_dim:
        m = _yarn_mscale(config.rope_factor, config.rope_mscale_all_dim)
        scale = scale * m * m
    return scale


def gqa_score_scale(config: ModelConfig) -> Optional[float]:
    """The GQA softmax scale: Granite's attn_scale where the config sets
    it, else query_pre_attn_scalar^-0.5 where that is set (Gemma), else
    None (the kernels' head_dim^-0.5)."""
    if config.attn_scale:
        return config.attn_scale
    q = config.query_pre_attn_scalar
    return q ** -0.5 if q > 0 else None


def is_global_layer(config: ModelConfig, l: int) -> bool:
    """Layer l is global when l % sw_period == sw_global_residue."""
    return l % config.sw_period == config.sw_global_residue


def layer_window(config: ModelConfig, l: int) -> int:
    """Layer l's sliding window in tokens, 0 for a global layer or a
    config with no window."""
    c = config
    if c.sliding_window <= 0 or is_global_layer(c, l):
        return 0
    return c.sliding_window


def layer_rope(config: ModelConfig, l: int) -> int:
    """Which of rope_tables' tables layer l rotates with, a Python int:
    1 (the local base) for the sliding layers of a dual-RoPE config
    (Gemma-3's rope_local_theta), else 0."""
    return int(bool(config.rope_local_theta) and not is_global_layer(config, l))


def rope_inv_freq_np(config: Optional[ModelConfig], hd: int, theta: float) -> np.ndarray:
    """[hd//2] f32 inverse frequencies with the config's scaling applied,
    computed in float64 numpy and cast to f32 (HF rope_scaling semantics:
    "linear" divides every frequency by the factor (uniform position
    interpolation, Gemma-3's global layers at 8); "llama3" interpolates
    wavelengths past orig_max/low_freq_factor by 1/factor, keeps short
    ones, and blends a smooth band between; "yarn"
    blends interpolated and base frequencies per dim with a ramp between
    the beta_fast/beta_slow correction dims)."""
    half = hd // 2
    base = theta ** -(np.arange(0, half, dtype=np.float64) / half)
    if config is None or config.rope_scaling == "none":
        return base.astype(np.float32)
    c = config
    if c.rope_scaling == "linear":
        return (base / c.rope_factor).astype(np.float32)
    if c.rope_scaling == "llama3":
        orig = c.rope_orig_max_seq or c.max_seq_len
        wavelen = 2.0 * math.pi / base
        low_wl = orig / c.rope_low_freq_factor
        high_wl = orig / c.rope_high_freq_factor
        smooth = (orig / wavelen - c.rope_low_freq_factor) / max(
            c.rope_high_freq_factor - c.rope_low_freq_factor, 1e-9
        )
        smooth = np.clip(smooth, 0.0, 1.0)
        blended = (1 - smooth) * base / c.rope_factor + smooth * base
        out = np.where(
            wavelen < high_wl, base,
            np.where(wavelen > low_wl, base / c.rope_factor, blended),
        )
        return out.astype(np.float32)
    if c.rope_scaling == "yarn":
        orig = c.rope_orig_max_seq or c.max_seq_len

        def corr_dim(n_rot: float) -> float:
            return (hd * math.log(orig / (n_rot * 2 * math.pi))) / (
                2 * math.log(theta))

        low = max(math.floor(corr_dim(c.rope_beta_fast)), 0)
        high = min(math.ceil(corr_dim(c.rope_beta_slow)), hd - 1)
        ramp = np.clip(
            (np.arange(half, dtype=np.float64) - low) / max(high - low, 1),
            0.0, 1.0)
        extrap_mask = 1.0 - ramp  # 1 -> keep base (high-frequency dims)
        out = (base / c.rope_factor) * (1 - extrap_mask) + base * extrap_mask
        return out.astype(np.float32)
    raise ValueError(f"unsupported rope_scaling {c.rope_scaling!r}")


@functools.lru_cache(maxsize=16)
def rope_inv_freq(config: Optional[ModelConfig], hd: int, theta: float,
                  device: str = "cpu") -> torch.Tensor:
    """rope_inv_freq_np as a tensor on `device`, built once per config:
    a host-to-device copy inside the decode loop would wait for the
    device."""
    return torch.from_numpy(rope_inv_freq_np(config, hd, theta)).to(device)


def rope_cos_sin(positions: torch.Tensor, inv_freq: torch.Tensor,
                 mscale: float = 1.0):
    """cos/sin tables [..., S, 1, hd//2] in f32 for `positions` [..., S],
    scaled by `mscale` (yarn's magnitude, rope_mscale)."""
    angles = positions[..., None].float() * inv_freq
    cos, sin = torch.cos(angles), torch.sin(angles)
    if mscale != 1.0:
        cos, sin = cos * mscale, sin * mscale
    return cos[..., None, :], sin[..., None, :]


def rope_tables(config: ModelConfig, positions: torch.Tensor, hd: int):
    """The cos/sin tables of `positions` [..., S] that a forward's layers
    pick from by layer_rope: [rope_theta's, with the config's scaling]
    and, for a dual-RoPE config, rope_local_theta's, unscaled. A dual
    config's tables carry no yarn magnitude, as the reference's explicit
    inverse frequencies do not."""
    dev = str(positions.device)
    if not config.rope_local_theta:
        return [rope_cos_sin(positions, rope_inv_freq(config, hd, config.rope_theta, dev),
                             rope_mscale(config))]
    return [rope_cos_sin(positions, rope_inv_freq(config, hd, config.rope_theta, dev)),
            rope_cos_sin(positions, rope_inv_freq(None, hd, config.rope_local_theta, dev))]


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """HF-Llama half rotation of x [..., S, n_heads, hd], in f32."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
         config: Optional[ModelConfig] = None) -> torch.Tensor:
    """x: [..., S, n_heads, hd], positions [..., S]. `config` applies its
    rope_scaling (frequency remap, and yarn's cos/sin magnitude)."""
    inv_freq = rope_inv_freq(config, x.shape[-1], theta, str(x.device))
    cos, sin = rope_cos_sin(positions, inv_freq, rope_mscale(config))
    return apply_rope(x, cos, sin)


def softcap_scores(s: torch.Tensor, softcap: float) -> torch.Tensor:
    """Gemma-2 soft capping of scaled scores: cap * tanh(s / cap); a cap
    of 0 leaves them."""
    return softcap * torch.tanh(s / softcap) if softcap else s


def paged_attention_ref(
    q: torch.Tensor,  # [B, S, Hk, G, D] grouped query heads
    k_pool_l: torch.Tensor,  # [NP, PS, Hk, D] one layer's key pool
    v_pool_l: torch.Tensor,
    page_table: torch.Tensor,  # [B, MP] int32
    q_positions: torch.Tensor,  # [B, S] absolute positions of the queries
    kv_lens: torch.Tensor,  # [B] context length (tokens valid in the pool)
    scale: Optional[float] = None,
    softcap: float = 0.0,  # Gemma-2 score soft capping (0 = off)
    window: Optional[int] = None,  # sliding window (None or 0 = global)
) -> torch.Tensor:
    """Gather paged attention with causal masking by absolute position
    (flat context index c is absolute position c). Returns [B, S, Hk, G, Dv]
    (Dv, the value pool's width, may differ from the keys': MLA's values
    are the latent's first d_c columns); rows with an empty context come
    out 0. Scores are scaled, then soft-capped, then masked; with a
    window w > 0 a query at position p sees only positions c > p - w.
    Int8 dict pools are dequantized as they are gathered (the model's
    "ref" path; the kernels' plain versions fold the scales instead,
    paged_attention_int8_ref)."""
    B, MP = page_table.shape
    _, PS, Hk, D = pool_values(k_pool_l).shape
    C = MP * PS

    def gather(pool_l):
        if isinstance(pool_l, dict):  # int8: dequantized into q's dtype
            pool_l = kv_dequantize({k: x[page_table.long()] for k, x in pool_l.items()},
                                   q.dtype)
        else:
            pool_l = pool_l[page_table.long()]
        return pool_l.reshape(B, C, Hk, pool_l.shape[-1])

    k, v = gather(k_pool_l), gather(v_pool_l)
    if scale is None:
        scale = D ** -0.5
    scores = softcap_scores(
        torch.einsum("bskgd,bckd->bkgsc", q, k).float() * scale, softcap)
    mask = _attention_mask(C, q_positions, kv_lens, window)
    scores = torch.where(mask, scores, NEG_INF)
    m = scores.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(scores - m), 0.0)
    l = p.sum(-1, keepdim=True)
    probs = (p / l.clamp(min=1e-30)).to(q.dtype)
    return torch.einsum("bkgsc,bckd->bskgd", probs, v)


def _attention_mask(C: int, q_positions: torch.Tensor, kv_lens: torch.Tensor,
                    window: Optional[int]) -> torch.Tensor:
    """[B, 1, 1, S, C]: context position c counts for the query at
    position p when c < kv_len, c <= p and, with a window w > 0, c > p - w."""
    ctx_pos = torch.arange(C, device=q_positions.device)
    valid = (ctx_pos[None, :] < kv_lens[:, None])[:, None, None, None, :]
    causal = ctx_pos[None, None, :] <= q_positions[:, :, None]  # [B, S, C]
    if window is not None and window > 0:
        causal = causal & (ctx_pos[None, None, :] > q_positions[:, :, None] - window)
    return valid & causal[:, None, None, :, :]


def paged_attention_int8_ref(
    q: torch.Tensor,  # [B, S, Hk, G, D]
    k_pool_l: dict,  # {"q": int8 [NP, PS, Hk, D], "s": f32 [NP, PS, Hk]}
    v_pool_l: dict,  # the same, or MLA's value view (first d_c columns)
    page_table: torch.Tensor,
    q_positions: torch.Tensor,
    kv_lens: torch.Tensor,
    scale: Optional[float] = None,
    softcap: float = 0.0,
    window: Optional[int] = None,
) -> torch.Tensor:
    """The int8 attention kernels' plain version, in f32 in the TPU
    kernels' order (dynamo_tpu/ops/paged_attention.py
    `_decode_kernel_body`): s = (q . k_int) * scale, then s *= the key's
    scale, then the soft cap, then the mask; the denominator sums p; then
    p *= the value's scale and the output is (p . v_int) / l. Returns
    [B, S, Hk, G, Dv] in q's dtype; rows with an empty context come out 0."""
    B, MP = page_table.shape
    _, PS, Hk, D = k_pool_l["q"].shape
    C = MP * PS
    pages = page_table.long()
    k = k_pool_l["q"][pages].reshape(B, C, Hk, D).float()
    v = v_pool_l["q"][pages].reshape(B, C, Hk, -1).float()
    # per (row, head) scales laid out like the scores' last axes
    ks = k_pool_l["s"][pages].reshape(B, C, Hk).permute(0, 2, 1)[:, :, None, None]
    vs = v_pool_l["s"][pages].reshape(B, C, Hk).permute(0, 2, 1)[:, :, None, None]
    if scale is None:
        scale = D ** -0.5
    s = torch.einsum("bskgd,bckd->bkgsc", q.float(), k) * scale
    s = softcap_scores(s * ks, softcap)
    mask = _attention_mask(C, q_positions, kv_lens, window)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)  # before the value scale
    acc = torch.einsum("bkgsc,bckd->bskgd", p * vs, v)
    return (acc / l.clamp(min=1e-30).permute(0, 3, 1, 2, 4)).to(q.dtype)


def kv_rows(page_table: torch.Tensor, positions: torch.Tensor,
            num_pages: int, page_size: int) -> torch.Tensor:
    """Flat token-cell index [B*S] (int64) into a pool viewed as
    [L, NP*PS, Hk, D] for each written position. Padding (position -1)
    goes to the pool's LAST page, which the caller keeps out of its page
    allocator: JAX drops these rows as an out-of-bounds scatter, but
    index_copy_ has no drop mode and filtering the rows would wait for
    the device."""
    MP = page_table.shape[1]
    valid = positions >= 0
    pos = positions.clamp(min=0).long()
    page_of_pos = (pos // page_size).clamp(0, MP - 1)
    page_idx = torch.gather(page_table.long(), 1, page_of_pos)
    page_idx = torch.where(valid, page_idx, num_pages - 1)
    return (page_idx * page_size + pos % page_size).reshape(-1)


def write_kv(pool, l_idx: int, new: torch.Tensor, rows: torch.Tensor) -> None:
    """Write new [B, S, Hk, D] into layer `l_idx` of the pool at the
    token cells `rows` (from kv_rows), in place. An int8 dict pool
    quantizes the new rows (one scale per (token, head) vector) and writes
    "q" and "s" at the same cells."""
    if isinstance(pool, dict):
        L, NP, PS, Hk, D = pool["q"].shape
        d = kv_quantize(new.reshape(-1, Hk, D))
        pool["q"].view(L, NP * PS, Hk, D)[l_idx].index_copy_(0, rows, d["q"])
        pool["s"].view(L, NP * PS, Hk)[l_idx].index_copy_(0, rows, d["s"])
        return
    L, NP, PS, Hk, D = pool.shape
    pool.view(L, NP * PS, Hk, D)[l_idx].index_copy_(
        0, rows, new.reshape(-1, Hk, D).to(pool.dtype))
