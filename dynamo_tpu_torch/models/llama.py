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
RoPE base on its sliding layers (toolkit.layer_rope). `encode` is the
reference's embedding forward. MoE layers
(Mixtral, Qwen3-MoE, DeepSeek) run models/moe.py's block in place of the
dense FFN, as the reference's `use_moe` layers do; a config with
`n_dense_layers` keeps its leading dense-FFN layers in a second stack
`layers_dense` (DeepSeek's first_k_dense_replace). Params are a plain
dict of tensors in the reference's stacked layout ({"embed", "norm_f",
"layers": {"wq": [L, in, out], ...}, "layers_dense"?}, x @ W), so one
checkpoint tree serves both packages. The layer loop is a Python loop over
those stacks; matrix products go through models/quant.py `mm` (torch.matmul
on a plain weight, the weight-only GEMM on a quantized one), the embedding
through `embed_lookup` and the tied head through `tied_logits`, as the
reference's do; attention goes to the ops/ kernels, the routed experts to
the grouped GEMM (ops/moe_dispatch.py). A quantized tree (`init_params(...,
quantize=)`, quant.quantize_params, or the reference's through
engine/weights.py) holds {"q", "s"} leaves in place of the matrices named
in quant.DEFAULT_QUANT_NAMES.
"""

from __future__ import annotations

import math
from typing import Any, Collection, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from dynamo_tpu_torch.models import lora as lora_mod
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.mla import mla_attention
from dynamo_tpu_torch.models.moe import moe_block
from dynamo_tpu_torch.models.quant import (
    CODE_DTYPES,
    DEFAULT_QUANT_NAMES,
    QUANT_MODES,
    check_tree,
    embed_lookup,
    mm,
    quantize_embed,
    quantize_weight,
    quantized_bytes,
    tied_logits,
)
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
    rope,
    rope_tables,
    write_kv,
)
from dynamo_tpu_torch.ops.flash_prefill import (
    prefill_paged_attention,
    prefill_paged_attention_sharded,
)
from dynamo_tpu_torch.parallel.mesh import cut, expert_cut, leaf_shape, param_cut
from dynamo_tpu_torch.ops.paged_attention import (
    decode_paged_attention,
    decode_paged_attention_sharded,
)
from dynamo_tpu_torch.ops.quant_gemm import weight_at
from dynamo_tpu_torch.ops.ragged_paged_attention import (
    ragged_paged_attention,
    ragged_paged_attention_ref,
    ragged_paged_attention_sharded,
    ragged_token_index,
)

Params = Dict[str, Any]

# paths of `forward`: "kernel" dispatches attention and the routed experts
# to the ops/ wrappers (the Hopper kernels on CUDA tensors, their plain
# versions on CPU tensors); "ref" runs the gather reference and the
# every-expert MoE, the port of the JAX "jnp" path
ATTN_IMPLS = ("kernel", "ref")


class LayerView:
    """One layer of a stacked tree: lp[name] is stack[name][i] (the
    reference's scan body sees the same slice; a quantized leaf's codes
    and scales each sliced)."""

    __slots__ = ("stack", "i")

    def __init__(self, stack: Dict[str, Any], i: int):
        self.stack, self.i = stack, i

    def __getitem__(self, name: str):
        return weight_at(self.stack[name], self.i)

    def __contains__(self, name: str) -> bool:
        return name in self.stack

    def get(self, name: str, default=None):
        return self[name] if name in self.stack else default


def layer_params(c: ModelConfig, params: Params, l: int) -> Tuple[LayerView, bool]:
    """Layer l's params and whether its FFN is the MoE block: the
    `layers_dense` stack for the leading n_dense_layers of a MoE config,
    then `layers`, as the reference's two scans."""
    kD = c.n_dense_layers if c.is_moe else 0
    if l < kD:
        return LayerView(params["layers_dense"], l), False
    return LayerView(params["layers"], l - kD), c.is_moe


def moe_layer_count(c: ModelConfig) -> int:
    """Layers whose FFN is the MoE block (layer_params)."""
    return c.n_layers - c.n_dense_layers if c.is_moe else 0


# the params tree's leaves by kind: norm weights (f32)
NORM_LEAVES = ("norm_f", "attn_norm", "mlp_norm", "kv_norm", "q_lat_norm",
               "post_attn_norm", "post_mlp_norm", "q_norm", "k_norm")
# leaves kept in f32 whatever the params' dtype
F32_LEAVES = NORM_LEAVES + ("router_bias",)
# leaves a tree may hold or not (checkpoint-dependent)
OPTIONAL_LEAVES = ("ws_gatectl",)
# leaves the init fills with 0 (Qwen2's biases, V3's selection bias)
ZERO_LEAVES = ("bq", "bk", "bv", "router_bias")


def _stack_shapes(c: ModelConfig, L: int, moe: bool) -> Dict[str, tuple]:
    """The leaves of a stack of L layers: attention and either the dense
    FFN or the MoE block."""
    hd = c.head_dim
    shapes: Dict[str, tuple] = {}
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
    if moe:
        n, F_ = c.n_experts, c.moe_ffn_dim
        shapes.update({
            "w_router": (L, c.dim, n),
            "we_gate": (L, n, c.dim, F_),
            "we_up": (L, n, c.dim, F_),
            "we_down": (L, n, F_, c.dim),
        })
        if c.moe_router_bias:
            shapes["router_bias"] = (L, n)
        if c.n_shared_experts:
            sf = c.shared_ffn_dim
            shapes.update({"ws_gate": (L, c.dim, sf), "ws_up": (L, c.dim, sf),
                           "ws_down": (L, sf, c.dim), "ws_gatectl": (L, c.dim, 1)})
    else:
        shapes.update({
            "w_gate": (L, c.dim, c.ffn_dim),
            "w_up": (L, c.dim, c.ffn_dim),
            "w_down": (L, c.ffn_dim, c.dim),
        })
    if c.post_norms:
        shapes["post_attn_norm"] = (L, c.dim)
        shapes["post_mlp_norm"] = (L, c.dim)
    return shapes


def param_shapes(c: ModelConfig) -> Dict[str, Any]:
    """The tree's shapes: the top leaves, "layers" and, where the config
    has leading dense layers beside its MoE ones, "layers_dense" (each a
    dict of leaf -> shape; OPTIONAL_LEAVES may be absent). Nothing is
    allocated."""
    shapes: Dict[str, Any] = {"embed": (c.vocab_size, c.dim), "norm_f": (c.dim,)}
    if c.is_moe and c.n_dense_layers:
        shapes["layers_dense"] = _stack_shapes(c, c.n_dense_layers, moe=False)
        shapes["layers"] = _stack_shapes(c, c.n_layers - c.n_dense_layers, moe=True)
    else:
        shapes["layers"] = _stack_shapes(c, c.n_layers, moe=c.is_moe)
    if not c.tie_embeddings:  # last: init_params draws in this order
        shapes["lm_head"] = (c.dim, c.vocab_size)
    return shapes


def param_bytes(c: ModelConfig, dtype=torch.bfloat16,
                quantize: Optional[str] = None,
                only: Optional[Collection[str]] = None, tp: int = 1, ep: int = 1) -> int:
    """Bytes of the params `init_params` or `params_from_numpy` place:
    `dtype` matrices and biases, f32 norms and router bias (optional
    leaves not counted); with `quantize`, the matrices of
    DEFAULT_QUANT_NAMES as one-byte codes and f32 scales. `only`: count
    just the leaves of those names. `tp` / `ep`: one rank's slices over tp
    model and ep expert ranks (parallel/mesh.py)."""
    item = torch.empty((), dtype=dtype).element_size()

    def size(name, shape):
        if only is not None and name not in only:
            return 0
        shape = leaf_shape(name, shape, tp, ep)
        if quantize and name in DEFAULT_QUANT_NAMES:
            return quantized_bytes(shape, quantize, embed=name == "embed")
        return math.prod(shape) * (4 if name in F32_LEAVES else item)

    total = 0
    for name, v in param_shapes(c).items():
        if isinstance(v, dict):
            total += sum(size(n, sh) for n, sh in v.items()
                         if n not in OPTIONAL_LEAVES)
        else:
            total += size(name, v)
    return total


def init_params(config: ModelConfig, seed: int, dtype, device,
                quantize: Optional[str] = None, rank: int = 0, tp: int = 1,
                ep_rank: int = 0, ep: int = 1) -> Params:
    """Random-init params from a seeded generator on `device`: the tree of
    param_shapes (the reference's init_params tree, `layers_dense`
    included), weights ~ N(0, 1/fan_in) in `dtype`, biases and the router
    bias 0, norms 1 (0 where they are zero-centred) in f32. The numbers
    differ from the reference's (another generator). With `quantize`
    ("int8" or "fp8") the leaves of DEFAULT_QUANT_NAMES come quantized,
    each matrix as it is drawn (quant.quantize_params of the tree drawn
    without it, bit for bit): a whole bf16 stack is never held (one of
    mixtral-8x7b's expert stacks is 30 GB). On a mesh it is the slice of
    that tree of model rank `rank` of `tp` and expert rank `ep_rank` of
    `ep` (parallel/mesh.py), bit for bit: each matrix is drawn whole, in
    param_shapes order, and the rank's part kept (another rank's expert
    drawn and dropped), so at most one whole matrix is transient
    (quantized trees are not cut: parallel/mesh.py check_tp refuses
    them)."""
    c = config
    if quantize is not None and quantize not in QUANT_MODES:
        raise ValueError(f"unknown quantize mode {quantize!r}; one of {QUANT_MODES}")
    g = torch.Generator(device=device).manual_seed(seed)

    def leaf(name, full):
        dim = param_cut(name)
        shape = leaf_shape(name, full, tp, ep)
        if name in NORM_LEAVES:  # zero-centred (Gemma): normed * (1 + w)
            fill = 0.0 if c.norm_zero_centered else 1.0
            return torch.full(shape, fill, dtype=torch.float32, device=device)
        if name in ZERO_LEAVES:
            return torch.zeros(shape, device=device,
                               dtype=torch.float32 if name in F32_LEAVES else dtype)
        # weights are [..., in, out] (embed [V, dim]), drawn one matrix at a
        # time into the result: a whole stack in f32 would be twice its
        # bf16 bytes (qwen3-30b-a3b's we_gate: 38.7 GB)
        scale = full[-1 if name == "embed" else -2] ** -0.5
        if quantize and name in DEFAULT_QUANT_NAMES:
            return quantized_leaf(name, shape, scale)
        out = torch.empty(shape, dtype=dtype, device=device)
        mats = iter(out.view(-1, *shape[-2:]))
        # every matrix of the whole tree is drawn, in order; of a routed
        # expert stack [L, n, ...] the rank keeps its own experts' draws
        n_exp = full[expert_cut(name)] if expert_cut(name) is not None else 0
        for j in range(math.prod(full[:-2])):
            x = torch.randn(full[-2:], generator=g, device=device,
                            dtype=torch.float32)
            if n_exp and (j % n_exp) * ep // n_exp != ep_rank:
                continue  # another expert rank's expert
            next(mats).copy_(cut(x, dim, rank, tp).mul_(scale))
        return out

    def quantized_leaf(name, shape, scale):
        # each matrix drawn in f32, rounded to `dtype` as the plain tree
        # holds it, quantized, and copied into the preallocated leaf
        embed = name == "embed"
        s_shape = (*shape[:-1], 1) if embed else (*shape[:-2], 1, shape[-1])
        out = {"q": torch.empty(shape, dtype=CODE_DTYPES[quantize], device=device),
               "s": torch.empty(s_shape, dtype=torch.float32, device=device)}
        one = quantize_embed if embed else quantize_weight
        for qm, sm in zip(out["q"].view(-1, *shape[-2:]),
                          out["s"].view(-1, *s_shape[-2:])):
            w = torch.randn(shape[-2:], generator=g, device=device,
                            dtype=torch.float32).mul_(scale).to(dtype)
            d = one(w, quantize)
            qm.copy_(d["q"])
            sm.copy_(d["s"])
        if embed:
            out["dt"] = torch.zeros((0,), dtype=dtype, device=device)
        return out

    params: Params = {}
    for name, v in param_shapes(c).items():
        params[name] = ({n: leaf(n, sh) for n, sh in v.items()
                         if n not in OPTIONAL_LEAVES}
                        if isinstance(v, dict) else leaf(name, v))
    if quantize:
        check_tree(params)
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
    lora: Optional[Params] = None,  # stacked multi-adapter tree (models/lora.py)
    adapter_idx: Optional[torch.Tensor] = None,  # [B] slot a row (0 = base),
    #   or [T] a token of the ragged row
    tp=None,  # parallel/group.py AxisGroup over `model`: this rank's slice
    ep=None,  # its AxisGroup over `expert`: the rank's routed experts
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
    bodies (the "ref" path dequantizes on its gather). On MoE layers
    `attn_impl` picks the routed experts' path as well (models/moe.py).

    `lora` (models/lora.py's stacked tree) with `adapter_idx` adds each
    token's adapter delta x @ A[a] @ B[a] to every target projection,
    after the base product (`mm`, so a quantized weight composes) and
    before Qwen2's biases, as the reference's `lproj`. `adapter_idx` is a
    slot a row ([B]), or a slot a token of the ragged row ([T]: its
    segments may carry different adapters); the delta is models/lora.py
    `delta`, two products over every slot masked to each token's slot (a
    base-slot token adds an exact zero). MLA configs and configs with
    n_dense_layers refuse it, as the reference does.

    `tp` (the rank's parallel/group.py AxisGroup over a `model` axis of
    N > 1 ranks) runs one rank's part of the pass, the reference's forward
    under `MeshConfig(model=N)`: the
    params are the rank's slices and the pools hold its Hk / N KV heads
    (parallel/mesh.py). The embedding's E columns are gathered after the
    lookup; q, k and v are the rank's heads (G query heads with their KV
    head), written to its pools and attended by the `*_sharded` kernels;
    an MLA layer computes the rank's H / N heads over the whole latent pool
    every rank holds (models/mla.py); one all-reduce follows `wo` and one
    the FFN a layer (`w_down`, or the MoE block: a rank's routed experts
    hold F / N columns each and its shared experts are a dense FFN's cut,
    so both sums are partial; the router is whole and every rank routes
    the same tokens alike), after the product and before any post norm
    and the residual add, where GSPMD places them; OLMo-2's full-width
    qk-norm sums its squares over the ranks; the V-cut logits are
    gathered, and a tied head all-reduces its partial product over the E
    cut. `ep` (its group over an `expert` axis) gives each MoE block the
    rank's n_experts / ep routed experts, and the block's token dispatch or
    dense fallback (models/moe.py) returns the whole output; attention and
    everything else is as under `tp` alone (whole on every rank without
    it). Every rank returns the same logits. It serves configs without
    LoRA or quantized weights: parallel/mesh.py check_tp refuses the rest
    when a parallel runner is built."""
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}")
    c = config
    lora_layers = (lora or {}).get("layers", {})
    if lora_layers and c.is_mla:
        # the MLA branch never consults the factors: an adapter that
        # seems to load but changes nothing is worse than a refusal
        raise NotImplementedError("LoRA is not supported for MLA models")
    if lora_layers and c.is_moe and c.n_dense_layers:
        raise NotImplementedError(
            "LoRA is not supported with n_dense_layers models")
    sharded = tp is not None and tp.size > 1
    n_tp = tp.size if sharded else 1
    B, S = tokens.shape
    hd = c.head_dim
    G = c.n_heads // c.n_kv_heads
    Hq, Hk = c.n_heads // n_tp, c.n_kv_heads // n_tp  # this rank's heads
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

    h = embed_lookup(params["embed"], tokens)  # [B, S, E] ([.., E / N] a rank)
    if sharded:
        h = tp.all_gather(h, -1)
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
                       else ragged_paged_attention_sharded if sharded
                       else ragged_paged_attention)
    else:
        rows = kv_rows(page_table, positions, NP, PS)
        # prefill-kernel metadata: valid tokens are a contiguous run from
        # s=0 (ModelRunner contract), so start/len fully describe them
        q_start = safe_pos[:, 0].to(torch.int32).contiguous()
        q_len = (positions >= 0).sum(1, dtype=torch.int32)

    if lora_layers:  # each token's slot one-hot: [B, S or 1, n, 1]
        slot_sel = lora_mod.slot_mask(
            adapter_idx.view(B, S) if ragged is not None else adapter_idx.view(B, 1),
            next(iter(lora_layers.values())).shape[1], h.dtype)

    def lproj(y: torch.Tensor, x: torch.Tensor, name: str, l: int) -> torch.Tensor:
        """y = x @ W, plus each token's delta x @ A[a] @ B[a]."""
        a = lora_layers.get(name + "_a")
        if a is None:
            return y
        return y + lora_mod.delta(x, a[l], lora_layers[name + "_b"][l], slot_sel)

    for l in range(c.n_layers):
        lp, use_moe = layer_params(c, params, l)
        if c.is_mla:
            attn = mla_attention(c, lp, h, k_pool, l, rows, page_table,
                                 ropes[0], safe_pos, kv_lens, q_start,
                                 q_len, attn_impl, n_tp)
        else:
            # OLMo-2 (pre_norms=False): the sublayer reads the raw residual
            x = (rms_norm(h, lp["attn_norm"], c.norm_eps, zero_centered=zc)
                 if c.pre_norms else h)
            q, k, v = (lproj(mm(x, lp[t], attn_impl), x, t, l)
                       for t in ("wq", "wk", "wv"))
            if c.attn_bias:  # Qwen2: after the product, in the params' dtype
                q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
            if c.qk_norm and c.qk_norm_wide:  # OLMo-2: over the full width
                q = wide_norm(q, lp["q_norm"], c.norm_eps, zc, tp if sharded else None)
                k = wide_norm(k, lp["k_norm"], c.norm_eps, zc, tp if sharded else None)
            q = q.view(B, S, Hq, hd)
            k = k.view(B, S, Hk, hd)
            v = v.view(B, S, Hk, hd)
            if c.qk_norm and not c.qk_norm_wide:  # Qwen3, Gemma-3: per head
                q = rms_norm(q, lp["q_norm"], c.norm_eps, zero_centered=zc)
                k = rms_norm(k, lp["k_norm"], c.norm_eps, zero_centered=zc)
            cos, sin = ropes[layer_rope(c, l)]
            q = apply_rope(q, cos, sin)
            k = apply_rope(k, cos, sin)
            write_kv(k_pool, l, k, rows)
            write_kv(v_pool, l, v, rows)
            qg = q.view(B, S, Hk, G, hd)
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
                attn = (decode_paged_attention_sharded if sharded
                        else decode_paged_attention)(
                    qg[:, 0], k_l, v_l, page_table, kv_lens, win,
                    **attn_kw)[:, None]
            else:
                attn = (prefill_paged_attention_sharded if sharded
                        else prefill_paged_attention)(
                    qg, k_l, v_l, page_table, q_start, q_len, kv_lens, win,
                    **attn_kw)
            attn = attn.reshape(B, S, Hq * hd)
        attn_out = lproj(mm(attn, lp["wo"], attn_impl), attn, "wo", l)
        if sharded:  # wo's rows are cut: sum the ranks' partial products
            tp.all_reduce(attn_out)
        if c.post_norms:  # Gemma-2, OLMo-2: norm the branch before the residual
            attn_out = rms_norm(attn_out, lp["post_attn_norm"], c.norm_eps,
                                zero_centered=zc)
        if rm != 1.0:  # Granite: scale the branch
            attn_out = attn_out * rm
        h = h + attn_out
        x = (rms_norm(h, lp["mlp_norm"], c.norm_eps, zero_centered=zc)
             if c.pre_norms or c.is_mla else h)
        if use_moe:  # no post-FFN norm on a MoE layer, as in the reference
            # (under tp or ep the block sums its partial outputs itself)
            ffw = moe_block(c, lp, x, attn_impl, tp if sharded else None, ep)
        else:
            gate = act(lproj(mm(x, lp["w_gate"], attn_impl), x, "w_gate", l))
            gu = gate * lproj(mm(x, lp["w_up"], attn_impl), x, "w_up", l)
            ffw = lproj(mm(gu, lp["w_down"], attn_impl), gu, "w_down", l)
            if sharded:
                tp.all_reduce(ffw)
            if c.post_norms:
                ffw = rms_norm(ffw, lp["post_mlp_norm"], c.norm_eps,
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
    if not sharded:
        logits = (tied_logits(h, params["embed"], attn_impl) if lm_head is None
                  else mm(h, lm_head, attn_impl))
    elif lm_head is None:  # the tied head over this rank's E columns
        logits = tp.all_reduce(tied_logits(
            cut(h, -1, tp.rank, n_tp), params["embed"], attn_impl))
    else:  # this rank's V columns
        logits = tp.all_gather(mm(h, lm_head, attn_impl), -1)
    logits = logits.float()
    if c.logits_divider != 1.0:  # Granite
        logits = logits / c.logits_divider
    if c.final_logit_softcap:
        cap = c.final_logit_softcap
        logits = cap * torch.tanh(logits / cap)
    return logits


def wide_norm(x: torch.Tensor, weight: torch.Tensor, eps: float, zc: bool,
              tp=None) -> torch.Tensor:
    """OLMo-2's qk-norm over the projection's full width. Under tensor
    parallelism x holds this rank's columns and `weight` is whole: the
    squares are summed over the ranks and the rank's part of the weight
    applied."""
    if tp is None:
        return rms_norm(x, weight, eps, zero_centered=zc)
    xf = x.float()
    ss = tp.all_reduce(xf.pow(2).sum(-1, keepdim=True))
    normed = xf * torch.rsqrt(ss / (x.shape[-1] * tp.size) + eps)
    w = cut(weight, -1, tp.rank, tp.size)
    return (normed * (w + 1.0 if zc else w)).to(x.dtype)


def encode(config: ModelConfig, params: Params, tokens: torch.Tensor,
           lengths: torch.Tensor) -> torch.Tensor:
    """The embedding forward (the reference's `encode`): tokens [B, S],
    real lengths [B] (the padding masked), dense causal self-attention
    with no KV pool, a masked mean pool of the final-norm hidden states,
    L2-normalized -> [B, E] f32. Plain PyTorch, as the reference's plain
    jnp; matrix products go through models/quant.py `mm`, as the
    forward's do. MLA, mixed dense/MoE and Gemma-family configs are
    refused, as there."""
    c = config
    if c.is_mla:
        raise ValueError("embedding forward is not supported for MLA models")
    if c.n_dense_layers:
        raise ValueError(
            "embedding forward is not supported for mixed dense/MoE models")
    if (c.post_norms or c.norm_zero_centered or c.embed_scale
            or c.attn_logit_softcap or c.sliding_window
            or c.query_pre_attn_scalar or c.act != "silu"):
        raise ValueError(
            "embedding forward is not supported for Gemma-family configs")
    B, S = tokens.shape
    hd = c.head_dim
    G = c.n_heads // c.n_kv_heads
    dev = tokens.device
    positions = torch.arange(S, device=dev)[None, :].expand(B, S)
    ti = torch.arange(S, device=dev)
    lengths = lengths.long()
    # [B, 1, 1, S, S]: causal and inside the row's length
    mask = ((ti[None, :] <= ti[:, None])[None, None, None]
            & (ti[None, :] < lengths[:, None])[:, None, None, None, :])
    h = embed_lookup(params["embed"], tokens)
    for l in range(c.n_layers):
        lp, use_moe = layer_params(c, params, l)
        x = rms_norm(h, lp["attn_norm"], c.norm_eps)
        q, k, v = mm(x, lp["wq"]), mm(x, lp["wk"]), mm(x, lp["wv"])
        if c.attn_bias:
            q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
        q = q.view(B, S, c.n_heads, hd)
        k = k.view(B, S, c.n_kv_heads, hd)
        v = v.view(B, S, c.n_kv_heads, hd)
        if c.qk_norm:
            q = rms_norm(q, lp["q_norm"], c.norm_eps)
            k = rms_norm(k, lp["k_norm"], c.norm_eps)
        q = rope(q, positions, c.rope_theta, config=c)
        k = rope(k, positions, c.rope_theta, config=c)
        qg = q.view(B, S, c.n_kv_heads, G, hd)
        scores = torch.einsum("bskgd,btkd->bkgst", qg, k).float() * hd ** -0.5
        probs = torch.softmax(torch.where(mask, scores, -1e30), dim=-1).to(h.dtype)
        attn = torch.einsum("bkgst,btkd->bskgd", probs, v).reshape(
            B, S, c.n_heads * hd)
        h = h + mm(attn, lp["wo"])
        x = rms_norm(h, lp["mlp_norm"], c.norm_eps)
        if use_moe:
            h = h + moe_block(c, lp, x)
        else:
            h = h + mm(F.silu(mm(x, lp["w_gate"])) * mm(x, lp["w_up"]), lp["w_down"])
    h = rms_norm(h, params["norm_f"], c.norm_eps).float()
    valid = (ti[None, :] < lengths[:, None]).float()
    pooled = (h * valid[..., None]).sum(1) / valid.sum(1).clamp(min=1)[:, None]
    return pooled / torch.linalg.norm(pooled, dim=-1, keepdim=True).clamp(min=1e-9)
