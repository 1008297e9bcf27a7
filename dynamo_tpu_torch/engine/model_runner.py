"""ModelRunner: the step functions behind the engine.

Port of dynamo_tpu/engine/model_runner.py's main-path methods: `prefill`,
`decode`, `decode_multi` (over `_decode_loop`), the fused mixed dispatch
(`decode_multi_with_prefill(s)`: the ragged flat-token step
`_ragged_step`, or the padded [N, S] fallback `_mixed_loop`), the
speculative `verify_spec` on the same ragged step, `sample_one`, and the
KV transfer methods (`export_pages(_device)`, `import_pages(_device)` with
the layer-streamed import; for the KV tiers `export_page_blocks`, which
can quantize on the device with the tier codec, `import_page_tensors`
and the codes-and-scales import, over a copy stream, the host tier's
blocks pinned up to a cap and pageable pages staged in pinned buffers,
`reserve_host_memory`) over the block-copy kernels, `copy_pages`
(the page pool's fork-on-branch copy hook), `embed` (the embedding
forward, models/llama.py `encode`), draft-model speculation
(`draft_config`: the draft's params and pools, `draft_prefill`,
`spec_decode_multi` over engine/spec_decode.py `spec_rounds`), the
device n-gram draft ring (`draft_ring_step`, `ensure_draft_ring`,
`draft_ring_reset`, `draft_step`), multi-LoRA (`lora_slots`: a stacked
adapter tree, models/lora.py, `register_adapter`, `adapter_slot`,
`adapter_names`; each dispatch takes per-row slot indices, uploaded with
its other int32 inputs, and the forward adds each row's adapter delta;
as in the reference a LoRA runner turns the ragged mixed step off, so its
mixed plans take the padded fallback, while its n-gram verify stays on
the ragged step with a slot a flat token), with the
reference's buckets, `_next_bucket`, `BucketOverflowError` and KV wire
format (`KV_WIRE_LAYOUT_VERSION` 2). Params
and the KV pools live on one device; under tensor parallelism (`tp`, a
parallel/group.py TPGroup; the runner built on every rank by
parallel/group.py MirroredRunner) they are this rank's slices and Hk / tp
heads, the forward's collectives keep the ranks in step, the copies go
through the sharded page-copy wrappers, the wire keeps whole-head pages
(exports all-gathered, imports cut) and `layout_table` names each
tensor's rank and cut; an MLA latent pool is whole on every rank, so its
pages are copied by the plain wrappers, exported as rank 0 holds them and
imported whole into every rank's pool. The pools are updated in place
(`kv_quantize="int8"`: the int8 dict pools of models/quant.py, whose pages
cross the transfer boundary dequantized, so the wire stays in the dense
dtype and bf16 and int8 workers interoperate; `quantize="int8"` or
`"fp8"`: weight-only quantized params, drawn quantized or, given a tree,
a quantized copy of it, as the reference's `quantize=`). Each
dispatch uploads its int32 inputs in one packed copy (`_upload`). The
fused decode loop (a lax.scan there) is a Python loop here that keeps the
sampled tokens on the device between its steps; the tokens reach the host
once per call. The loop carries the reference's sampling extras: the
penalty count tables (built on the device from the staged history,
updated after every step), the logprob report, the logit-bias rows, and
the guided masks: a static step-0 mask, the device DFA tables (state
advance and mask gather on the device), or the host fallback `mask_fn`
(the reference's ordered io_callback), called between the steps with the
step's tokens read back. The ragged step and the verify step take masks
and bias rows as well; the padded fallback takes neither and raises.
`reload_params` swaps the served weights for a params snapshot's in
place, leaf by leaf (requantized under `quantize`), and
`reset_kv_pools` zeroes the pools, the draft's too.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
import warnings
import weakref
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dynamo_tpu_torch import resolve_device
from dynamo_tpu_torch.engine.sampling import (
    SamplingParams,
    apply_penalties,
    sample,
    top_logprobs,
)
from dynamo_tpu_torch.guided.device_table import combine_tables
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.models import lora as lora_mod
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.quant import (
    QUANT_MODES,
    kv_pool_dequantize,
    kv_pool_quantize,
    check_tree,
    quantize_params,
)
from dynamo_tpu_torch.engine.spec_decode import spec_rounds
from dynamo_tpu_torch.engine.weights import check_fits, read_snapshot_into, serving_bytes
from dynamo_tpu_torch.models.toolkit import (
    is_quantized,
    kv_pool_shapes,
    make_kv_pool,
    pool_values,
)
from dynamo_tpu_torch.ops.block_copy import (
    gather_pages,
    gather_pages_sharded,
    scatter_pages,
    scatter_pages_layers,
    scatter_pages_sharded,
)
from dynamo_tpu_torch.parallel.mesh import (
    ITEM_TIERS,
    MeshConfig,
    cut,
    kv_cut,
    leaf_shape,
    param_cut,
    refuse_tp,
    shard_tree,
)
from dynamo_tpu_torch.ops.tier_codec import tier_dequantize, tier_quantize
from dynamo_tpu_torch.runtime.sanitizer import tensor_rows
from dynamo_tpu_torch.ops.ragged_paged_attention import (
    DEFAULT_Q_BLOCK,
    RAGGED_MAX_SEGS,
    build_ragged_metadata,
    ragged_seg_cap,
)

log = logging.getLogger("dynamo_tpu_torch.engine.runner")

# forward passes by kind, counted in ModelRunner.stats (plain ints): each
# kind launches one attention kernel per layer
STAT_KEYS = (
    "prefill_chunks",  # standalone prefill chunks (prefill kernel)
    "padded_prefill_dispatches",  # [N, S] fallback chunk sets (prefill kernel)
    "decode_steps",  # decode steps, fused tails included (decode kernel)
    "ragged_mixed_dispatches",  # fused mixed steps (ragged kernel)
    "ragged_verify_dispatches",  # speculative verify steps (ragged kernel)
    "mixed_chunks",  # prefill chunks served by fused mixed dispatches
    # KV transfer (pages, not pool x pages): every export gathers and every
    # import scatters once per pool (block-copy kernels)
    "kv_pages_exported",
    "kv_pages_imported",
    "kv_layer_group_scatters",  # layer groups of streamed imports
    # guided decode loops by mask source: the device DFA tables, or the
    # host fallback, whose mask builds (mask_fn calls) are counted too
    "guided_device_dispatches",
    "guided_host_dispatches",
    "guided_host_masks",
    "page_copies",  # copy_pages calls (fork-on-branch tail pages)
    # draft-model speculation: target verify passes (S = gamma + 1, the
    # prefill kernel), draft S = 1 steps (the decode kernel) and draft
    # prefill chunks (the prefill kernel)
    "spec_verify_passes",
    "draft_steps",
    "draft_prefill_chunks",
    "draft_ring_steps",  # device n-gram ring proposals (draft_step calls)
)


_NULL = contextlib.nullcontext()


class DispatchFamily:
    """One dispatch kind's distinct bucket shapes and its dispatch count
    (`variants` / `calls`: the names the reference's compile families
    and the sanitizer's tripwire read)."""

    __slots__ = ("shapes", "calls")

    def __init__(self):
        self.shapes: set = set()
        self.calls = 0

    @property
    def variants(self) -> int:
        return len(self.shapes)


class BucketOverflowError(ValueError):
    """A dispatch needs a shape past the largest configured bucket."""

    def __init__(self, n: int, buckets: Sequence[int]):
        super().__init__(f"{n} exceeds largest bucket {buckets[-1]}")
        self.n = n
        self.largest = buckets[-1]


def _unpin_one(live: List[int]) -> None:
    """A pinned host block was freed (ModelRunner._host_block)."""
    live[0] -= 1


def _next_bucket(buckets: Sequence[int], n: int) -> int:
    for b in buckets:
        if b >= n:
            return b
    raise BucketOverflowError(n, buckets)


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def _padded(values: Sequence[int], n: int, fill: int) -> np.ndarray:
    out = np.full(n, fill, np.int32)
    out[:len(values)] = values
    return out


def _first_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """The first n rows of x, zero rows appended where x has fewer."""
    if x.shape[0] >= n:
        return x[:n]
    return torch.cat([x, x.new_zeros((n - x.shape[0],) + x.shape[1:])])


def _row(x: Optional[np.ndarray]) -> Optional[np.ndarray]:
    """A [V] row as a one-row [1, V] plane (None stays None)."""
    return None if x is None else x[None]


def _fold_seed(seed: int, j: int) -> int:
    """Verify position j > 0 draws with its own seed (the reference's
    `(seed * 1000003 + j) & 0x7FFFFFFF`); position 0 keeps the row's."""
    return int(seed) if j == 0 else (int(seed) * 1000003 + int(j)) & 0x7FFFFFFF


# device n-gram draft ring width: history tokens kept a slot. Below the
# host scan's NGRAM_SCAN_WINDOW (4096): the match is the host scan's for
# histories shorter than the window
DRAFT_RING_WINDOW = 512


def draft_ring_step(hist: torch.Tensor, lens: torch.Tensor,
                    upd_tok: torch.Tensor, upd_n: torch.Tensor, k: int,
                    max_match: int = 4):
    """The reference's `_draft_ring_step`: one device draft step over all
    slots. Append each slot's newly committed tokens to its history
    (shifting left on overflow), then run the prompt-lookup suffix match
    (`ngram_draft.propose` as dense [SLOTS, W] ops: the longest suffix m in
    [1, max_match] wins, its most recent earlier occurrence wins, the
    continuation is clipped at the history's end) and gather k tokens a
    slot. hist [SLOTS, W] int32 (-1 padded), lens [SLOTS], upd_tok
    [SLOTS, D] (-1 padded), upd_n [SLOTS]. Returns (hist, lens, drafts
    [SLOTS, k], n_prop [SLOTS]). The reference's dropped out-of-range
    writes are a scatter into a padding column W that is cut off; its
    match, a loop over m of m gathers each, is one [SLOTS, max_match, W]
    comparison (65 operations dispatched a step at 8 slots, views aside,
    in place of 173)."""
    SLOTS, W = hist.shape
    D = upd_tok.shape[1]
    dev = hist.device
    cols_d = torch.arange(D, dtype=torch.int32, device=dev)[None, :]
    # -- append, shifting left on overflow --------------------------------
    over = (lens + upd_n - W).clamp(min=0)
    gidx = torch.arange(W, dtype=torch.int32, device=dev)[None, :] + over[:, None]
    hp = torch.cat([hist, hist.new_full((SLOTS, D), -1)], 1)
    hist = torch.gather(hp, 1, gidx.long())
    lens = lens - over
    pos = lens[:, None] + cols_d
    valid = cols_d < upd_n[:, None]
    hw = torch.cat([hist, hist.new_full((SLOTS, 1), -1)], 1)
    hw.scatter_(1, torch.where(valid, pos, W).long(),
                torch.where(valid, upd_tok, -1))
    hist = hw[:, :W].contiguous()
    lens = lens + upd_n
    # -- suffix match -------------------------------------------------------
    # a continuation position t (the draft starts at hist[t]) follows an
    # m-token match of the suffix iff hist[t-1-j] == hist[len-1-j] for
    # every j < m: run[t] counts the leading equal j (the left padding
    # -2 never equals a token, so s = t - m >= 0). The reference's loop
    # over m becomes one score: the longest suffix (capped at len - 1)
    # wins, then the most recent t <= len - 1 (at least one token after
    # the occurrence, before the suffix itself)
    j = torch.arange(max_match, dtype=torch.int32, device=dev)
    sfx = torch.gather(hist, 1, (lens[:, None] - 1 - j).clamp(0, W - 1).long())
    left = torch.cat([hist.new_full((SLOTS, max_match), -2), hist], 1)
    back = torch.stack([left[:, max_match - 1 - i:max_match - 1 - i + W]
                        for i in range(max_match)], 1)
    run = (back == sfx[:, :, None]).int().cumprod(1).sum(1, dtype=torch.int32)
    t = torch.arange(W, dtype=torch.int32, device=dev)[None, :]
    m_t = torch.minimum(run, (lens[:, None] - 1).clamp(max=max_match))
    score = torch.where(t <= lens[:, None] - 1, m_t * (W + 1) + t, -1).amax(1)
    best_m = score.div(W + 1, rounding_mode="floor")
    start = torch.where(best_m > 0, score - best_m * (W + 1), -1)
    hpad = torch.cat([hist, hist.new_full((SLOTS, k), -1)], 1)
    idx = start[:, None] + torch.arange(k, dtype=torch.int32, device=dev)[None, :]
    drafts = torch.gather(hpad, 1, idx.clamp(min=0).long())
    n_prop = torch.where(best_m > 0, (lens - start).clamp(0, k), 0)
    return hist, lens, drafts, n_prop.to(torch.int32)


# Wire layout version for P→D / cross-worker KV payloads. v2 = token-major
# [L, n, PS, Hk, D]; v1 (implicit, no field) was head-major. An old-layout
# peer's bytes sliced under the new axis order would import transposed KV
# silently — reject and force recompute instead.
KV_WIRE_LAYOUT_VERSION = 2


class KvWireLayoutMismatch(ValueError):
    pass


# element types by their wire names: the reference's numpy names, so a
# payload crosses between the two packages (not str(torch.bfloat16))
_WIRE_DTYPES = {torch.bfloat16: "bfloat16", torch.float16: "float16",
                torch.float32: "float32"}
_FROM_WIRE = {name: dt for dt, name in _WIRE_DTYPES.items()}


def _raw_bytes(x: torch.Tensor) -> bytes:
    """A CPU tensor's elements as bytes (bf16 has no numpy type)."""
    return x.contiguous().view(torch.uint8).numpy().tobytes()


def kv_arrays_to_payload(k: torch.Tensor, v: torch.Tensor,
                         tp: int = 1) -> Dict[str, Any]:
    """KV wire format for P→D transfer and G2 offload: [L, n, PS, Hk, D]
    (token-major, page axis 1 — the pool layout) CPU tensors as raw bytes
    + shape/dtype metadata. The page geometry and the exporter's tp degree
    let an importer validate compatibility and recompute instead of
    adopting mis-shaped bytes."""
    out_extra = {}
    if v.shape != k.shape:
        # MLA pools are asymmetric: k = latent pages, v = 1-wide stub
        out_extra["v_shape"] = list(v.shape)
    return {
        "data": True,
        "k": _raw_bytes(k),
        "v": _raw_bytes(v),
        "shape": list(k.shape),
        "dtype": _WIRE_DTYPES[k.dtype],
        **out_extra,
        "n_pages": int(k.shape[1]),
        "layout": KV_WIRE_LAYOUT_VERSION,
        "page_size": int(k.shape[2]),
        "kv_heads": int(k.shape[3]),
        "head_dim": int(k.shape[4]),
        "layers": int(k.shape[0]),
        "tp": int(tp),
    }


def kv_quant_arrays_to_payload(kq, ks, vq, vs) -> Dict[str, Any]:
    """The int8 + scales payload of a LOCAL tier promotion (engine to
    runner in one process; tensors stay tensors, no bytes): the tier
    codec's per-(token, head) codes and scales as lists of n per-block
    tensors, q [L, PS, Hk, D] and s [L, PS, Hk] (the reference stacks
    them; here each block goes to the card as it is), so an int8 pool
    adopts them without a dequantize / requantize round trip. The
    cross-worker wire stays dense (kv_arrays_to_payload)."""
    shape = [int(kq[0].shape[0]), len(kq)] + [int(d) for d in kq[0].shape[1:]]
    return {
        "data": True,
        "quant": "int8_ts",
        "kq": kq, "ks": ks, "vq": vq, "vs": vs,
        "shape": shape,
        "n_pages": shape[1],
        "layout": KV_WIRE_LAYOUT_VERSION,
        "page_size": shape[2],
        "kv_heads": shape[3],
        "head_dim": shape[4],
        "layers": shape[0],
    }


def layer_group_bounds(num_layers: int, groups: int) -> List[Tuple[int, int]]:
    """Contiguous [lo, hi) layer slabs for the streamed onboard: `groups`
    near-equal groups, the earlier ones taking the remainder so the first
    (blocking) transfer is never the runt."""
    g = max(1, min(int(groups), int(num_layers)))
    base, rem = divmod(int(num_layers), g)
    bounds: List[Tuple[int, int]] = []
    lo = 0
    for i in range(g):
        hi = lo + base + (1 if i < rem else 0)
        bounds.append((lo, hi))
        lo = hi
    return bounds


def kv_payload_incompatible(
    payload: Dict[str, Any],
    page_shape: Tuple[int, int, int, int],
    dtype: Optional[str] = None,
) -> Optional[str]:
    """Reason string when `payload` cannot be imported into a pool whose
    per-page geometry is `page_shape` = (L, PS, Hk, D) and (optionally)
    whose wire dtype name is `dtype`; None when compatible. The exporter's
    TP degree is deliberately not checked (the wire holds full-head
    pages)."""
    if payload.get("layout") != KV_WIRE_LAYOUT_VERSION:
        return f"layout {payload.get('layout')} != {KV_WIRE_LAYOUT_VERSION}"
    L, PS, Hk, D = page_shape
    shape = payload.get("shape") or []
    if len(shape) != 5:
        return f"malformed shape {shape}"
    got = (shape[0], shape[2], shape[3], shape[4])
    if got != (L, PS, Hk, D):
        return f"page geometry {got} != local (L={L}, PS={PS}, Hk={Hk}, D={D})"
    if dtype is not None and payload.get("dtype") != dtype:
        return f"dtype {payload.get('dtype')} != local {dtype}"
    return None


def kv_payload_to_arrays(payload: Dict[str, Any], page_shape=None, dtype=None):
    """Inverse of kv_arrays_to_payload: (k, v) CPU tensors over the
    payload's bytes (read-only; never written), or None if the payload
    carries no data. Raises KvWireLayoutMismatch when the sender used a
    different layout version or (when `page_shape`/`dtype` is given) a
    different page geometry or element type."""
    if not payload or not payload.get("k"):
        return None
    if payload.get("layout") != KV_WIRE_LAYOUT_VERSION:
        raise KvWireLayoutMismatch(
            f"kv wire layout {payload.get('layout')} != {KV_WIRE_LAYOUT_VERSION}"
        )
    if page_shape is not None:
        bad = kv_payload_incompatible(payload, page_shape, dtype)
        if bad:
            raise KvWireLayoutMismatch(bad)
    elem = _FROM_WIRE.get(payload["dtype"])
    if elem is None:
        raise KvWireLayoutMismatch(f"dtype {payload['dtype']} has no torch type")
    shape = tuple(payload["shape"])
    v_shape = tuple(payload.get("v_shape") or shape)
    with warnings.catch_warnings():
        # bytes are immutable; the tensors are only read
        warnings.simplefilter("ignore", UserWarning)
        k = torch.frombuffer(payload["k"], dtype=elem).reshape(shape)
        v = torch.frombuffer(payload["v"], dtype=elem).reshape(v_shape)
    return k, v


class ModelRunner:
    supports_logit_bias = True  # the engine admits biased requests on this
    guided_fused = True  # guided rows ride the fused decode loop

    def __init__(
        self,
        config: ModelConfig,
        *,
        num_pages: int = 512,
        page_size: int = 16,
        max_pages_per_seq: int = 128,
        decode_buckets: Sequence[int] = (1, 2, 4, 8, 16, 32, 64),
        prefill_buckets: Sequence[int] = (16, 32, 64, 128, 256, 512, 1024),
        ragged_buckets: Sequence[int] = (32, 64, 128, 256, 512, 1024, 2048),
        dtype=torch.bfloat16,
        params: Optional[Dict[str, Any]] = None,  # None: random, seed 0
        device=None,  # None -> cuda (raises without a card); "cpu" for tests
        kv_quantize: Optional[str] = None,  # "int8": int8 KV pools
        quantize: Optional[str] = None,  # "int8" / "fp8": weight-only
        draft_config: Optional[ModelConfig] = None,  # speculative decoding
        #   with a draft model
        draft_params: Optional[Dict[str, Any]] = None,  # None: random, seed 1
        spec_gamma: int = 4,  # draft tokens proposed per verify pass
        lora_slots: int = 0,  # > 0: multi-LoRA with this many adapter slots
        #   beside the base slot 0
        lora_rank: int = 8,  # the stacked tree's rank (adapters zero-padded)
        lora_targets: Optional[Sequence[str]] = None,  # None: DEFAULT_TARGETS
        attn_impl: str = "kernel",  # forward's path: the kernels, or "ref"
        #   (the plain PyTorch versions; the hardware sweep's A/B)
        tp=None,  # parallel/group.py TPGroup: this rank's slice of a
        #   model on its mesh (built by parallel/group.py MirroredRunner)
    ):
        self.config = config
        self.attn_impl = attn_impl
        self.device = resolve_device(device)
        # the rank's place on its mesh (parallel/mesh.py): `group` the
        # world (None on one rank), `tp` its group over `model` (its params
        # slices and its pools' Hk / tp_size heads), `ep` over `expert` (its
        # n_experts / ep_size routed experts); a data index replicates
        group = tp if tp is not None and tp.size > 1 else None
        self.group = group
        self.mesh_config = group.mesh if group is not None else MeshConfig()
        coords = group.coords if group is not None else {"model": 0, "expert": 0}
        self.tp = group.model if group is not None else None
        self.ep = group.expert if group is not None else None
        self.tp_rank, self.tp_size = coords["model"], self.mesh_config.model
        self.ep_rank, self.ep_size = coords["expert"], self.mesh_config.expert
        # the dim a rank's pools cut (None: whole on every rank, as an MLA
        # latent pool is), and whether its page copies are the sharded ones
        self.kv_cut = kv_cut(config)
        self._kv_sharded = self.tp is not None and self.kv_cut is not None
        self.num_pages = num_pages
        self.page_size = page_size
        self.max_pages_per_seq = max_pages_per_seq
        self.decode_buckets = tuple(decode_buckets)
        self.prefill_buckets = tuple(prefill_buckets)
        # chunk-count buckets of the padded mixed fallback's [N, S] batch
        self.pack_buckets = (1, 2, 4, 8, 16, 32)
        # flat-token buckets of the ragged step; the engine adds its mixed
        # token budget + max batch (ensure_ragged_bucket)
        self.ragged_buckets = tuple(sorted(ragged_buckets))
        self.ragged_q_block = DEFAULT_Q_BLOCK
        # fused mixed plans ride the ragged step unless DYN_RAGGED_MIXED=0
        # forces the padded fallback (the reference's A/B switch); MLA has
        # no ragged attention, and a LoRA batch carries per-row adapters
        # the one flat row cannot, so their plans take the padded fallback
        flag = os.environ.get("DYN_RAGGED_MIXED", "").lower()
        self.ragged_mixed = (flag not in ("0", "false", "off", "no")
                             and not config.is_mla and lora_slots <= 0)
        self.dtype = dtype
        self.moe_layers = llama.moe_layer_count(config)
        if quantize is not None and quantize not in QUANT_MODES:
            raise ValueError(f"unknown quantize mode {quantize!r}")
        self.quantize = quantize
        if draft_config is not None and draft_config.vocab_size != config.vocab_size:
            # acceptance compares the two models' token ids
            raise ValueError(f"draft {draft_config.name} has vocabulary "
                             f"{draft_config.vocab_size}, {config.name} "
                             f"{config.vocab_size}")
        self.lora_rank = int(lora_rank)
        self.lora_targets = (tuple(lora_targets or lora_mod.DEFAULT_TARGETS)
                             if lora_slots > 0 else None)
        if lora_slots > 0 and (config.is_mla or (config.is_moe and config.n_dense_layers)):
            raise NotImplementedError(
                "LoRA is not supported for MLA models" if config.is_mla
                else "LoRA is not supported with n_dense_layers models")
        if self.device.type == "cuda" and self.group is None:
            # (a tensor-parallel build is checked for every rank on the
            # card before any rank draws: MirroredRunner)
            need = serving_bytes(config, num_pages, page_size, dtype, kv_quantize,
                                 quantize, params, draft_config, draft_params)
            if lora_slots > 0:
                need += lora_mod.lora_bytes(config, lora_slots + 1, self.lora_rank,
                                            self.lora_targets, dtype)
            check_fits(config.name, need, torch.cuda.mem_get_info(self.device)[0])
        t0 = time.monotonic()
        if params is None:
            # drawn quantized, one matrix at a time (or this rank's slices)
            params = llama.init_params(config, 0, dtype, self.device, quantize,
                                       rank=self.tp_rank, tp=self.tp_size,
                                       ep_rank=self.ep_rank, ep=self.ep_size)
        elif self.group is not None:
            # a whole tree (or this rank's) -> this rank's slices, here
            params = shard_tree(params, llama.param_shapes(config), self.tp_rank,
                                self.tp_size, self.ep_rank, self.ep_size)
            params = _to_device(params, self.device)
            check_tree(params)
        elif quantize:
            # a new tree: the caller's stays as it is (another runner may
            # serve it)
            params = quantize_params(params, mode=quantize)
        else:
            check_tree(params)
        self.params = params
        # multi-LoRA: the stacked factors, slot 0 the base (all zero), and
        # the registered adapters' slots by name
        self.lora = None
        self._adapter_slots: Dict[str, int] = {}
        if lora_slots > 0:
            self.lora = lora_mod.init_lora_params(
                config, lora_slots + 1, self.lora_rank, self.lora_targets, dtype,
                self.device)
        # one page more than the PagePool hands out: page `num_pages`
        # takes the padding rows' KV writes (models/toolkit.py kv_rows)
        self.kv_quantize = kv_quantize
        self.k_pool, self.v_pool = make_kv_pool(
            config, num_pages + 1, page_size, dtype, self.device,
            kv_quantize=kv_quantize, tp=self.tp_size)
        # draft-model speculation: the draft owns pools of its own (bf16 or
        # int8 as the target's, the same spare page) addressed by the same
        # page tables, so paging, prefix sharing and preemption need no
        # bookkeeping of their own; its params are never quantized
        self.draft_config = draft_config
        self.spec_gamma = int(spec_gamma)
        self.draft_params = None
        self.draft_k_pool = self.draft_v_pool = None
        if draft_config is not None:
            if draft_params is None:
                draft_params = llama.init_params(draft_config, 1, dtype, self.device)
            else:
                check_tree(draft_params)
            self.draft_params = draft_params
            self.draft_k_pool, self.draft_v_pool = make_kv_pool(
                draft_config, num_pages + 1, page_size, dtype, self.device,
                kv_quantize=kv_quantize)
        # the device n-gram draft ring (ensure_draft_ring)
        self._draft_ring = None  # (hist [SLOTS, W], lens [SLOTS]) device
        self._draft_ring_host = None  # its host mirror
        self._draft_ring_dirty = False  # mirror edited: restage
        self._draft_ring_shape = None  # (slots, window, delta capacity)
        self.stats: Dict[str, int] = {}
        self.reset_stats()
        # the sanitizer (attach_sanitizer), the dispatch families (kind ->
        # shapes seen, dispatches) and where each tensor was placed
        self._sanitizer = None
        self._families: Dict[str, DispatchFamily] = {}
        self._placed = {name: (t.device, t.dtype) + self._declared(name)
                        for name, t in self._layout_rows()}
        # the host tier's blocks (export_page_blocks): at most
        # `pinned_block_cap` of the host tensors handed out are pinned (set
        # by reserve_host_memory), the rest pageable; `_pinned_live` counts
        # the pinned ones alive. The imports' pinned staging of pageable
        # pages (_host_stage) and their copy stream.
        self.pinned_block_cap = 0
        self._pinned_live = [0]
        self._stage_bufs: Dict[str, torch.Tensor] = {}
        self._stage_event = None
        self._copy_stream = None
        self._sampling_cache: Dict[Any, SamplingParams] = {}
        # staged guided tables by the uids of their schemas
        self._guided_dev_cache: "OrderedDict[Tuple[int, ...], Any]" = OrderedDict()
        log.info("runner ready: %s params+pool placed in %.1fs on %s "
                 "(%d pages x %d tokens)", config.name, time.monotonic() - t0,
                 self.device, num_pages, page_size)

    def reset_stats(self) -> None:
        self.stats = {k: 0 for k in STAT_KEYS}

    # -- observability -------------------------------------------------------
    def attach_sanitizer(self, san) -> None:
        """The engine's sanitizer: every sanctioned sync of a dispatch runs
        inside its named allow scope."""
        self._sanitizer = san

    def _allow(self, label: str):
        san = self._sanitizer
        return _NULL if san is None else san.allow_transfer(label)

    def _note_shape(self, kind: str, shape) -> None:
        """Count a dispatch of family `kind` at `shape` (its buckets)."""
        fam = self._families.get(kind)
        if fam is None:
            fam = self._families[kind] = DispatchFamily()
        fam.shapes.add(shape)
        fam.calls += 1

    def compile_stats(self) -> Dict[str, Dict[str, int]]:
        """{family: {"variants", "calls"}}: the distinct (kind, bucket)
        shapes dispatched and the dispatches made, the counterpart of the
        reference's compile-cache counters (the fleet digest's compile
        block)."""
        return {k: {"variants": f.variants, "calls": f.calls}
                for k, f in self._families.items()}

    def layout_table(self):
        """(name, live tensor, (device, dtype) placed) for every param,
        KV pool and adapter tensor: the sanitizer's layout check. Under
        tensor parallelism `placed` is (device, dtype, the rank's declared
        shape, rank, the dim cut over the ranks or None)."""
        placed = self._placed
        for name, t in self._layout_rows():
            yield name, t, placed.get(name, (t.device, t.dtype))

    def _declared(self, name: str) -> tuple:
        """A parallel rank's row's (shape, rank, cut dim over `model`):
        what the split rule (parallel/mesh.py) gives this rank; () on one
        rank."""
        if self.group is None:
            return ()
        parts = name.split("/")
        if parts[0] == "params":
            node = llama.param_shapes(self.config)
            for p in parts[1:]:
                node = node[p]
            return (leaf_shape(parts[-1], node, self.tp_size, self.ep_size),
                    self.group.rank, param_cut(parts[-1]))
        shape = kv_pool_shapes(self.config, self.num_pages + 1, self.page_size,
                               self.tp_size)[0]
        return (shape[:-1] if parts[-1] == "s" else shape), self.group.rank, self.kv_cut

    def _layout_rows(self):
        yield from tensor_rows("params/", self.params)
        yield from tensor_rows("k_pool/", self.k_pool)
        yield from tensor_rows("v_pool/", self.v_pool)
        if self.lora is not None:
            yield from tensor_rows("lora/", self.lora)

    def _upload(self, *arrays, label: str = "decode_staging") -> List[torch.Tensor]:
        """One host-to-device copy for a dispatch's int32 arrays; returns
        device views with the arrays' shapes. The copy waits for the host
        memory to be read, a sync the sanitizer allows under `label`."""
        arrays = [np.asarray(a, np.int32) for a in arrays]
        flat = np.concatenate([a.ravel() for a in arrays])
        with self._allow(label):
            dev = torch.from_numpy(flat).to(self.device)
        out, off = [], 0
        for a in arrays:
            out.append(dev[off:off + a.size].view(a.shape))
            off += a.size
        return out

    def _adapter_ints(self, adapters: Optional[Sequence[int]], B: int) -> List[np.ndarray]:
        """The [B] slot indices of a dispatch (pad rows on the base slot)
        as one more array of its upload; none without LoRA."""
        if self.lora is None:
            return []
        return [_padded(list(adapters or []), B, 0)]

    def _lora_kw(self, idx: Sequence[torch.Tensor]) -> Dict[str, Any]:
        """forward's LoRA arguments for the uploaded slot indices (an empty
        list without LoRA)."""
        if not idx:
            return {}
        return {"lora": self.lora, "adapter_idx": idx[0]}

    # -- steps -------------------------------------------------------------
    def prefill(
        self,
        tokens: List[int],
        start_pos: int,
        page_table_row: List[int],
        prior_len: int,
        adapter: int = 0,
    ) -> torch.Tensor:
        """Run one prefill chunk for a single sequence. `tokens` are the
        uncomputed prompt tokens starting at absolute position `start_pos`;
        `prior_len` is the context length already in the pool; `adapter`
        its LoRA slot. Returns last-token logits [V] (f32, on the
        device)."""
        n = len(tokens)
        S = _next_bucket(self.prefill_buckets, n)
        pos = _padded(range(start_pos, start_pos + n), S, -1)
        tok, pos, pt, kvl, *ad = self._upload(
            _padded(tokens, S, 0)[None], pos[None],
            self._pad_page_table([page_table_row]), [prior_len + n],
            *self._adapter_ints([adapter], 1))
        logits = llama.forward(
            self.config, self.params, tok, pos, self.k_pool, self.v_pool,
            pt, kvl, n - 1, attn_impl=self.attn_impl, tp=self.tp, ep=self.ep, **self._lora_kw(ad))
        self.stats["prefill_chunks"] += 1
        self._note_shape("prefill", (S,))
        return logits[0, 0]

    def decode(self, tokens: List[int], positions: List[int],
               page_tables: List[List[int]], sampling, step: int,
               adapters: Optional[List[int]] = None) -> np.ndarray:
        """One decode step. Returns sampled token ids [B_bucket] (host)."""
        return self.decode_multi(1, tokens, positions, page_tables, sampling,
                                 step, adapters=adapters)[:, 0]

    def decode_multi(
        self,
        n_steps: int,
        tokens: List[int],
        positions: List[int],
        page_tables: List[List[int]],
        sampling,  # dict of host lists (engine._sampling_params)
        step: int,
        masks: Optional[np.ndarray] = None,  # [n, V] bool guided masks
        biases: Optional[np.ndarray] = None,  # [n, V] f32 logit-bias rows
        mask_fn=None,  # GuidedMaskContext: host-advanced per-step masks
        guided_dev=None,  # (tables, row_entries, pending): device DFA plan
        adapters: Optional[List[int]] = None,  # LoRA slot a row
    ) -> np.ndarray:
        """n_steps decode iterations with one host sync at the end. Page
        tables must already cover positions[i] + n_steps slots. Returns
        sampled tokens [B_bucket, n_steps]."""
        toks, _ = self._decode_dispatch(
            n_steps, tokens, positions, page_tables, sampling, step,
            masks=masks, biases=biases, mask_fn=mask_fn, guided_dev=guided_dev,
            adapters=adapters)
        with self._allow("token_readback"):
            return toks.cpu().numpy()

    def decode_multi_ex(
        self,
        n_steps: int,
        tokens: List[int],
        positions: List[int],
        page_tables: List[List[int]],
        sampling,
        step: int,
        n_logprobs: int = -1,
        histories: Optional[List[List[int]]] = None,
        prompt_lens: Optional[List[int]] = None,
        masks: Optional[np.ndarray] = None,
        biases: Optional[np.ndarray] = None,
        mask_fn=None,
        guided_dev=None,
        adapters: Optional[List[int]] = None,
    ):
        """decode_multi with the sampling extras: `histories` (each row's
        prompt + generated ids; `prompt_lens[i]` marks where its generated
        output starts) switches on the penalties; `n_logprobs` >= 0 adds
        the report (tok_lp [B, T], top_ids [B, T, K], top_lps [B, T, K])
        as host arrays. Returns (sampled [B, T], lp or None)."""
        toks, lp = self._decode_dispatch(
            n_steps, tokens, positions, page_tables, sampling, step,
            n_logprobs=n_logprobs, histories=histories, prompt_lens=prompt_lens,
            masks=masks, biases=biases, mask_fn=mask_fn, guided_dev=guided_dev,
            adapters=adapters)
        with self._allow("token_readback"):
            toks_h = toks.cpu().numpy()
            if lp is None:
                return toks_h, None
            return toks_h, tuple(a.cpu().numpy() for a in lp)

    def _decode_dispatch(self, n_steps, tokens, positions, page_tables, sampling,
                         step, n_logprobs=-1, histories=None, prompt_lens=None,
                         masks=None, biases=None, mask_fn=None, guided_dev=None,
                         adapters=None):
        """Stage one decode dispatch (the ints, the LoRA slots and the
        history in one upload, the mask and bias planes padded to the
        bucket: pad rows all-allowed and unbiased) and run the loop.
        Returns device (tokens [B, n_steps], lp or None)."""
        B = _next_bucket(self.decode_buckets, len(positions))
        ad_ints = self._adapter_ints(adapters, B)
        ints = [_padded(tokens, B, 0), _padded(positions, B, -1),
                self._pad_page_table(page_tables, B), *ad_ints]
        if histories is not None:
            # bucketed to 128, padded with V: the pad's counts drop
            V = self.config.vocab_size
            H = -(-max(8, max((len(h) for h in histories), default=1)) // 128) * 128
            hist = np.full((B, H), V, np.int32)
            plen = np.zeros(B, np.int32)
            for i, h in enumerate(histories):
                hist[i, :len(h)] = h
                plen[i] = prompt_lens[i] if prompt_lens is not None else len(h)
            ints += [hist, plen]
        up = self._upload(*ints)
        tok, pos0, pt = up[:3]
        ad = up[3:3 + len(ad_ints)]
        counts = (self._count_tables(*up[3 + len(ad_ints):])
                  if histories is not None else None)
        if mask_fn is not None:
            mask_fn.B = B  # the callback's mask rows match the padded bucket
        self._note_shape("decode", (B,))
        return self._decode_loop(
            n_steps, tok, pos0, pt, self._device_sampling(sampling, B), step,
            mask=self._plane(masks, B, True), bias=self._plane(biases, B, 0.0),
            counts=counts, mask_fn=mask_fn,
            guided=self._guided_op(guided_dev, B) if guided_dev else None,
            n_logprobs=n_logprobs, adapter_idx=ad)

    def _plane(self, rows: Optional[np.ndarray], n: int, fill) -> Optional[torch.Tensor]:
        """Row-aligned [r, V] mask (bool) or bias (f32) rows padded to n
        rows with `fill`, on the device; None stays None."""
        if rows is None:
            return None
        out = np.full((n, self.config.vocab_size), fill, rows.dtype)
        out[:rows.shape[0]] = rows
        with self._allow("decode_staging"):
            return torch.from_numpy(out).to(self.device)

    def _count_tables(self, hist: torch.Tensor, plen: torch.Tensor):
        """The penalties' count tables [B, V] f32 from a history [B, H]
        padded with V: every token, and the generated ones only (positions
        >= plen). Built one column wider so the pad lands in a column
        that is cut off; the counts are small integers, so the order of
        the accumulating adds does not matter."""
        B, H = hist.shape
        V = self.config.vocab_size
        h = hist.long()
        rows = torch.arange(B, device=h.device)[:, None].expand(B, H)
        ones = torch.ones((B, H), dtype=torch.float32, device=h.device)
        cols = torch.arange(H, device=h.device)[None, :]
        out_tok = torch.where(cols >= plen[:, None].long(), h, V)
        tables = []
        for idx in (h, out_tok):
            t = torch.zeros((B, V + 1), dtype=torch.float32, device=h.device)
            t.index_put_((rows, idx), ones, accumulate=True)
            tables.append(t[:, :V])
        return tuple(tables)

    def _decode_loop(self, n_steps: int, tok: torch.Tensor,
                     pos0: torch.Tensor, pt: torch.Tensor,
                     samp: SamplingParams, step: int, mask=None, bias=None,
                     counts=None, mask_fn=None, guided=None,
                     n_logprobs: int = -1, adapter_idx=()):
        """The reference's `_decode_loop`: forward, sample, feed the
        sampled token back, all on the device, from device tokens `tok`
        [B] (host-packed, or chained from an earlier dispatch's samples)
        at positions `pos0` [B] (-1 = padding row) over tables `pt`
        [B, MP]. Extras: `mask` [B, V] (every step; a guided dispatch
        without mask_fn or tables runs one step), `bias` [B, V], `counts`
        (the penalty count tables, updated after each step), `guided`
        (gtrans [G, V], gmask [G, V], gstate [B], pending: each row's
        state advanced by the token it fed, at step 0 too when pending,
        then its mask row gathered), `mask_fn` (a host callback (t,
        prev_tokens) -> [B, V] bool, fed the tokens read back), the
        logprob report from the raw logits, and `adapter_idx` (the rows'
        LoRA slots, [] or one [B] device tensor). Returns (sampled [B,
        n_steps], lp or None) on the device."""
        out, lps = [], []
        B = tok.shape[0]
        r = torch.arange(B, device=tok.device)
        gs = None
        if guided is not None:
            gtrans, gmask, gs, gpend = guided
            self.stats["guided_device_dispatches"] += 1
        if mask_fn is not None:
            self.stats["guided_host_dispatches"] += 1
        for t in range(n_steps):
            pos = torch.where(pos0 < 0, -1, pos0 + t)
            kvl = torch.where(pos0 < 0, 0, pos0 + t + 1).to(torch.int32)
            logits = llama.forward(
                self.config, self.params, tok[:, None], pos[:, None],
                self.k_pool, self.v_pool, pt, kvl, attn_impl=self.attn_impl, tp=self.tp, ep=self.ep,
                **self._lora_kw(adapter_idx),
            )
            raw = logits[:, 0]
            lg = raw if counts is None else apply_penalties(raw, *counts, samp)
            m = mask
            if guided is not None:
                if t > 0 or gpend:
                    gs = gtrans[gs, tok.long()].long()
                m = gmask[gs]
            if mask_fn is not None:
                # the guided host fallback: each step's tokens read back,
                # its mask built on the host and staged
                with self._allow("token_readback"):
                    prev = tok.cpu().numpy()
                with self._allow("decode_staging"):
                    m = torch.from_numpy(mask_fn(t, prev)).to(self.device)
                self.stats["guided_host_masks"] += 1
            s = sample(lg, samp, step + t, mask=m, bias=bias)
            if n_logprobs >= 0:
                lps.append(top_logprobs(raw, s, n_logprobs))
            if counts is not None:
                one = torch.ones(B, dtype=torch.float32, device=tok.device)
                for table in counts:
                    table.index_put_((r, s.long()), one, accumulate=True)
            tok = s
            out.append(s)
            self.stats["decode_steps"] += 1
        lp = None
        if n_logprobs >= 0:
            lp = tuple(torch.stack([x[i] for x in lps], 1) for i in range(3))
        return torch.stack(out, 1), lp

    # -- guided device tables ----------------------------------------------
    def stage_guided_tables(self, tables):
        """A batch's combined guided tables on the device: (trans [G, V]
        int32, mask [G, V] bool, per-table state offsets), kept staged by
        the schemas' uids (an LRU of 32) so a warm loop uploads only the
        [B] initial states."""
        key = tuple(t.uid for t in tables)
        hit = self._guided_dev_cache.get(key)
        if hit is not None:
            self._guided_dev_cache.move_to_end(key)
            return hit
        trans, mask, offsets = combine_tables(tables)
        with self._allow("decode_staging"):
            hit = (torch.from_numpy(trans).to(self.device),
                   torch.from_numpy(mask).to(self.device), offsets)
        self._guided_dev_cache[key] = hit
        while len(self._guided_dev_cache) > 32:
            self._guided_dev_cache.popitem(last=False)
        return hit

    def _guided_op(self, guided_dev, B: int):
        """A (tables, row_entries, pending) plan as the decode loop's
        `guided` operand for a B-row bucket: the staged tables, each row's
        global initial state (pad and unguided rows in the shared DEAD
        state, all-allowed) and pending."""
        g_tables, g_rows, g_pend = guided_dev
        trans, gmask, offs = self.stage_guided_tables(g_tables)
        dead = int(trans.shape[0]) - 1
        gs0 = np.full(B, dead, np.int32)
        for i, ent in enumerate(g_rows):
            if ent is not None:
                ti, st = ent
                gs0[i] = offs[ti] + int(st)
        gs, = self._upload(gs0)
        return trans, gmask, gs.long(), bool(g_pend)

    # -- fused mixed dispatch ----------------------------------------------
    def _use_ragged(self, n_decode: int, n_chunks: int) -> bool:
        return self.ragged_mixed and n_decode + n_chunks <= RAGGED_MAX_SEGS

    def ensure_ragged_bucket(self, t: int) -> None:
        """Insert an exact T bucket (rounded up to the q block): the
        engine registers its mixed token budget + max batch, so a full
        mixed iteration never rounds up to the next power of two."""
        qb = self.ragged_q_block
        t = max(qb, -(-int(t) // qb) * qb)
        if t not in self.ragged_buckets:
            self.ragged_buckets = tuple(sorted(set(self.ragged_buckets) | {t}))

    def decode_multi_with_prefill(
        self, n_steps: int, tokens: List[int], positions: List[int],
        page_tables: List[List[int]], sampling, step: int,
        chunk_tokens: List[int], chunk_start: int, chunk_table: List[int],
        chunk_prior: int, adapters: Optional[List[int]] = None,
        chunk_adapter: int = 0,
    ) -> Tuple[np.ndarray, torch.Tensor]:
        """decode_multi_with_prefills for one chunk. Returns (sampled
        [B_bucket, n_steps] host, the chunk's last-token logits [V])."""
        chunk = {"tokens": chunk_tokens, "start": chunk_start,
                 "table": chunk_table, "prior": chunk_prior,
                 "adapter": chunk_adapter}
        toks, chunk_logits = self.decode_multi_with_prefills(
            n_steps, tokens, positions, page_tables, sampling, step, [chunk],
            adapters=adapters)
        return toks, chunk_logits[0]

    def decode_multi_with_prefills(
        self,
        n_steps: int,
        tokens: List[int],
        positions: List[int],
        page_tables: List[List[int]],
        sampling,
        step: int,
        chunks: List[Dict[str, Any]],  # {"tokens", "start", "table",
        #   "prior", "adapter"?} per packed chunk (distinct sequences)
        masks: Optional[np.ndarray] = None,  # [n_dec, V] step-0 guided masks
        mask_fn=None,  # GuidedMaskContext for the fused tail steps 1..n-1
        biases: Optional[np.ndarray] = None,  # [n_dec, V] logit-bias rows
        guided_dev=None,  # device guided DFA plan for the fused tail
        adapters: Optional[List[int]] = None,  # the decode rows' LoRA slots
    ) -> Tuple[np.ndarray, torch.Tensor]:
        """One fused mixed iteration: the decode batch's n_steps and the
        packed prefill chunks with one token readback. Rides the ragged
        step; a plan past the largest T bucket (or DYN_RAGGED_MIXED=0)
        takes the padded fallback, which carries no mask or bias: with
        either it raises instead (the engine sheds a chunk and retries, or
        never fuses such a plan). Returns (sampled [B_bucket, n_steps]
        host, per-chunk last-token logits [len(chunks), V] device). Raises
        BucketOverflowError when neither path can shape the plan."""
        out = None
        constrained = not (masks is None and mask_fn is None
                           and biases is None and guided_dev is None)
        if self._use_ragged(len(positions), len(chunks)):
            try:
                out = self._decode_multi_with_prefills_ragged(
                    n_steps, tokens, positions, page_tables, sampling, step,
                    chunks, masks=masks, mask_fn=mask_fn, biases=biases,
                    guided_dev=guided_dev)
            except BucketOverflowError as e:
                if constrained:
                    raise
                log.warning("mixed plan (%d tokens) overflows ragged T "
                            "buckets (largest %d); using the padded fallback",
                            e.n, e.largest)
        elif constrained:
            raise NotImplementedError(
                "guided masks / logit bias require the ragged mixed path")
        if out is None:
            out = self._mixed_loop(n_steps, tokens, positions, page_tables,
                                   sampling, step, chunks, adapters)
        self.stats["mixed_chunks"] += len(chunks)
        return out

    def _mixed_loop(self, n_steps, tokens, positions, page_tables, sampling,
                    step, chunks, adapters=None) -> Tuple[np.ndarray, torch.Tensor]:
        """The padded fallback (the reference's `_mixed_loop` over
        `_prep_prefill_packed`): the chunks as rows of one [N, S] prefill
        batch, each row's tokens a contiguous run from s=0 as the prefill
        kernel needs, then the decode loop. Rows past the real chunks are
        all padding (q_len 0): their KV goes to the spare page and their
        logits are dropped. A LoRA runner uploads each chunk's and each
        decode row's slot with the rest."""
        B = _next_bucket(self.decode_buckets, len(positions))
        packed, p_ad = self._prep_prefill_packed(chunks)
        ad_ints = self._adapter_ints(adapters, B)
        up = self._upload(*packed, *p_ad, _padded(tokens, B, 0),
                          _padded(positions, B, -1), self._pad_page_table(page_tables, B),
                          *ad_ints)
        ptok, ppos, ppt, pkvl, plast = up[:5]
        k = 5 + len(p_ad)
        tok, pos0, pt = up[k:k + 3]
        logits = llama.forward(self.config, self.params, ptok, ppos,
                               self.k_pool, self.v_pool, ppt, pkvl, plast,
                               attn_impl=self.attn_impl, tp=self.tp, ep=self.ep,
                               **self._lora_kw(up[5:k]))
        self.stats["padded_prefill_dispatches"] += 1
        self._note_shape("mixed_padded", (int(packed[0].shape[0]), int(packed[0].shape[1]), B))
        toks, _ = self._decode_loop(n_steps, tok, pos0, pt,
                                    self._device_sampling(sampling, B), step,
                                    adapter_idx=up[k + 3:])
        with self._allow("token_readback"):
            return toks.cpu().numpy(), logits[:len(chunks), 0]

    def _prep_prefill_packed(self, chunks):
        """Host arrays of the padded [N, S] chunk batch: (tokens, positions
        (-1 padding), page tables, kv lens, per-row last indices), and a
        LoRA runner's [N] chunk slots ([] without LoRA)."""
        N = _next_bucket(self.pack_buckets, len(chunks))
        S = _next_bucket(self.prefill_buckets,
                         max(len(c["tokens"]) for c in chunks))
        ptok = np.zeros((N, S), np.int32)
        ppos = np.full((N, S), -1, np.int32)
        pkvl = np.zeros(N, np.int32)
        plast = np.zeros(N, np.int32)
        for i, c in enumerate(chunks):
            n = len(c["tokens"])
            ptok[i, :n] = c["tokens"]
            ppos[i, :n] = np.arange(c["start"], c["start"] + n)
            pkvl[i] = c["prior"] + n
            plast[i] = n - 1
        ppt = self._pad_page_table([c["table"] for c in chunks], N)
        return ((ptok, ppos, ppt, pkvl, plast),
                self._adapter_ints([c.get("adapter") or 0 for c in chunks], N))

    def _prep_ragged(self, tokens, positions, page_tables, chunks):
        """Flatten a mixed plan (the decode rows first, one token each,
        then the chunks) into one [T_bucket] token axis. Returns (flat
        tokens, build_ragged_metadata arrays, the per-segment last-token
        gather [SEG]). Raises BucketOverflowError past the largest T
        bucket."""
        n_dec = len(positions)
        q_lens = [1] * n_dec + [len(c["tokens"]) for c in chunks]
        q_starts = list(positions) + [c["start"] for c in chunks]
        kv_lens = [p + 1 for p in positions] + [
            c["prior"] + len(c["tokens"]) for c in chunks]
        rows = list(page_tables) + [c["table"] for c in chunks]
        t_bucket = _next_bucket(self.ragged_buckets, sum(q_lens))
        md = build_ragged_metadata(
            q_lens, q_starts, kv_lens, rows, t_bucket,
            q_block=self.ragged_q_block, max_pages=self.max_pages_per_seq)
        flat = np.zeros(t_bucket, np.int32)
        flat[:n_dec] = tokens
        off = n_dec
        for c in chunks:
            flat[off:off + len(c["tokens"])] = c["tokens"]
            off += len(c["tokens"])
        gather = _padded(md["last_index"], md["seg_kv_lens"].shape[0], 0)
        return flat, md, gather

    def _decode_multi_with_prefills_ragged(
        self, n_steps, tokens, positions, page_tables, sampling, step, chunks,
        masks=None, mask_fn=None, biases=None, guided_dev=None,
    ) -> Tuple[np.ndarray, torch.Tensor]:
        """Step 0 of the decode batch and every chunk in one ragged flat
        step (decode rows first, one token each, sampled under `masks`
        and `biases`), then steps 1..n-1 through the decode loop chained
        on the step-0 tokens on the device (positions and step advanced
        by one, so every row draws with the same (seed, step) pairs as
        the unfused path) under the bias and `mask_fn` or the device DFA
        plan, pending: the step-0 tokens were sampled on the device and
        are not folded into the rows' states yet. One readback at the
        end."""
        n_dec = len(positions)
        B = _next_bucket(self.decode_buckets, n_dec)
        flat, md, gather = self._prep_ragged(tokens, positions, page_tables,
                                             chunks)
        # the tail's positions ride the same upload
        sampled, seg_logits, views = self._ragged_step(
            flat, md, gather, sampling, step, extra={
                "tail_positions": _padded([p + 1 for p in positions], B, -1)},
            masks=masks, biases=biases)
        self.stats["ragged_mixed_dispatches"] += 1
        self._note_shape("ragged", (len(flat), B))
        tok0 = _first_rows(sampled, B)  # decode rows lead the segment order
        if n_steps > 1:
            if mask_fn is not None:
                mask_fn.B = B
            guided = None
            if guided_dev is not None:
                g_tables, g_rows, _ = guided_dev
                guided = self._guided_op((g_tables, g_rows, True), B)
            # the decode rows' tables are the first segment rows
            rest, _ = self._decode_loop(
                n_steps - 1, tok0, views["tail_positions"],
                _first_rows(views["seg_page_table"], B),
                self._device_sampling(sampling, B), step + 1,
                bias=self._plane(biases, B, 0.0), mask_fn=mask_fn,
                guided=guided)
            toks = torch.cat([tok0[:, None], rest], 1)
        else:
            toks = tok0[:, None]
        with self._allow("token_readback"):
            return toks.cpu().numpy(), seg_logits[n_dec:n_dec + len(chunks)]

    def _ragged_step(
        self,
        flat: np.ndarray,  # [T] flat step tokens
        md: Dict[str, np.ndarray],  # build_ragged_metadata
        gather: np.ndarray,  # [SEG] flat index of each sampled row
        sampling,  # dict of host lists, one row per base sequence
        step: int,
        row_seq: Optional[np.ndarray] = None,  # [SEG] base row per sampled
        #   row (None = identity); verify rows expand one sequence's row
        row_j: Optional[np.ndarray] = None,  # [SEG] verify position per row
        extra: Optional[Dict[str, np.ndarray]] = None,  # more int32
        #   arrays to upload with the step, by name
        masks: Optional[np.ndarray] = None,  # [r, V] bool, sampled-row aligned
        biases: Optional[np.ndarray] = None,  # [r, V] f32, sampled-row aligned
        tok_adapters: Optional[np.ndarray] = None,  # [T] LoRA slot a flat
        #   token (a LoRA runner's verify)
        label: str = "decode_staging",  # the upload's allow scope
    ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
        """The reference's `_ragged_step`: one forward over the flat
        [1, T] step with logits at the SEG gathered rows, then sampling of
        every row under its mask and bias row (rows past those given are
        all-allowed and unbiased). Returns (sampled [SEG] int32,
        seg_logits [SEG, V], the device views of the upload)."""
        seg_cap = gather.shape[0]
        host = {"flat": flat[None], "positions": md["tok_positions"][None],
                "seg_page_table": md["seg_page_table"],
                "seg_kv_lens": md["seg_kv_lens"], "meta": md["meta"],
                "gather": gather, **(extra or {})}
        if row_seq is not None:
            host["row_seq"] = row_seq
        if tok_adapters is not None:
            host["tok_adapters"] = tok_adapters
        views = dict(zip(host, self._upload(*host.values(), label=label)))
        lora_kw = ({} if tok_adapters is None else
                   {"lora": self.lora, "adapter_idx": views["tok_adapters"]})
        logits = llama.forward(
            self.config, self.params, views["flat"], views["positions"],
            self.k_pool, self.v_pool, last_index=views["gather"],
            ragged=(views["seg_page_table"], views["seg_kv_lens"],
                    views["meta"]), attn_impl=self.attn_impl, tp=self.tp, ep=self.ep, **lora_kw)
        seg_logits = logits[0]
        base = self._device_sampling(sampling, seg_cap)
        if row_seq is None:
            samp = base
        else:
            # per-row params gathered on the device from the cached
            # per-sequence base; seeds and the sampled-row list are host
            hot = set(base.sampled_rows)
            samp = base.rows(
                views["row_seq"].long(),
                seeds=[_fold_seed(base.seeds[r], j)
                       for r, j in zip(row_seq, row_j)],
                sampled_rows=[e for e, r in enumerate(row_seq) if r in hot])
        toks = sample(seg_logits, samp, step,
                      mask=self._plane(masks, seg_cap, True),
                      bias=self._plane(biases, seg_cap, 0.0))
        return toks, seg_logits, views

    # -- speculative verify ------------------------------------------------
    def verify_spec(
        self,
        tokens: List[int],
        positions: List[int],
        page_tables: List[List[int]],
        drafts: List[List[int]],
        sampling,
        step: int,
        chunks: Sequence[Dict[str, Any]] = (),
        masks: Optional[Dict[int, np.ndarray]] = None,  # row index -> [V]
        #   bool guided mask of that row's one verify position (guided rows
        #   never draft)
        biases: Optional[Dict[int, np.ndarray]] = None,  # row index -> [V]
        #   f32 logit-bias row, the same draft-less contract
        adapters: Optional[List[int]] = None,  # LoRA slot a row (a LoRA
        #   runner: chunks carry theirs as "adapter")
    ) -> Tuple[List[np.ndarray], Any]:
        """One speculative-verify iteration on the ragged step. Each
        sequence is a segment of len(draft) + 1 tokens (its last real
        token, then the draft) and the gather holds an entry per verify
        position; packed prefill chunks ride behind. Position j > 0 draws
        with the folded seed (greedy rows are unaffected). KV of the fed
        draft tokens lands past computed_len; the engine commits a prefix
        by advancing computed_len. Returns (rows, chunk_logits): rows[i]
        the len(drafts[i]) + 1 target samples, chunk_logits the chunks'
        last-token logits [len(chunks), V] on the device ([] without
        chunks). Raises BucketOverflowError past the T bucket or the
        sampled-row capacity.

        Tree speculation's branch rows are more rows of the same lists
        (after every primary row, so the row-indexed masks and biases
        stay valid): the owner's last token and position on a forked page
        table, with the owner's sampling entries repeated. A branch row
        thus draws with its owner's seed, and identical prefixes sample
        identically (what `accept_tree` relies on); its tokens count
        against the T bucket and the sampled-row capacity as any row's.

        On a LoRA runner every flat token carries its row's (or chunk's)
        slot, so each segment's adapter applies; the reference's ragged
        verify drops them (ROADMAP departures)."""
        chunks = list(chunks)
        n_rows = len(positions)
        row_lens = [len(d) + 1 for d in drafts]
        q_lens = row_lens + [len(c["tokens"]) for c in chunks]
        q_starts = list(positions) + [c["start"] for c in chunks]
        kv_lens = [p + ln for p, ln in zip(positions, row_lens)] + [
            c["prior"] + len(c["tokens"]) for c in chunks]
        rows = list(page_tables) + [c["table"] for c in chunks]
        n_seg = len(q_lens)
        t_bucket = _next_bucket(self.ragged_buckets, sum(q_lens))
        seg_cap = ragged_seg_cap(t_bucket)
        entries = sum(row_lens) + len(chunks)
        if n_seg > RAGGED_MAX_SEGS or entries > seg_cap:
            raise BucketOverflowError(max(n_seg, entries), (seg_cap,))
        md = build_ragged_metadata(
            q_lens, q_starts, kv_lens, rows, t_bucket,
            q_block=self.ragged_q_block, max_pages=self.max_pages_per_seq)
        flat = np.zeros(t_bucket, np.int32)
        off = 0
        for tok, d in zip(tokens, drafts):
            flat[off] = tok
            flat[off + 1:off + 1 + len(d)] = d
            off += len(d) + 1
        for c in chunks:
            flat[off:off + len(c["tokens"])] = c["tokens"]
            off += len(c["tokens"])
        tok_adapters = None
        if self.lora is not None:
            seg_slots = (list(adapters) if adapters else [0] * n_rows) + [
                c.get("adapter") or 0 for c in chunks]
            flat_slots = np.repeat(seg_slots, q_lens)
            tok_adapters = np.zeros(t_bucket, np.int32)  # pad tokens: base
            tok_adapters[:len(flat_slots)] = flat_slots
        cu = md["cu_q_lens"]
        gather = np.zeros(seg_cap, np.int32)
        row_seq = np.zeros(seg_cap, np.int32)
        row_j = np.zeros(seg_cap, np.int32)
        w = 0
        for i in range(n_rows):
            gather[w:w + row_lens[i]] = np.arange(cu[i], cu[i + 1])
            row_seq[w:w + row_lens[i]] = i
            row_j[w:w + row_lens[i]] = np.arange(row_lens[i])
            w += row_lens[i]
        chunk_entry0 = w
        for s in range(n_rows, n_seg):
            gather[w] = cu[s + 1] - 1
            w += 1
        # chunk (and pad) entries sample with a padding row's params
        row_seq[chunk_entry0:] = min(n_rows, seg_cap - 1)
        offs = np.concatenate([[0], np.cumsum(row_lens)])
        row_masks = row_biases = None
        if masks:
            row_masks = np.ones((chunk_entry0, self.config.vocab_size), bool)
            for i, m in masks.items():
                row_masks[offs[i]] = m
        if biases:
            row_biases = np.zeros((chunk_entry0, self.config.vocab_size),
                                  np.float32)
            for i, b in biases.items():
                row_biases[offs[i]] = b
        sampled, seg_logits, _ = self._ragged_step(
            flat, md, gather, sampling, step, row_seq=row_seq, row_j=row_j,
            masks=row_masks, biases=row_biases, tok_adapters=tok_adapters,
            label="verify_staging")
        self.stats["ragged_verify_dispatches"] += 1
        self._note_shape("verify", (t_bucket,))
        with self._allow("token_readback"):
            sampled_h = sampled.cpu().numpy()  # one bulk sync
        out: List[np.ndarray] = []
        w = 0
        for ln in row_lens:
            out.append(sampled_h[w:w + ln])
            w += ln
        if not chunks:
            return out, []
        return out, seg_logits[chunk_entry0:chunk_entry0 + len(chunks)]

    # -- weight reloads ------------------------------------------------------
    def reload_params(self, path: str) -> None:
        """Swap the served weights for a params snapshot's (engine/weights.py
        `save_snapshot`; the rl endpoint's update_weights), copied into the
        tensors this runner holds, leaf by leaf, and requantized under
        `quantize` as quantize_params would: the device holds at most one
        leaf's slice more, and every tensor keeps its address. A self-draft
        sharing these tensors serves the new weights too; a draft tree of
        its own keeps its weights, as the reference's does. The snapshot is
        checked whole before the first copy; a failure after it raises
        weights.PartialReload (the tree then mixes old and new leaves)."""
        t0 = time.monotonic()
        read_snapshot_into(path, self.config, self.params, self.quantize)
        if self.device.type == "cuda":
            with self._allow("weight_reload"):
                torch.cuda.synchronize(self.device)
        log.info("reloaded params from %s in %.2fs", path, time.monotonic() - t0)

    def reset_kv_pools(self) -> None:
        """Zero the KV pools, and the draft's, in place: every cached page
        is lost (the caller resets its PagePool)."""
        for pool in (self.k_pool, self.v_pool, self.draft_k_pool, self.draft_v_pool):
            if pool is not None:
                for t in self._parts(pool):
                    t.zero_()

    # -- draft-model speculation -------------------------------------------
    @property
    def has_draft(self) -> bool:
        return self.draft_config is not None

    def draft_prefill(self, tokens: List[int], start_pos: int,
                      page_table_row: List[int], prior_len: int) -> None:
        """The draft model's KV for a prefill chunk (the target's page
        table); its logits are not computed past the last token and are
        discarded."""
        n = len(tokens)
        S = _next_bucket(self.prefill_buckets, n)
        pos = _padded(range(start_pos, start_pos + n), S, -1)
        tok, pos, pt, kvl = self._upload(
            _padded(tokens, S, 0)[None], pos[None],
            self._pad_page_table([page_table_row]), [prior_len + n])
        llama.forward(self.draft_config, self.draft_params, tok, pos,
                      self.draft_k_pool, self.draft_v_pool, pt, kvl, n - 1)
        self.stats["draft_prefill_chunks"] += 1

    def spec_decode_multi(
        self,
        n_rounds: int,
        tokens: List[int],
        positions: List[int],
        page_tables: List[List[int]],
        sampling,
        step: int,
        gamma: Optional[int] = None,
        adapters: Optional[List[int]] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """n_rounds speculative rounds (engine/spec_decode.py
        `spec_rounds`) with one readback. Returns (tokens [B_bucket, R,
        gamma+1], counts [B_bucket, R]) host arrays; row i's round r holds
        counts[i, r] valid tokens. Padding rows sit at position -1. Page
        tables must cover positions[i] + n_rounds * (gamma + 1) slots.
        `gamma` overrides spec_gamma (the engine shrinks it near a token
        budget so the draft pool never gaps; 0 verifies on the decode
        kernel). `adapters`: the rows' LoRA slots, applied by the target's
        verify only (the draft proposes base-only, as the reference's)."""
        gamma = self.spec_gamma if gamma is None else int(gamma)
        B = _next_bucket(self.decode_buckets, len(tokens))
        tok, pos, pt, *ad = self._upload(
            _padded(tokens, B, 0), _padded(positions, B, -1),
            self._pad_page_table(page_tables, B), *self._adapter_ints(adapters, B),
            label="spec_staging")
        self._note_shape("spec_decode", (B, n_rounds, gamma))
        toks, counts = spec_rounds(
            self.config, self.draft_config, gamma, n_rounds, self.params,
            self.draft_params, tok, pos, self.k_pool, self.v_pool,
            self.draft_k_pool, self.draft_v_pool, pt,
            self._device_sampling(sampling, B), step, **self._lora_kw(ad))
        self.stats["draft_steps"] += n_rounds * (gamma + 1)
        # gamma 0 verifies one token: an S = 1 forward on the decode kernel
        self.stats["spec_verify_passes" if gamma else "decode_steps"] += n_rounds
        with self._allow("token_readback"):
            both = torch.cat([toks.reshape(B, -1), counts], 1).cpu().numpy()
        R = n_rounds
        return both[:, :R * (gamma + 1)].reshape(B, R, gamma + 1), both[:, R * (gamma + 1):]

    # -- the multi-LoRA registry -------------------------------------------
    @property
    def adapter_names(self) -> List[str]:
        return list(self._adapter_slots)

    def register_adapter(self, name: str, factors: Dict[str, Any]) -> int:
        """Install an adapter's factors (models/lora.py layout: {t}_a
        [L, in, r], {t}_b [L, r, out], scaling folded into B, at the
        tree's rank) into the next free slot, in place on the device;
        returns the slot sequences name. A registered name keeps its
        slot and factors."""
        if self.lora is None:
            raise RuntimeError("runner built without lora_slots")
        if name in self._adapter_slots:
            return self._adapter_slots[name]
        slot = len(self._adapter_slots) + 1  # 0 is the base slot
        n_slots = next(iter(self.lora["layers"].values())).shape[1]
        if slot >= n_slots:
            raise RuntimeError(f"all {n_slots - 1} LoRA slots in use")
        lora_mod.set_adapter_slot(self.lora, slot, factors)
        self._adapter_slots[name] = slot
        log.info("registered LoRA adapter %r in slot %d", name, slot)
        return slot

    def adapter_slot(self, name: Optional[str]) -> int:
        """The slot of a registered adapter (0 for None or ""); KeyError
        for an unknown name."""
        if not name:
            return 0
        return self._adapter_slots[name]

    # -- the device n-gram draft ring --------------------------------------
    def ensure_draft_ring(self, slots: int, k: int,
                          window: int = DRAFT_RING_WINDOW) -> int:
        """Allocate the device draft ring ([slots, window] history and the
        slots' lengths, with a host mirror). Returns the per-step delta
        capacity D: the engine resets a slot when a sequence commits more
        than D tokens between proposals."""
        D = max(16, int(k) + 2)
        shape = (int(slots), int(window), D)
        if self._draft_ring_shape == shape and self._draft_ring is not None:
            return D
        hist = np.full((slots, window), -1, np.int32)
        lens = np.zeros(slots, np.int32)
        self._draft_ring_host = (hist, lens)
        self._draft_ring = tuple(self._upload(hist, lens))
        self._draft_ring_dirty = False
        self._draft_ring_shape = shape
        return D

    def draft_ring_reset(self, slot: int, tokens: Sequence[int]) -> None:
        """Rewrite one slot's history (a fresh slot, or a delta larger than
        the append capacity) in the host mirror; the next draft_step
        restages the ring."""
        hist, lens = self._draft_ring_host
        W = hist.shape[1]
        tail = list(tokens)[-W:]
        hist[slot] = -1
        hist[slot, :len(tail)] = tail
        lens[slot] = len(tail)
        self._draft_ring_dirty = True

    def draft_step(self, updates: Sequence[Tuple[int, Sequence[int]]],
                   k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Append each (slot, delta) to the ring and propose k tokens a
        slot (`draft_ring_step`), with one staging copy (the [SLOTS, D]
        delta, or the whole mirror after a reset) and one readback.
        Returns (drafts [SLOTS, k], n_prop [SLOTS]) host arrays."""
        slots, W, D = self._draft_ring_shape
        hist_h, lens_h = self._draft_ring_host
        upd_tok = np.full((slots, D), -1, np.int32)
        upd_n = np.zeros(slots, np.int32)
        for slot, delta in updates:
            d = list(delta)
            if len(d) > D:
                raise ValueError(f"draft delta of {len(d)} tokens exceeds the "
                                 f"ring's capacity {D} (reset the slot)")
            n = len(d)
            upd_tok[slot, :n] = d
            upd_n[slot] = n
            # mirror the append, so a later reset's restage stays coherent
            if lens_h[slot] + n > W:
                over = lens_h[slot] + n - W
                hist_h[slot, :W - over] = hist_h[slot, over:]
                lens_h[slot] -= over
            hist_h[slot, lens_h[slot]:lens_h[slot] + n] = d
            lens_h[slot] += n
        if self._draft_ring_dirty:
            # restage from the mirror, which holds this step's deltas
            # already: the device step appends nothing
            h, ln = self._upload(hist_h, lens_h, label="spec_staging")
            ut = torch.full((slots, D), -1, dtype=torch.int32, device=self.device)
            un = torch.zeros(slots, dtype=torch.int32, device=self.device)
            self._draft_ring_dirty = False
        else:
            h, ln = self._draft_ring
            ut, un = self._upload(upd_tok, upd_n, label="spec_staging")
        h, ln, drafts, n_prop = draft_ring_step(h, ln, ut, un, int(k))
        self._draft_ring = (h, ln)
        self.stats["draft_ring_steps"] += 1
        self._note_shape("draft_ring", (slots, int(k)))
        with self._allow("draft_readback"):
            both = torch.cat([drafts, n_prop[:, None]], 1).cpu().numpy()
        return both[:, :-1], both[:, -1]

    # -- sampling ----------------------------------------------------------
    def sample_one(self, logits: torch.Tensor, sampling, step: int,
                   mask: Optional[np.ndarray] = None,
                   bias: Optional[np.ndarray] = None) -> int:
        samp = self._device_sampling(sampling, 1)
        return int(sample(logits[None, :], samp, step,
                          mask=self._plane(_row(mask), 1, True),
                          bias=self._plane(_row(bias), 1, 0.0))[0])

    def sample_one_ex(self, logits: torch.Tensor, sampling, step: int,
                      history: Optional[List[int]] = None,
                      n_logprobs: int = -1,
                      mask: Optional[np.ndarray] = None,
                      bias: Optional[np.ndarray] = None):
        """sample_one with penalties over `history` (the prompt: nothing
        is generated yet, so only repetition can bite) and/or the logprob
        report of the sampled position. Returns (token, lp) with lp None
        or (tok_lp, top ids, top logprobs)."""
        samp = self._device_sampling(sampling, 1)
        raw = logits[None, :]
        lg = raw
        if history is not None:
            H = -(-max(1, len(history)) // 128) * 128
            hist, plen = self._upload(_padded(history, H, self.config.vocab_size)[None],
                                      [H])
            counts = self._count_tables(hist, plen)
            lg = apply_penalties(raw, counts[0], torch.zeros_like(counts[0]), samp)
        s = sample(lg, samp, step, mask=self._plane(_row(mask), 1, True),
                   bias=self._plane(_row(bias), 1, 0.0))
        if n_logprobs < 0:
            return int(s[0]), None
        tok_lp, ids, vals = top_logprobs(raw, s, n_logprobs)
        return int(s[0]), (float(tok_lp[0]), [int(i) for i in ids[0]],
                           [float(v) for v in vals[0]])

    def embed(self, token_lists: List[List[int]]) -> np.ndarray:
        """Batched embedding forward: [n, E] f32, L2-normalized (the rows
        padded to the decode and prefill buckets, as the reference's)."""
        n = len(token_lists)
        B = _next_bucket(self.decode_buckets, n)
        S = _next_bucket(self.prefill_buckets, max(len(t) for t in token_lists))
        toks = np.zeros((B, S), np.int32)
        for i, t in enumerate(token_lists):
            toks[i, :len(t)] = t
        tok, lens = self._upload(toks, _padded([len(t) for t in token_lists], B, 0))
        vecs = llama.encode(self.config, self.params, tok, lens)[:n]
        with self._allow("embed_readback"):
            return vecs.cpu().numpy()

    def copy_pages(self, src: int, dst: int) -> None:
        """The page pool's fork-on-branch copy hook: page src's KV into
        page dst in every layer (an int8 pool's codes and scales as they
        are, no dequantize round trip)."""
        pools = [self.k_pool, self.v_pool]
        if self.draft_config is not None:  # the draft's pools mirror the tables
            pools += [self.draft_k_pool, self.draft_v_pool]
        for pool in pools:
            for part in self._parts(pool):
                part[:, dst] = part[:, src]
        self.stats["page_copies"] += 1

    def _device_sampling(self, sampling, B: int) -> SamplingParams:
        """Sampling params padded to the bucket, cached on the device:
        batches resend identical lists every dispatch."""
        n = len(sampling["temperature"])
        pen = {name: tuple(sampling.get(name) or [neutral] * n)
               for name, neutral in (("rep", 1.0), ("freq", 0.0),
                                     ("presence", 0.0))}
        key = (B, tuple(sampling["temperature"]), tuple(sampling["top_k"]),
               tuple(sampling["top_p"]), tuple(sampling["seeds"]),
               *pen.values())
        hit = self._sampling_cache.get(key)
        if hit is None:
            pad = B - n
            with self._allow("sampling_staging"):
                hit = SamplingParams.make(
                    temperature=list(sampling["temperature"]) + [0.0] * pad,
                    top_k=list(sampling["top_k"]) + [0] * pad,
                    top_p=list(sampling["top_p"]) + [1.0] * pad,
                    seeds=list(sampling["seeds"]) + [0] * pad,
                    rep_penalty=list(pen["rep"]) + [1.0] * pad,
                    freq_penalty=list(pen["freq"]) + [0.0] * pad,
                    presence_penalty=list(pen["presence"]) + [0.0] * pad,
                    device=self.device,
                )
            if len(self._sampling_cache) >= 512:
                self._sampling_cache.clear()
            self._sampling_cache[key] = hit
        return hit

    # -- KV transfer: the block-copy kernels -------------------------------
    # Pages cross the transfer boundary dense in the runner's dtype,
    # whatever the pools hold (the reference's contract): an int8 pool's
    # codes and scales are gathered by the copy kernels and dequantized on
    # export, and imported pages are quantized again (new per-vector
    # scales: one more rounding, bounded by the int8 step) before the
    # kernels scatter them. Page ids name PagePool pages [0, num_pages); the
    # pools' spare page (index num_pages, the padding rows' KV) never
    # crosses.
    def _page_ids(self, *pages: Sequence[int]) -> List[torch.Tensor]:
        for p in pages[0]:
            if not 0 <= p < self.num_pages:
                raise ValueError(f"page {p} outside [0, {self.num_pages})")
        return self._upload(*pages)

    @staticmethod
    def _parts(pool) -> List[torch.Tensor]:
        """The tensors the copy kernels move for a pool, each [L, NP, PS,
        Hk, D']: the pool, or an int8 pool's codes and its scales as a
        1-wide last dim (a view)."""
        if is_quantized(pool):
            return [pool["q"], pool["s"][..., None]]
        return [pool]

    def _dense_pages(self, pool, idx: torch.Tensor) -> torch.Tensor:
        # the copy kernels read their page ids back once a call
        gather = gather_pages_sharded if self._kv_sharded else gather_pages
        with self._allow("kv_tier_io"):
            parts = [gather(p, idx) for p in self._parts(pool)]
        if is_quantized(pool):
            return kv_pool_dequantize({"q": parts[0], "s": parts[1][..., 0]},
                                      self.dtype)
        return parts[0]

    def _as_stored(self, pool, dense: torch.Tensor) -> List[torch.Tensor]:
        """Dense pages staged on this device, as the pool stores them."""
        dense = self._staged(dense)
        if not is_quantized(pool):
            return [dense]
        d = kv_pool_quantize(dense)
        return [d["q"], d["s"][..., None]]

    def _store_pages(self, pool, idx: torch.Tensor, dense: torch.Tensor) -> None:
        scatter = scatter_pages_sharded if self._kv_sharded else scatter_pages
        with self._allow("kv_tier_io"):
            for p, pages in zip(self._parts(pool), self._as_stored(pool, dense)):
                scatter(p, idx, pages)

    def _store_pages_layers(self, pool, idx: torch.Tensor, dense: torch.Tensor,
                            layer_off: torch.Tensor) -> None:
        """Layer-group scatter: dense [Lg, n, PS, Hk, D] pages into pool
        layers [layer_off, layer_off+Lg) at slots idx — the per-group unit
        of the streamed onboard."""
        with self._allow("kv_tier_io"):
            for p, pages in zip(self._parts(pool), self._as_stored(pool, dense)):
                scatter_pages_layers(p, idx, pages, layer_off)

    def _staged(self, x: torch.Tensor) -> torch.Tensor:
        """Pages as the kernels take them: contiguous, on this device, in
        the pool dtype."""
        return x.contiguous().to(self.device, self.dtype)

    def _host_stage(self, key: str, shape, dtype: torch.dtype) -> torch.Tensor:
        """A persistent pinned host buffer, one per pool part, grown on
        demand to the largest import of pageable pages, so an import pins
        no memory. It is handed out again only after the last copy that
        read it has finished (`_stage_event`). Copies straight from
        pageable memory measured slower than through it
        (scripts/tier_staging_bench.py, PERF.md)."""
        if self._stage_event is not None:
            self._stage_event.synchronize()
            self._stage_event = None
        n = 1
        for d in shape:
            n *= int(d)
        n *= torch.empty((), dtype=dtype).element_size()
        buf = self._stage_bufs.get(key)
        if buf is None or buf.numel() < n:
            buf = torch.empty(n, dtype=torch.uint8,
                              pin_memory=self.device.type == "cuda")
            self._stage_bufs[key] = buf
        return buf[:n].view(dtype).view(tuple(shape))

    def _stage_in(self, key: str, x) -> torch.Tensor:
        """Host pages into staging: x is [L, n, ...] (any CPU tensor or
        view) or a list of n [L, ...] blocks, stacked straight into the
        buffer (no pageable intermediate). On a CPU runner the pages are
        used where they are."""
        if isinstance(x, (list, tuple)):
            if self.device.type != "cuda":
                return torch.stack(list(x), dim=1)
            b0 = x[0]
            shape = (b0.shape[0], len(x)) + tuple(b0.shape[1:])
            out = self._host_stage(key, shape, b0.dtype)
            torch.stack(list(x), dim=1, out=out)
            return out
        if self.device.type != "cuda" or x.device.type == "cuda":
            return x
        out = self._host_stage(key, x.shape, x.dtype)
        out.copy_(x)
        return out

    def _host_block(self, shape, dtype: torch.dtype) -> torch.Tensor:
        """A host tensor for one part of an offloaded block: pinned while
        fewer than `pinned_block_cap` pinned ones are alive (PyTorch's
        caching host allocator recycles the memory of a block the tier
        dropped, once the copies that read it have finished), pageable
        past the cap or when pinning fails."""
        live = self._pinned_live
        if live[0] < self.pinned_block_cap:
            try:
                h = torch.empty(shape, dtype=dtype, pin_memory=True)
            except RuntimeError as e:
                log.warning("pinning a host KV block failed (%s); the host "
                            "tier's later blocks are pageable", e)
                self.pinned_block_cap = live[0]
            else:
                live[0] += 1
                weakref.finalize(h, _unpin_one, live)
                return h
        return torch.empty(shape, dtype=dtype)

    def export_pages_device(self, pages: List[int]):
        """Gather whole KV pages into fresh device buffers (no host copy),
        [L, n, PS, Hk, D] per pool. The gather materializes new tensors, so
        the source pages may be reused once it is enqueued: later writes
        run behind it on the same stream. Under tensor parallelism each
        rank gathers its own heads (gather_pages_sharded) and the ranks'
        slices are all-gathered into whole-head pages: the wire is always
        dense full-head pages, as the reference's. An MLA latent pool is
        whole on every rank: each gathers its own pages and returns them as
        they are, with no collective."""
        idx, = self._page_ids(pages)
        self.stats["kv_pages_exported"] += len(pages)
        k, v = self._dense_pages(self.k_pool, idx), self._dense_pages(self.v_pool, idx)
        if self._kv_sharded:
            k, v = self.tp.all_gather(k, self.kv_cut), self.tp.all_gather(v, self.kv_cut)
        return k, v

    def import_pages_device(self, target_pages: List[int], offset: int, k, v) -> None:
        """Scatter device-staged pages [:, offset:offset+n] into this
        pool's slots (the colocated P→D transfer; the host-staged path
        below is the fallback)."""
        idx, = self._page_ids(target_pages)
        n = len(target_pages)
        self._store_pages(self.k_pool, idx, k[:, offset:offset + n])
        self._store_pages(self.v_pool, idx, v[:, offset:offset + n])
        self.stats["kv_pages_imported"] += n

    def export_page_blocks(self, pages: List[int], quantize: bool = False) -> List[tuple]:
        """Device→host read of whole KV pages as one (k, v) pair of host
        blocks a page, the host tier's unit: dense [L, PS, Hk, D], or with
        `quantize` the tier codec's {"q", "s", "dt"} dicts, quantized on
        the device (ops/tier_codec.py, bit for bit the host codec) so half
        the bytes cross. One gather per pool, the pages made page-major
        on the device, one copy a block part into its own host tensor
        (`_host_block`: pinned up to `pinned_block_cap`, from PyTorch's
        caching host allocator warmed by `reserve_host_memory`), one wait.
        The blocks belong to the caller."""
        k, v = self.export_pages_device(pages)
        cuda = self.device.type == "cuda"
        dt = _WIRE_DTYPES[self.dtype]
        pools = []
        for x in (k, v):
            xp = x.transpose(0, 1).contiguous()  # [n, L, PS, Hk, D]
            pools.append(tier_quantize(xp) if quantize else (xp,))
        out = []
        for i in range(len(pages)):  # page by page: the pinned cap ends at a page
            pair = []
            for parts in pools:
                held = []
                for t in parts:
                    if cuda:
                        h = self._host_block(t.shape[1:], t.dtype)
                        h.copy_(t[i], non_blocking=True)
                    else:
                        h = t[i]
                    held.append(h)
                pair.append({"q": held[0], "s": held[1], "dt": dt}
                            if quantize else held[0])
            out.append(tuple(pair))
        if cuda:
            torch.cuda.current_stream(self.device).synchronize()
        return out

    def reserve_host_memory(self, stage_pages: int, blocks: int, cap_blocks: int,
                            quantize: bool = False) -> None:
        """Pin the host tier's memory off the request path: `blocks`
        offloaded pages' blocks (dense, or the codec's codes and scales),
        allocated pinned and freed at once, so PyTorch's caching host
        allocator hands later offloads memory it already holds (pinning
        fresh memory is slow: PERF.md §6), with at most `cap_blocks` pages'
        blocks pinned at a time (`pinned_block_cap`); and the import
        staging of `stage_pages` pageable pages. Then warm the card's side
        of such an onboard: its device buffers, left in the caching
        allocator, and the copy stream's first copy and event, which a
        first onboard pays otherwise."""
        if self.device.type != "cuda":
            return
        L, PS, Hk, D = self.kv_page_shape
        shapes = ([((L, PS, Hk, D), torch.int8), ((L, PS, Hk), torch.float32)]
                  if quantize else [((L, PS, Hk, D), self.dtype)])
        self.pinned_block_cap = 2 * cap_blocks * len(shapes)
        warm = [torch.empty(shape, dtype=dtype, pin_memory=True)
                for _ in range(2 * blocks) for shape, dtype in shapes]
        del warm
        for key in ("k0", "v0"):
            self._host_stage(key, (L, stage_pages, PS, Hk, D), self.dtype)
        warm = [torch.empty(self._stage_bufs[key].numel(), dtype=torch.uint8,
                            device=self.device) for key in ("k0", "v0")]
        del warm
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._copy_stream):
            torch.empty(16, device=self.device).copy_(
                self._stage_bufs["k0"][:64].view(torch.float32), non_blocking=True)
            torch.cuda.Event().record(self._copy_stream)
        self._copy_stream.synchronize()

    def export_pages(self, pages: List[int]) -> Dict[str, Any]:
        """Device→host read of whole KV pages for P→D transfer, as wire
        bytes [L, n_pages, PS, Hk, D]: one gather per pool, one copy per
        pool into pinned memory, one wait."""
        k, v = self.export_pages_device(pages)
        if self.device.type == "cuda":
            k_h = torch.empty(k.shape, dtype=k.dtype, pin_memory=True)
            v_h = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            k_h.copy_(k, non_blocking=True)
            v_h.copy_(v, non_blocking=True)
            torch.cuda.current_stream(self.device).synchronize()
            k, v = k_h, v_h
        return kv_arrays_to_payload(k, v, tp=self.tp_size)

    @property
    def kv_page_shape(self) -> Tuple[int, int, int, int]:
        """(L, PS, Hk, D) page geometry of this runner's pools — the local
        side of the wire layout handshake (whole heads under tensor
        parallelism: the wire holds full-head pages)."""
        L, _, PS, Hk, D = pool_values(self.k_pool).shape
        return (L, PS, Hk * self.tp_size if self._kv_sharded else Hk, D)

    def _refuse_tp(self, what: str) -> None:
        # payloads a mirrored call may carry that this slice does not take
        if self.group is not None:
            raise refuse_tp(what, ITEM_TIERS)

    @property
    def kv_wire_dtype(self) -> str:
        """Dtype name pages cross the transfer boundary with: the runner's
        dense dtype (int8 pools dequantize on export)."""
        return _WIRE_DTYPES[self.dtype]

    def import_pages(self, target_pages: List[int], offset: int,
                     payload: Dict[str, Any], layer_groups: int = 1) -> None:
        """Host→device write of transferred pages into this pool's page
        slots. `offset` = first payload page to use (earlier pages were
        satisfied by the local prefix cache). Validates the payload's
        layout metadata against the local pool geometry
        (KvWireLayoutMismatch on any divergence). An "int8_ts" payload
        (kv_quant_arrays_to_payload) takes `_import_pages_quant`."""
        if payload.get("quant") == "int8_ts":
            return self._import_pages_quant(target_pages, offset, payload,
                                            layer_groups)
        arrays = kv_payload_to_arrays(payload, self.kv_page_shape,
                                      self.kv_wire_dtype)
        if arrays is None:
            return
        k, v = arrays
        sel = slice(offset, offset + len(target_pages))
        self.import_page_tensors(target_pages, k[:, sel], v[:, sel], layer_groups)

    def import_page_tensors(self, target_pages: List[int], k, v,
                            layer_groups: int = 1) -> None:
        """Dense pages into this pool's slots: k, v [L, n, PS, Hk, D] host
        tensors, or lists of n [L, PS, Hk, D] host blocks (all pinned:
        copied whole; else stacked straight into the staging buffers), in
        the runner's dtype. An int8 pool quantizes them on the device with
        its own quantizer. Under tensor parallelism the pages hold every
        KV head and each rank keeps its own (scatter_pages_sharded); an MLA
        latent page goes whole into every rank's pool.

        layer_groups > 1 streams the import in contiguous layer slabs
        (FlowKV-style): on a card each group's host→device copy runs on a
        copy stream and its scatter on the compute stream behind it, so a
        group's copy overlaps the previous group's scatter. Final pool
        contents are identical to a whole-sequence import."""
        if self.group is not None:
            if isinstance(k, (list, tuple)) or isinstance(v, (list, tuple)):
                self._refuse_tp("importing host-tier page blocks")
            k, v = (cut(x, self.kv_cut, self.tp_rank, self.tp_size) for x in (k, v))
        self._import_staged(target_pages, [k], [v], layer_groups)

    def _import_pages_quant(self, target_pages: List[int], offset: int,
                            payload: Dict[str, Any], layer_groups: int = 1) -> None:
        """The tier codec's int8 + scales pages (kv_quant_arrays_to_payload):
        an int8 pool adopts the codes and scales as they are, with no
        dequantize / requantize; a dense pool dequantizes them on the
        device after the copy (ops/tier_codec.py, the host codec's
        arithmetic bit for bit), one rounding as on the dense wire."""
        self._refuse_tp("the tier codec's int8 pages")
        if payload.get("layout") != KV_WIRE_LAYOUT_VERSION:
            raise KvWireLayoutMismatch(
                f"kv wire layout {payload.get('layout')} != {KV_WIRE_LAYOUT_VERSION}")
        L, PS, Hk, D = self.kv_page_shape
        shape = tuple(payload["shape"])
        got = (shape[0],) + shape[2:]
        if got != (L, PS, Hk, D):
            raise KvWireLayoutMismatch(
                f"quant page geometry {got} != local (L={L}, PS={PS}, "
                f"Hk={Hk}, D={D})")
        sel = slice(offset, offset + len(target_pages))
        kq, ks, vq, vs = (payload[n][sel] for n in ("kq", "ks", "vq", "vs"))
        # the scales as the 1-wide last dim the copy kernels move (_parts)
        self._import_staged(target_pages, [kq, [s[..., None] for s in ks]],
                            [vq, [s[..., None] for s in vs]], layer_groups, codes=True)

    def _import_staged(self, target_pages: List[int], k_parts, v_parts,
                       layer_groups: int, codes: bool = False) -> None:
        """Host pages of each pool part into the pools. `k_parts` /
        `v_parts` hold the dense pages ([pages]) or, `codes`, the tier
        codec's [codes, scales[..., None]], which an int8 pool stores as
        they are and a dense pool dequantizes on the device; each part is
        a [L, n, ...] tensor or a list of n blocks."""
        n = len(target_pages)
        L = self.kv_page_shape[0]
        layered = layer_groups > 1
        bounds = layer_group_bounds(L, layer_groups) if layered else [(0, L)]
        idx, offs = self._page_ids(target_pages, [lo for lo, _ in bounds])
        cuda = self.device.type == "cuda"
        host = {}
        for name, parts in (("k", k_parts), ("v", v_parts)):
            for j, x in enumerate(parts):
                key = f"{name}{j}"
                if cuda and isinstance(x, (list, tuple)) and all(b.is_pinned() for b in x):
                    # pinned blocks (the host tier's own): copied to the
                    # card whole, with no host stack (a host memcpy of the
                    # onboard's bytes, slow when the host is busy)
                    host[key] = list(x)
                else:
                    host[key] = self._stage_in(key, x)
        src, events = host, []
        if cuda:
            main = torch.cuda.current_stream(self.device)
            if self._copy_stream is None:
                self._copy_stream = torch.cuda.Stream(self.device)
            cs = self._copy_stream
            # device staging allocated on the compute stream, written on
            # the copy stream, read on the compute stream after each
            # group's event: freed only behind its last reader. Pinned
            # blocks land page-major, [n, L, ...], each group made
            # layer-major on the compute stream; staged pages are copied a
            # layer group at a time, every group enqueued first, so copy
            # g + 1 runs while group g scatters (each scatter's wrapper
            # reads its page ids back, which waits for the compute stream
            # only).
            src = {key: torch.empty(
                (len(x),) + tuple(x[0].shape) if isinstance(x, list) else x.shape,
                dtype=x[0].dtype if isinstance(x, list) else x.dtype,
                device=self.device) for key, x in host.items()}
            cs.wait_stream(main)
            with torch.cuda.stream(cs):
                for key, x in host.items():
                    if isinstance(x, list):
                        for i, b in enumerate(x):
                            src[key][i].copy_(b, non_blocking=True)
                for lo, hi in bounds:
                    for key, x in host.items():
                        if not isinstance(x, list):
                            src[key][lo:hi].copy_(x[lo:hi], non_blocking=True)
                    ev = torch.cuda.Event()
                    ev.record(cs)
                    events.append(ev)
        for g, (lo, hi) in enumerate(bounds):
            if cuda:
                main.wait_event(events[g])
            grp = {key: (t[:, lo:hi].transpose(0, 1).contiguous()
                         if isinstance(host[key], list) else t[lo:hi])
                   for key, t in src.items()}
            for name, pool in (("k", self.k_pool), ("v", self.v_pool)):
                if not codes:
                    stored = self._as_stored(pool, grp[f"{name}0"])
                elif is_quantized(pool):
                    stored = [grp[f"{name}0"], grp[f"{name}1"]]
                else:
                    stored = [tier_dequantize(grp[f"{name}0"], grp[f"{name}1"][..., 0],
                                              self.dtype)]
                for p, pages in zip(self._parts(pool), stored):
                    if layered:
                        scatter_pages_layers(p, idx, pages, offs[g:g + 1])
                    elif self._kv_sharded:
                        scatter_pages_sharded(p, idx, pages)
                    else:
                        scatter_pages(p, idx, pages)
            if layered:
                self.stats["kv_layer_group_scatters"] += 1
        if cuda:
            # the host buffers are reused once the last copy has read them
            self._stage_event = events[-1]
        self.stats["kv_pages_imported"] += n

    def _pad_page_table(self, rows: List[List[int]], B: Optional[int] = None) -> np.ndarray:
        """[B, max_pages_per_seq] int32, padded with page 0 (a real page:
        the kernels stop at kv_len and never read entries past it)."""
        B = B or len(rows)
        pt = np.zeros((B, self.max_pages_per_seq), np.int32)
        for i, row in enumerate(rows):
            pt[i, : len(row)] = row
        return pt
