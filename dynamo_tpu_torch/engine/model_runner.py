"""ModelRunner: the step functions behind the engine.

Port of dynamo_tpu/engine/model_runner.py's main-path methods: `prefill`,
`decode`, `decode_multi` (over `_decode_loop`), the fused mixed dispatch
(`decode_multi_with_prefill(s)`: the ragged flat-token step
`_ragged_step`, or the padded [N, S] fallback `_mixed_loop`), the
speculative `verify_spec` on the same ragged step, `sample_one`, and the
KV transfer methods (`export_pages(_device)`, `import_pages(_device)` with
the layer-streamed import) over the block-copy kernels, `copy_pages`
(the page pool's fork-on-branch copy hook), `embed` (the embedding
forward, models/llama.py `encode`), draft-model speculation
(`draft_config`: the draft's params and pools, `draft_prefill`,
`spec_decode_multi` over engine/spec_decode.py `spec_rounds`), the
device n-gram draft ring (`draft_ring_step`, `ensure_draft_ring`,
`draft_ring_reset`, `draft_step`), with the
reference's buckets, `_next_bucket`, `BucketOverflowError` and KV wire
format (`KV_WIRE_LAYOUT_VERSION` 2). Params
and the KV pools live on one device; the pools are updated in place
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
"""

from __future__ import annotations

import logging
import os
import time
import warnings
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
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.quant import (
    QUANT_MODES,
    kv_pool_dequantize,
    kv_pool_quantize,
    check_tree,
    quantize_params,
)
from dynamo_tpu_torch.engine.spec_decode import spec_rounds
from dynamo_tpu_torch.engine.weights import check_fits, serving_bytes
from dynamo_tpu_torch.models.toolkit import (
    is_quantized,
    make_kv_pool,
    pool_values,
)
from dynamo_tpu_torch.ops.block_copy import (
    gather_pages,
    scatter_pages,
    scatter_pages_layers,
)
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


class BucketOverflowError(ValueError):
    """A dispatch needs a shape past the largest configured bucket."""

    def __init__(self, n: int, buckets: Sequence[int]):
        super().__init__(f"{n} exceeds largest bucket {buckets[-1]}")
        self.n = n
        self.largest = buckets[-1]


def _next_bucket(buckets: Sequence[int], n: int) -> int:
    for b in buckets:
        if b >= n:
            return b
    raise BucketOverflowError(n, buckets)


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
    ):
        self.config = config
        self.device = resolve_device(device)
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
        # no ragged attention, so its plans take the padded fallback
        flag = os.environ.get("DYN_RAGGED_MIXED", "").lower()
        self.ragged_mixed = (flag not in ("0", "false", "off", "no")
                             and not config.is_mla)
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
        if self.device.type == "cuda":
            need = serving_bytes(config, num_pages, page_size, dtype, kv_quantize,
                                 quantize, params, draft_config, draft_params)
            check_fits(config.name, need, torch.cuda.mem_get_info(self.device)[0])
        t0 = time.monotonic()
        if params is None:
            # drawn quantized, one matrix at a time
            params = llama.init_params(config, 0, dtype, self.device, quantize)
        elif quantize:
            # a new tree: the caller's stays as it is (another runner may
            # serve it)
            params = quantize_params(params, mode=quantize)
        else:
            check_tree(params)
        self.params = params
        # one page more than the PagePool hands out: page `num_pages`
        # takes the padding rows' KV writes (models/toolkit.py kv_rows)
        self.kv_quantize = kv_quantize
        self.k_pool, self.v_pool = make_kv_pool(
            config, num_pages + 1, page_size, dtype, self.device,
            kv_quantize=kv_quantize)
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
        self._sampling_cache: Dict[Any, SamplingParams] = {}
        # staged guided tables by the uids of their schemas
        self._guided_dev_cache: "OrderedDict[Tuple[int, ...], Any]" = OrderedDict()
        log.info("runner ready: %s params+pool placed in %.1fs on %s "
                 "(%d pages x %d tokens)", config.name, time.monotonic() - t0,
                 self.device, num_pages, page_size)

    def reset_stats(self) -> None:
        self.stats = {k: 0 for k in STAT_KEYS}

    def _upload(self, *arrays) -> List[torch.Tensor]:
        """One host-to-device copy for a dispatch's int32 arrays; returns
        device views with the arrays' shapes."""
        arrays = [np.asarray(a, np.int32) for a in arrays]
        flat = np.concatenate([a.ravel() for a in arrays])
        dev = torch.from_numpy(flat).to(self.device)
        out, off = [], 0
        for a in arrays:
            out.append(dev[off:off + a.size].view(a.shape))
            off += a.size
        return out

    # -- steps -------------------------------------------------------------
    def prefill(
        self,
        tokens: List[int],
        start_pos: int,
        page_table_row: List[int],
        prior_len: int,
    ) -> torch.Tensor:
        """Run one prefill chunk for a single sequence. `tokens` are the
        uncomputed prompt tokens starting at absolute position `start_pos`;
        `prior_len` is the context length already in the pool. Returns
        last-token logits [V] (f32, on the device)."""
        n = len(tokens)
        S = _next_bucket(self.prefill_buckets, n)
        pos = _padded(range(start_pos, start_pos + n), S, -1)
        tok, pos, pt, kvl = self._upload(
            _padded(tokens, S, 0)[None], pos[None],
            self._pad_page_table([page_table_row]), [prior_len + n])
        logits = llama.forward(
            self.config, self.params, tok, pos, self.k_pool, self.v_pool,
            pt, kvl, n - 1)
        self.stats["prefill_chunks"] += 1
        return logits[0, 0]

    def decode(self, tokens: List[int], positions: List[int],
               page_tables: List[List[int]], sampling, step: int) -> np.ndarray:
        """One decode step. Returns sampled token ids [B_bucket] (host)."""
        return self.decode_multi(1, tokens, positions, page_tables, sampling,
                                 step)[:, 0]

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
    ) -> np.ndarray:
        """n_steps decode iterations with one host sync at the end. Page
        tables must already cover positions[i] + n_steps slots. Returns
        sampled tokens [B_bucket, n_steps]."""
        toks, _ = self._decode_dispatch(
            n_steps, tokens, positions, page_tables, sampling, step,
            masks=masks, biases=biases, mask_fn=mask_fn, guided_dev=guided_dev)
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
    ):
        """decode_multi with the sampling extras: `histories` (each row's
        prompt + generated ids; `prompt_lens[i]` marks where its generated
        output starts) switches on the penalties; `n_logprobs` >= 0 adds
        the report (tok_lp [B, T], top_ids [B, T, K], top_lps [B, T, K])
        as host arrays. Returns (sampled [B, T], lp or None)."""
        toks, lp = self._decode_dispatch(
            n_steps, tokens, positions, page_tables, sampling, step,
            n_logprobs=n_logprobs, histories=histories, prompt_lens=prompt_lens,
            masks=masks, biases=biases, mask_fn=mask_fn, guided_dev=guided_dev)
        toks_h = toks.cpu().numpy()
        if lp is None:
            return toks_h, None
        return toks_h, tuple(a.cpu().numpy() for a in lp)

    def _decode_dispatch(self, n_steps, tokens, positions, page_tables, sampling,
                         step, n_logprobs=-1, histories=None, prompt_lens=None,
                         masks=None, biases=None, mask_fn=None, guided_dev=None):
        """Stage one decode dispatch (the ints and the history in one
        upload, the mask and bias planes padded to the bucket: pad rows
        all-allowed and unbiased) and run the loop. Returns device
        (tokens [B, n_steps], lp or None)."""
        B = _next_bucket(self.decode_buckets, len(positions))
        ints = [_padded(tokens, B, 0), _padded(positions, B, -1),
                self._pad_page_table(page_tables, B)]
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
        counts = self._count_tables(*up[3:]) if histories is not None else None
        if mask_fn is not None:
            mask_fn.B = B  # the callback's mask rows match the padded bucket
        return self._decode_loop(
            n_steps, tok, pos0, pt, self._device_sampling(sampling, B), step,
            mask=self._plane(masks, B, True), bias=self._plane(biases, B, 0.0),
            counts=counts, mask_fn=mask_fn,
            guided=self._guided_op(guided_dev, B) if guided_dev else None,
            n_logprobs=n_logprobs)

    def _plane(self, rows: Optional[np.ndarray], n: int, fill) -> Optional[torch.Tensor]:
        """Row-aligned [r, V] mask (bool) or bias (f32) rows padded to n
        rows with `fill`, on the device; None stays None."""
        if rows is None:
            return None
        out = np.full((n, self.config.vocab_size), fill, rows.dtype)
        out[:rows.shape[0]] = rows
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
                     n_logprobs: int = -1):
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
        prev_tokens) -> [B, V] bool, fed the tokens read back), and the
        logprob report from the raw logits. Returns (sampled [B, n_steps],
        lp or None) on the device."""
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
                self.k_pool, self.v_pool, pt, kvl,
            )
            raw = logits[:, 0]
            lg = raw if counts is None else apply_penalties(raw, *counts, samp)
            m = mask
            if guided is not None:
                if t > 0 or gpend:
                    gs = gtrans[gs, tok.long()].long()
                m = gmask[gs]
            if mask_fn is not None:
                m = torch.from_numpy(mask_fn(t, tok.cpu().numpy())).to(self.device)
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
        chunk_prior: int,
    ) -> Tuple[np.ndarray, torch.Tensor]:
        """decode_multi_with_prefills for one chunk. Returns (sampled
        [B_bucket, n_steps] host, the chunk's last-token logits [V])."""
        chunk = {"tokens": chunk_tokens, "start": chunk_start,
                 "table": chunk_table, "prior": chunk_prior}
        toks, chunk_logits = self.decode_multi_with_prefills(
            n_steps, tokens, positions, page_tables, sampling, step, [chunk])
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
        #   "prior"} per packed chunk (distinct sequences)
        masks: Optional[np.ndarray] = None,  # [n_dec, V] step-0 guided masks
        mask_fn=None,  # GuidedMaskContext for the fused tail steps 1..n-1
        biases: Optional[np.ndarray] = None,  # [n_dec, V] logit-bias rows
        guided_dev=None,  # device guided DFA plan for the fused tail
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
                                   sampling, step, chunks)
        self.stats["mixed_chunks"] += len(chunks)
        return out

    def _mixed_loop(self, n_steps, tokens, positions, page_tables, sampling,
                    step, chunks) -> Tuple[np.ndarray, torch.Tensor]:
        """The padded fallback (the reference's `_mixed_loop` over
        `_prep_prefill_packed`): the chunks as rows of one [N, S] prefill
        batch, each row's tokens a contiguous run from s=0 as the prefill
        kernel needs, then the decode loop. Rows past the real chunks are
        all padding (q_len 0): their KV goes to the spare page and their
        logits are dropped."""
        B = _next_bucket(self.decode_buckets, len(positions))
        (ptok, ppos, ppt, pkvl, plast, tok, pos0, pt) = self._upload(
            *self._prep_prefill_packed(chunks), _padded(tokens, B, 0),
            _padded(positions, B, -1), self._pad_page_table(page_tables, B))
        logits = llama.forward(self.config, self.params, ptok, ppos,
                               self.k_pool, self.v_pool, ppt, pkvl, plast)
        self.stats["padded_prefill_dispatches"] += 1
        toks, _ = self._decode_loop(n_steps, tok, pos0, pt,
                                    self._device_sampling(sampling, B), step)
        return toks.cpu().numpy(), logits[:len(chunks), 0]

    def _prep_prefill_packed(self, chunks):
        """Host arrays of the padded [N, S] chunk batch: tokens, positions
        (-1 padding), page tables, kv lens and per-row last indices."""
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
        return ptok, ppos, ppt, pkvl, plast

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
        views = dict(zip(host, self._upload(*host.values())))
        logits = llama.forward(
            self.config, self.params, views["flat"], views["positions"],
            self.k_pool, self.v_pool, last_index=views["gather"],
            ragged=(views["seg_page_table"], views["seg_kv_lens"],
                    views["meta"]))
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
        against the T bucket and the sampled-row capacity as any row's."""
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
            masks=row_masks, biases=row_biases)
        self.stats["ragged_verify_dispatches"] += 1
        sampled_h = sampled.cpu().numpy()  # one bulk sync
        out: List[np.ndarray] = []
        w = 0
        for ln in row_lens:
            out.append(sampled_h[w:w + ln])
            w += ln
        if not chunks:
            return out, []
        return out, seg_logits[chunk_entry0:chunk_entry0 + len(chunks)]

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
    ) -> Tuple[np.ndarray, np.ndarray]:
        """n_rounds speculative rounds (engine/spec_decode.py
        `spec_rounds`) with one readback. Returns (tokens [B_bucket, R,
        gamma+1], counts [B_bucket, R]) host arrays; row i's round r holds
        counts[i, r] valid tokens. Padding rows sit at position -1. Page
        tables must cover positions[i] + n_rounds * (gamma + 1) slots.
        `gamma` overrides spec_gamma (the engine shrinks it near a token
        budget so the draft pool never gaps; 0 verifies on the decode
        kernel)."""
        gamma = self.spec_gamma if gamma is None else int(gamma)
        B = _next_bucket(self.decode_buckets, len(tokens))
        tok, pos, pt = self._upload(_padded(tokens, B, 0), _padded(positions, B, -1),
                                    self._pad_page_table(page_tables, B))
        toks, counts = spec_rounds(
            self.config, self.draft_config, gamma, n_rounds, self.params,
            self.draft_params, tok, pos, self.k_pool, self.v_pool,
            self.draft_k_pool, self.draft_v_pool, pt,
            self._device_sampling(sampling, B), step)
        self.stats["draft_steps"] += n_rounds * (gamma + 1)
        # gamma 0 verifies one token: an S = 1 forward on the decode kernel
        self.stats["spec_verify_passes" if gamma else "decode_steps"] += n_rounds
        both = torch.cat([toks.reshape(B, -1), counts], 1).cpu().numpy()
        R = n_rounds
        return both[:, :R * (gamma + 1)].reshape(B, R, gamma + 1), both[:, R * (gamma + 1):]

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
            h, ln = self._upload(hist_h, lens_h)
            ut = torch.full((slots, D), -1, dtype=torch.int32, device=self.device)
            un = torch.zeros(slots, dtype=torch.int32, device=self.device)
            self._draft_ring_dirty = False
        else:
            h, ln = self._draft_ring
            ut, un = self._upload(upd_tok, upd_n)
        h, ln, drafts, n_prop = draft_ring_step(h, ln, ut, un, int(k))
        self._draft_ring = (h, ln)
        self.stats["draft_ring_steps"] += 1
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
        return llama.encode(self.config, self.params, tok, lens)[:n].cpu().numpy()

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
        parts = [gather_pages(p, idx) for p in self._parts(pool)]
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
        for p, pages in zip(self._parts(pool), self._as_stored(pool, dense)):
            scatter_pages(p, idx, pages)

    def _store_pages_layers(self, pool, idx: torch.Tensor, dense: torch.Tensor,
                            layer_off: torch.Tensor) -> None:
        """Layer-group scatter: dense [Lg, n, PS, Hk, D] pages into pool
        layers [layer_off, layer_off+Lg) at slots idx — the per-group unit
        of the streamed onboard."""
        for p, pages in zip(self._parts(pool), self._as_stored(pool, dense)):
            scatter_pages_layers(p, idx, pages, layer_off)

    def _staged(self, x: torch.Tensor) -> torch.Tensor:
        """Pages as the kernels take them: contiguous, on this device, in
        the pool dtype."""
        return x.contiguous().to(self.device, self.dtype)

    def export_pages_device(self, pages: List[int]):
        """Gather whole KV pages into fresh device buffers (no host copy),
        [L, n, PS, Hk, D] per pool. The gather materializes new tensors, so
        the source pages may be reused once it is enqueued: later writes
        run behind it on the same stream."""
        idx, = self._page_ids(pages)
        self.stats["kv_pages_exported"] += len(pages)
        return self._dense_pages(self.k_pool, idx), self._dense_pages(self.v_pool, idx)

    def import_pages_device(self, target_pages: List[int], offset: int, k, v) -> None:
        """Scatter device-staged pages [:, offset:offset+n] into this
        pool's slots (the colocated P→D transfer; the host-staged path
        below is the fallback)."""
        idx, = self._page_ids(target_pages)
        n = len(target_pages)
        self._store_pages(self.k_pool, idx, k[:, offset:offset + n])
        self._store_pages(self.v_pool, idx, v[:, offset:offset + n])
        self.stats["kv_pages_imported"] += n

    def export_pages(self, pages: List[int]) -> Dict[str, Any]:
        """Device→host read of whole KV pages for P→D transfer and the
        host tier: one gather per pool into a device buffer, one copy per
        pool into pinned host memory, then the wire bytes
        [L, n_pages, PS, Hk, D]."""
        k, v = self.export_pages_device(pages)
        if self.device.type == "cuda":
            k_h = torch.empty(k.shape, dtype=k.dtype, pin_memory=True)
            v_h = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            k_h.copy_(k)
            v_h.copy_(v)
            k, v = k_h, v_h
        return kv_arrays_to_payload(k, v)

    @property
    def kv_page_shape(self) -> Tuple[int, int, int, int]:
        """(L, PS, Hk, D) page geometry of this runner's pools — the local
        side of the wire layout handshake."""
        L, _, PS, Hk, D = pool_values(self.k_pool).shape
        return (L, PS, Hk, D)

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
        (KvWireLayoutMismatch on any divergence).

        layer_groups > 1 streams the import in contiguous layer slabs
        (FlowKV-style): each group's host→device copy and scatter are
        enqueued on their own. Final pool contents are identical to a whole-sequence
        import."""
        arrays = kv_payload_to_arrays(payload, self.kv_page_shape,
                                      self.kv_wire_dtype)
        if arrays is None:
            return
        k, v = arrays
        n = len(target_pages)
        sel = slice(offset, offset + n)
        if layer_groups <= 1:
            idx, = self._page_ids(target_pages)
            self._store_pages(self.k_pool, idx, k[:, sel])
            self._store_pages(self.v_pool, idx, v[:, sel])
        else:
            bounds = layer_group_bounds(self.kv_page_shape[0], layer_groups)
            # the page list and every group's first layer: one upload
            idx, offs = self._page_ids(target_pages, [lo for lo, _ in bounds])
            for g, (lo, hi) in enumerate(bounds):
                self._store_pages_layers(self.k_pool, idx, k[lo:hi, sel],
                                         offs[g:g + 1])
                self._store_pages_layers(self.v_pool, idx, v[lo:hi, sel],
                                         offs[g:g + 1])
                self.stats["kv_layer_group_scatters"] += 1
        self.stats["kv_pages_imported"] += n

    def _pad_page_table(self, rows: List[List[int]], B: Optional[int] = None) -> np.ndarray:
        """[B, max_pages_per_seq] int32, padded with page 0 (a real page:
        the kernels stop at kv_len and never read entries past it)."""
        B = B or len(rows)
        pt = np.zeros((B, self.max_pages_per_seq), np.int32)
        for i, row in enumerate(rows):
            pt[i, : len(row)] = row
        return pt
