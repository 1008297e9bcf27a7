"""ModelRunner: the step functions behind the engine.

Port of dynamo_tpu/engine/model_runner.py's main-path methods: `prefill`,
`decode`, `decode_multi` (over `_decode_loop`), the fused mixed dispatch
(`decode_multi_with_prefill(s)`: the ragged flat-token step
`_ragged_step`, or the padded [N, S] fallback `_mixed_loop`), the
speculative `verify_spec` on the same ragged step, `sample_one`, and the
KV transfer methods (`export_pages(_device)`, `import_pages(_device)` with
the layer-streamed import) over the block-copy kernels, with the
reference's buckets, `_next_bucket`, `BucketOverflowError` and KV wire
format (`KV_WIRE_LAYOUT_VERSION` 2). Params
and the KV pools live on one device; the pools are updated in place
(`kv_quantize="int8"`: the int8 dict pools of models/quant.py, whose pages
cross the transfer boundary dequantized, so the wire stays in the dense
dtype and bf16 and int8 workers interoperate). Each
dispatch uploads its int32 inputs in one packed copy (`_upload`). The
fused decode loop (a lax.scan there) is a Python loop here that keeps the
sampled tokens on the device between its steps; the tokens reach the host
once per call.
"""

from __future__ import annotations

import logging
import os
import time
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dynamo_tpu_torch import resolve_device
from dynamo_tpu_torch.engine.sampling import SamplingParams, sample
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.quant import kv_pool_dequantize, kv_pool_quantize
from dynamo_tpu_torch.models.toolkit import is_quantized, make_kv_pool, pool_values
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


def _fold_seed(seed: int, j: int) -> int:
    """Verify position j > 0 draws with its own seed (the reference's
    `(seed * 1000003 + j) & 0x7FFFFFFF`); position 0 keeps the row's."""
    return int(seed) if j == 0 else (int(seed) * 1000003 + int(j)) & 0x7FFFFFFF


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
        t0 = time.monotonic()
        self.params = params if params is not None else llama.init_params(
            config, 0, dtype, self.device)
        # one page more than the PagePool hands out: page `num_pages`
        # takes the padding rows' KV writes (models/toolkit.py kv_rows)
        self.kv_quantize = kv_quantize
        self.k_pool, self.v_pool = make_kv_pool(
            config, num_pages + 1, page_size, dtype, self.device,
            kv_quantize=kv_quantize)
        self.stats: Dict[str, int] = {}
        self.reset_stats()
        self._sampling_cache: Dict[Any, SamplingParams] = {}
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
    ) -> np.ndarray:
        """n_steps decode iterations with one host sync at the end. Page
        tables must already cover positions[i] + n_steps slots. Returns
        sampled tokens [B_bucket, n_steps]."""
        B = _next_bucket(self.decode_buckets, len(positions))
        tok, pos0, pt = self._upload(
            _padded(tokens, B, 0), _padded(positions, B, -1),
            self._pad_page_table(page_tables, B))
        return self._decode_loop(n_steps, tok, pos0, pt,
                                 self._device_sampling(sampling, B),
                                 step).cpu().numpy()

    def _decode_loop(self, n_steps: int, tok: torch.Tensor,
                     pos0: torch.Tensor, pt: torch.Tensor,
                     samp: SamplingParams, step: int) -> torch.Tensor:
        """The reference's `_decode_loop`: forward, sample, feed the
        sampled token back, all on the device, from device tokens `tok`
        [B] (host-packed, or chained from an earlier dispatch's samples)
        at positions `pos0` [B] (-1 = padding row) over tables `pt`
        [B, MP]. Returns sampled tokens [B, n_steps] on the device."""
        out = []
        for t in range(n_steps):
            pos = torch.where(pos0 < 0, -1, pos0 + t)
            kvl = torch.where(pos0 < 0, 0, pos0 + t + 1).to(torch.int32)
            logits = llama.forward(
                self.config, self.params, tok[:, None], pos[:, None],
                self.k_pool, self.v_pool, pt, kvl,
            )
            tok = sample(logits[:, 0], samp, step + t)
            out.append(tok)
            self.stats["decode_steps"] += 1
        return torch.stack(out, 1)

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
    ) -> Tuple[np.ndarray, torch.Tensor]:
        """One fused mixed iteration: the decode batch's n_steps and the
        packed prefill chunks with one token readback. Rides the ragged
        step; a plan past the largest T bucket (or DYN_RAGGED_MIXED=0)
        takes the padded fallback. Returns (sampled [B_bucket, n_steps]
        host, per-chunk last-token logits [len(chunks), V] device). Raises
        BucketOverflowError when neither path can shape the plan."""
        out = None
        if self._use_ragged(len(positions), len(chunks)):
            try:
                out = self._decode_multi_with_prefills_ragged(
                    n_steps, tokens, positions, page_tables, sampling, step,
                    chunks)
            except BucketOverflowError as e:
                log.warning("mixed plan (%d tokens) overflows ragged T "
                            "buckets (largest %d); using the padded fallback",
                            e.n, e.largest)
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
        toks = self._decode_loop(n_steps, tok, pos0, pt,
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
    ) -> Tuple[np.ndarray, torch.Tensor]:
        """Step 0 of the decode batch and every chunk in one ragged flat
        step (decode rows first, one token each), then steps 1..n-1
        through the decode loop chained on the step-0 tokens on the
        device (positions and step advanced by one, so every row draws
        with the same (seed, step) pairs as the unfused path); one
        readback at the end."""
        n_dec = len(positions)
        B = _next_bucket(self.decode_buckets, n_dec)
        flat, md, gather = self._prep_ragged(tokens, positions, page_tables,
                                             chunks)
        # the tail's positions ride the same upload
        sampled, seg_logits, views = self._ragged_step(
            flat, md, gather, sampling, step, extra={
                "tail_positions": _padded([p + 1 for p in positions], B, -1)})
        self.stats["ragged_mixed_dispatches"] += 1
        tok0 = _first_rows(sampled, B)  # decode rows lead the segment order
        if n_steps > 1:
            # the decode rows' tables are the first segment rows
            rest = self._decode_loop(
                n_steps - 1, tok0, views["tail_positions"],
                _first_rows(views["seg_page_table"], B),
                self._device_sampling(sampling, B), step + 1)
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
    ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
        """The reference's `_ragged_step`: one forward over the flat
        [1, T] step with logits at the SEG gathered rows, then sampling of
        every row. Returns (sampled [SEG] int32, seg_logits [SEG, V], the
        device views of the upload)."""
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
            idx = views["row_seq"].long()
            hot = set(base.sampled_rows)
            samp = SamplingParams(
                temperature=base.temperature[idx], top_k=base.top_k[idx],
                top_p=base.top_p[idx],
                seeds=[_fold_seed(base.seeds[r], j)
                       for r, j in zip(row_seq, row_j)],
                sampled_rows=[e for e, r in enumerate(row_seq) if r in hot])
        return sample(seg_logits, samp, step), seg_logits, views

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
        sampled-row capacity."""
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
        sampled, seg_logits, _ = self._ragged_step(
            flat, md, gather, sampling, step, row_seq=row_seq, row_j=row_j)
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

    # -- sampling ----------------------------------------------------------
    def sample_one(self, logits: torch.Tensor, sampling, step: int) -> int:
        samp = self._device_sampling(sampling, 1)
        return int(sample(logits[None, :], samp, step)[0])

    def _device_sampling(self, sampling, B: int) -> SamplingParams:
        """Sampling params padded to the bucket, cached on the device:
        batches resend identical lists every dispatch."""
        key = (B, tuple(sampling["temperature"]), tuple(sampling["top_k"]),
               tuple(sampling["top_p"]), tuple(sampling["seeds"]))
        hit = self._sampling_cache.get(key)
        if hit is None:
            pad = B - len(sampling["temperature"])
            hit = SamplingParams.make(
                temperature=list(sampling["temperature"]) + [0.0] * pad,
                top_k=list(sampling["top_k"]) + [0] * pad,
                top_p=list(sampling["top_p"]) + [1.0] * pad,
                seeds=list(sampling["seeds"]) + [0] * pad,
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
