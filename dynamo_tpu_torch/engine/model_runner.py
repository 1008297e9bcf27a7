"""ModelRunner: the prefill and decode step functions behind the engine.

Port of dynamo_tpu/engine/model_runner.py's main-path methods: `prefill`,
`decode`, `decode_multi`, `sample_one` and `_pad_page_table`, with the same
decode and prefill buckets (so step shapes match the reference runner's),
`_next_bucket` and `BucketOverflowError`. Params and the KV pools live on
one device; the pools are updated in place. The fused decode loop (a
lax.scan there) is a Python loop here that keeps the sampled tokens on the
device between its steps and copies them to the host once per call.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from dynamo_tpu_torch import resolve_device
from dynamo_tpu_torch.engine.sampling import SamplingParams, sample
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.toolkit import make_kv_pool

log = logging.getLogger("dynamo_tpu_torch.engine.runner")


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
        dtype=torch.bfloat16,
        params: Optional[Dict[str, Any]] = None,  # None: random, seed 0
        device=None,  # None -> cuda (raises without a card); "cpu" for tests
    ):
        self.config = config
        self.device = resolve_device(device)
        self.num_pages = num_pages
        self.page_size = page_size
        self.max_pages_per_seq = max_pages_per_seq
        self.decode_buckets = tuple(decode_buckets)
        self.prefill_buckets = tuple(prefill_buckets)
        self.dtype = dtype
        t0 = time.monotonic()
        self.params = params if params is not None else llama.init_params(
            config, 0, dtype, self.device)
        # one page more than the PagePool hands out: page `num_pages`
        # takes the padding rows' KV writes (models/toolkit.py kv_rows)
        self.k_pool, self.v_pool = make_kv_pool(
            config, num_pages + 1, page_size, dtype, self.device)
        # forward passes by kind, for callers checking kernel launch counts
        self.stats = {"prefill_chunks": 0, "decode_steps": 0}
        self._sampling_cache: Dict[Any, SamplingParams] = {}
        log.info("runner ready: %s params+pool placed in %.1fs on %s "
                 "(%d pages x %d tokens)", config.name, time.monotonic() - t0,
                 self.device, num_pages, page_size)

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
        MP = self.max_pages_per_seq
        # one upload: tokens | positions | page table | kv_len
        packed = np.zeros(2 * S + MP + 1, np.int32)
        packed[:n] = tokens
        packed[S:2 * S] = -1
        packed[S:S + n] = np.arange(start_pos, start_pos + n)
        packed[2 * S:2 * S + MP] = self._pad_page_table([page_table_row])[0]
        packed[-1] = prior_len + n
        dev = torch.from_numpy(packed).to(self.device)
        logits = llama.forward(
            self.config, self.params, dev[:S].view(1, S), dev[S:2 * S].view(1, S),
            self.k_pool, self.v_pool, dev[2 * S:2 * S + MP].view(1, MP),
            dev[-1:], n - 1,
        )
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
        """n_steps decode iterations: forward, sample, feed the sampled
        token back, all on the device; the tokens reach the host once at
        the end. Page tables must already cover positions[i] + n_steps
        slots. Returns sampled tokens [B_bucket, n_steps]."""
        n = len(positions)
        B = _next_bucket(self.decode_buckets, n)
        MP = self.max_pages_per_seq
        packed = np.zeros(2 * B + B * MP, np.int32)  # tokens | pos | table
        packed[:n] = tokens
        packed[B:2 * B] = -1
        packed[B:B + n] = positions
        packed[2 * B:] = self._pad_page_table(page_tables, B).ravel()
        dev = torch.from_numpy(packed).to(self.device)
        tok, pos0 = dev[:B], dev[B:2 * B]
        pt = dev[2 * B:].view(B, MP)
        samp = self._device_sampling(sampling, B)
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
        return torch.stack(out, 1).cpu().numpy()

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

    def _pad_page_table(self, rows: List[List[int]], B: Optional[int] = None) -> np.ndarray:
        """[B, max_pages_per_seq] int32, padded with page 0 (a real page:
        the kernels stop at kv_len and never read entries past it)."""
        B = B or len(rows)
        pt = np.zeros((B, self.max_pages_per_seq), np.int32)
        for i, row in enumerate(rows):
            pt[i, : len(row)] = row
        return pt
