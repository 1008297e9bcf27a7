#!/usr/bin/env python3
"""Drive the PyTorch port (dynamo_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. device  - the card, its count, and `nvidia-smi` name and power limit;
  2. build   - build the CUDA kernels from ops/csrc (one nvcc per source,
               all started together), print each one's `ptxas -v` lines
               and fail if an MLA kernel spills;
  3. kernels - each attention kernel at the main path's shapes (Hk 8, G 3,
               D 128, PS 16, bf16) against its plain PyTorch version, with
               times from CUDA events around back-to-back calls (for
               every attention kernel and its yardstick also as CUDA-graph
               replays, `device_ms`, free of the host's launch cost), the
               library yardstick (SDPA over K/V
               gathered dense beforehand) and the roofline bound: decode,
               chunked prefill, and the ragged kernel over a 264-token
               mixed step (8 decode rows + 4 chunks), the same step with
               its last chunk dropped (tail rows must be exactly 0), a
               verify-shaped step (K+1 = 5 rows per segment) and, untimed,
               rows at the edges of its context splits (`split_edges`),
               each ragged case also row by row within ROW_REL_TOL;
               then (`shapes`) all three kernels at the other shapes they
               take, decode at every (D, G) pair it accepts, each also
               row by row within ROW_REL_TOL of the plain version in
               f32; then
               (`copy_kernels`) the three page-copy kernels at
               the 3B page shape (L 28, PS 16, Hk 8, D 128, bf16) in a
               2048-page pool, 94 pages in random order: token- and head-major
               gather, scatter, and a 4-group layer scatter, bit for bit
               against their plain versions; then (`mla_kernels`) the two
               MLA kernels at DeepSeek-V3's shapes (H 128, d_c 512, d_rh
               64, PS 16, bf16): decode at B 8 (an empty row), prefill
               S 512 with q_len 450 over 700 prior tokens, a packed [4, 256]
               prefill with an all-padding row (exactly 0), other page
               sizes and head counts, S 203, a 5-token chunk over 3000
               prior tokens (timed), kv_len 3 past the chunk and q_start
               37, each with its padding rows exactly 0 and each prefill
               also held, within TILES_ULPS bf16 ulps, against
               prefill_mla_tiles_ref (the kernel's tiles and bf16 P in
               plain PyTorch); then
               (`decode_split_edges`)
               both decode kernels with rows at kv_len 0, 1, split - 1,
               split, split + 1, 2 split and 4096 (GQA at the main path's
               heads, MLA at H 16, 32 and 128), untimed;
               then (`gemma_kernels`) the three GQA kernels' Gemma-2
               bodies (window, soft cap, scale, D 256) at D 256 / G 2 and
               D 128 / G 3 against their plain versions in f32 (max abs
               error and, row by row, error over the row's RMS; faults
               planted in the plain computation, a window edge moved by
               one and a tile skipped, must break the row limit), timed
               beside the plain version and SDPA with a window mask or
               the bmm-tanh-softmax-bmm calls (a D 256 instantiation
               that spills fails the build);
               then (`int8_kernels`) the int8 bodies (int8 KV pools,
               models/quant.py) of the three GQA kernels at the
               `kernels` shapes and at the Gemma-2 case, and of MLA
               decode at its shape, each against its plain int8 version
               in f32, timed beside the bf16 yardstick over the K/V
               dequantized beforehand and (prefill, ragged) beside the
               bf16 body's replay; the prefill and ragged ones over pools
               whose per-(token, head) scales spread over three decades,
               also row by row, and at the 3B shape again (`gate_3b`,
               decode, prefill and ragged, untimed) over kv lengths at
               64-token tile edges up to 4097, where planted faults (a
               skipped tile, a window edge moved by one; a K or V
               scale read from the slot before, scales from the next
               head, O's columns left in the kernel's order, Q's dims in
               the kernel's order against K's) must break the row limit;
               int8 MLA decode (its own kernel, mla_decode_codes_kernel)
               also row by row, timed beside the bf16 body's replay at
               the 11,008-token batch and at an engine-shaped one
               (MLA_ENGINE_KV), and gated (untimed) at kv lengths on its
               64-token tile and MLA_INT8_SPLIT_TOKENS split edges at page
               sizes 4-128 (TMA page boxes and a copy a token) over
               scales spread over three decades, with planted faults (a
               scale from the slot before, a row's last tile left out,
               O's dims and Q's dims in the kernel's order) that must
               break the row limit; and kv_quantize on the card against
               the CPU's (codes equal, scales within an ulp);
               then (`head_shape_kernels`) the three GQA kernels at
               qwen2.5-7b's heads (Hk 4, G 7, D 128, `kernels`' decode
               contexts) and phi-3's (Hk 32, G 1, D 96, window 2047,
               contexts 1 to 4000 around the window's edge, chunks
               straddling it; and a 7-token window) and llama-3.2-1b's
               (Hk 8, G 4, D 64), bf16 and int8, checked as
               gemma_kernels' cases (int8 prefill and ragged with their
               planted faults too) and timed with the plain version and
               SDPA, each int8 row beside its bf16 row;
  4. engine  - build_engine for llama-3.2-3b at full width and depth with
               random weights and serve 8 concurrent requests (chunked
               prefill over prior context, a prefix-cache hit, greedy and
               seeded sampled rows) three times on one runner, each with
               every launch count set to 0 just before and read just
               after: `fused` (the default on a card: mixed plans on the
               ragged kernel; the main path), `unfused` (DYN_FUSED_MIXED=0:
               decode, then each chunk on the prefill kernel) and `spec`
               (--spec-ngram, K 4, prompts that repeat n-grams: verify rows
               on the ragged kernel). Each kernel's launches must equal its
               forward passes (runner.stats) x 28 layers;
     disagg  - (`engine_disagg`) a prefill and a decode engine on the card,
               one shared params dict, 1024 pages each, each served by
               serve_worker over the in-process request plane, behind a
               PrefillRouter whose prefill pool comes from discovery: the
               same 8 requests, half pulled on the device (a colocated
               prefill instance), half host-staged through the other
               instance's kv_fetch in chunks of 16 pages; no pull may fall
               back to recompute, the decode engine must run no prefill,
               imported pages must equal the prefill engine's byte for
               byte, and the copy kernels' launches must equal the
               transfer calls x 2 pools;
     tiers   - (`engine_tiers`) one engine with a 160-page pool, a 512-block
               host tier and 4 onboard layer groups: a 1100-token request,
               two 1500-token fillers that evict its pages to the host,
               then a request sharing its first 1024 tokens, onboarded
               from the host (bytes equal to what was offloaded, stream
               equal to a cold prefill's);
  5. parity  - prefill-plus-decode inputs, then one ragged dispatch of
               decode rows and a chunk over prior context, through the
               kernel path and the plain attention path of the forward;
     served  - the request plane. `engine_served_disagg`: a prefill
               and a decode worker (the 3B params again, 1024 pages each)
               served by serve_worker over TCP on loopback in this process,
               neither registered colocated, behind a PrefillRouter from
               discovery: the 8 requests, every pull host-staged through
               kv_fetch in chunks of 16 pages; no recompute fallback, the
               copy kernels' launches equal to the chunks pulled and the
               imports x 2 pools, the attention kernels' launches equal to
               both runners' passes x 28, and the prefill worker's KV
               events (a TCP event-plane subscriber) carrying store events
               for every full page of every prompt; the pull's ms and GB/s
               beside engine_disagg's host-staged pull. Then, with this
               process's runners freed, `engine_served`: `python -m
               dynamo_tpu_torch.worker` with engine_fused's flags as a
               process of its own on the card, file discovery on a
               temporary root; a client runtime here discovers it, sends
               8 other requests of the same lengths one at a time (the
               process's first run of each shape), then the 8 requests
               one at a time (each greedy stream equal to this process's
               engine serving it alone, `alone_phase`) and then all at
               once (each finishing with its 32 tokens), and reports TTFT
               and e2e over the wire beside the in-process engine's, run
               the same way, and engine_fused's; SIGTERM must end the
               worker with exit code 0;
     int8    - with the 3B runner freed, the slice's main path:
               llama-3.1-8b at full width and depth with
               --kv-quantize int8 (`engine_int8kv` fused and
               `engine_int8kv_unfused`: every request `length`, each GQA
               kernel's launches equal to its passes x 32, all on the
               D128_int8 bodies, the pools' bytes beside a bf16 pool's),
               and `parity_int8kv` (as `parity`, over int8 pools; the
               distance to bf16 pools reported);
  6. mla     - (`engine_mla`) DeepSeek-V3's three dense layers at full
               width (get_config("deepseek-v3").with_(n_layers=3,
               n_experts=0), random bf16 weights) serve the same 8 requests
               at the card's default (fused plans on the padded fallback:
               MLA has no ragged path); each MLA kernel's launches must
               equal its forward passes x 3 and no GQA kernel may launch.
               Then (`mla_pages`) one request's latent and stub pages go
               through export/import on the device and through the wire
               with a 3-group layer-streamed import, bit for bit,
               (`parity_mla`) prefill and two decode steps through both
               attention paths of the forward, and (`engine_mla_int8`)
               the same params over an int8 latent: every decode launch
               on the int8 body, no MLA prefill launch (int8 prefill
               gathers, as the reference's does).
  7. gemma  - with the 3B and MLA runners freed, gemma-2-9b at full width
               and depth (42 layers, head dim 256, a 4096-token window on
               the even layers): `engine_gemma2` (fused, the default) and
               `engine_gemma2_unfused` serve the same 8 requests and two
               prompts of 4600 and 5200 tokens, each request `length`,
               each kernel's launches equal to its passes x 42, half on
               the window bodies; `parity_gemma2` prefills a 4700- and a
               4500-token sequence in 512-token chunks through both
               attention paths, then two decode steps and a ragged step
               past the window; `engine_gemma2_int8`, the same params
               over int8 pools, half the launches on the
               D256_int8_window_softcap bodies.
  8. families - with the Gemma-2 runner freed, this slice's paths, each
               model at full width and depth with random weights, 2048
               pages x 16, the 3B's traffic, every request `length` and
               each kernel's launches equal to its passes x L, all on one
               body: `engine_qwen2` and `engine_qwen2_unfused`
               (qwen2.5-7b, G 7, q/k/v biases drawn non-zero; D128) and
               `parity_qwen2`; `engine_phi3`, `engine_phi3_unfused`
               (phi-3-mini-4k, D 96, a 2047-token window on all 32
               layers, prompts of 2600 and 3900 tokens; D96_window),
               `parity_phi3` (sequences of 2600 and 2300 tokens) and
               `engine_phi3_int8` (int8 pools; D96_int8_window); then one
               fused turn and a short parity each, freed in turn, for
               qwen3-8b (D128), mistral-7b (prompts of 4600 and 5200 past
               its 4096-token window on every layer; D128_window),
               gemma-7b (D256), olmo-2-7b and granite-3.1-8b (D128),
               and llama-3.2-1b over int8 pools (16 layers, the card's
               path through the D 64 bodies; D64_int8).
  9. moe     - (`moe_kernels`, after `head_shape_kernels`) the grouped
               GEMM's two entries (ops/csrc/moe_grouped_gemm.cu) at
               qwen3-30b-a3b's experts (E 2048, F 768, 128 of them, top
               8) at T 8, 264 and 512 and DeepSeek-V3's (E 7168, F 2048,
               256) at T 8 and 512, each routed uniformly and skewed (half
               the pairs on one expert, half the experts empty), against
               the plain version in f32: max abs error (x at RMS
               MOE_X_RMS) and row errors over the row's RMS and over its
               max (gate/up is gated on the max form, down on the RMS
               form, both at ROW_REL_TOL; a pair on the wrong expert, a
               dropped last tile and the last tile's middle 64-deep K
               slice left out of its sums, each planted in the plain
               computation, must break the gate), the entries' ptxas
               registers (a spill fails the build check) and route's
               tile size against the kernel's, timed beside the
               per-expert matmul loop, the dense every-expert form and
               torch._grouped_mm, with
               the bound over the touched experts' weights; one
               moe_block under torch.cuda.set_sync_debug_mode("error").
               Then, after every earlier runner is freed,
               `engine_qwen3moe` and `engine_qwen3moe_unfused`
               (qwen3-30b-a3b at full width and depth, 48 MoE layers, G 8,
               61 GB of weights: the 3B's traffic, every request `length`,
               launches = passes x 48 on D128, each grouped-GEMM entry's
               = passes x 48), `parity_qwen3moe_free` (information: each
               path routes on its own logits, and the top-k choices that
               differ are counted) and `parity_qwen3moe` (the plain path
               on the kernel path's routing, held to FORWARD_REL_TOL);
               then `engine_mla_moe` and the two `parity_mla_moe` turns
               (DeepSeek-V3's three dense layers and its first MoE layer,
               get_config("deepseek-v3").with_(n_layers=4), the selection
               bias drawn non-zero: the padded fallback, MLA launches =
               passes x 4, each grouped-GEMM entry's = passes x 1).
Then the `kernels` summary line (launches from the fused phase for the
GQA attention kernels, from engine_disagg for gather and scatter, from
engine_tiers for the layer scatter, from engine_mla for the MLA kernels,
from engine_int8kv and engine_mla_int8 for the `*_int8` entries, the
int8 bodies, from engine_qwen2 for the `*_G7` entries and from
engine_phi3 and engine_phi3_int8 for the `*_D96_window` and
`*_D96_int8_window` entries, whose times are head_shape_kernels', from
engine_qwen3moe for the grouped GEMM's two entries, whose times are
moe_kernels' qwen3-30b-a3b T 264 uniform case; for
the GQA kernels also `variants`, the bodies each engine phase launched),
the
card's name and power limit, and, last, the contract line
{"ok": true, "device": {...}}. Any failed check exits non-zero before it.
It needs a CUDA device and the repository around it; it builds into
build/dynamo_tpu_torch/.
"""

from __future__ import annotations

import asyncio
import gc
import json
import os
import re
import signal
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import torch
import torch.nn.functional as F

from dynamo_tpu_torch.engine.model_runner import ModelRunner
from dynamo_tpu_torch.models.config import get_config
from dynamo_tpu_torch.models.quant import (
    kv_pool_dequantize,
    kv_pool_quantize,
    kv_quantize,
)
from dynamo_tpu_torch.models.toolkit import attn_score_scale, layer_window, pool_values
from dynamo_tpu_torch.models import moe as moe_model
from dynamo_tpu_torch.ops import _build
from dynamo_tpu_torch.ops import block_copy as bc
from dynamo_tpu_torch.ops import moe_dispatch as md
from dynamo_tpu_torch.ops.flash_prefill import (
    prefill_paged_attention,
    prefill_paged_attention_ref,
)
from dynamo_tpu_torch.ops.mla_attention import (
    INT8_TILE_TOKENS,
    MLA_INT8_SPLIT_TOKENS,
    MLA_SPLIT_TOKENS,
    decode_mla_attention,
    decode_mla_attention_ref,
    prefill_mla_attention,
    prefill_mla_attention_ref,
    prefill_mla_tiles_ref,
)
from dynamo_tpu_torch.ops.paged_attention import (
    DECODE_MAX_G,
    DECODE_SPLIT_TOKENS,
    decode_split_tokens,
    decode_paged_attention,
    decode_paged_attention_ref,
)
from dynamo_tpu_torch.ops.ragged_paged_attention import (
    SPLIT_TOKENS,
    build_ragged_metadata,
    ragged_paged_attention,
    ragged_paged_attention_ref,
)
from dynamo_tpu_torch.router.prefill_router import DisaggPolicy, PrefillRouter
from dynamo_tpu_torch.router.protocols import KV_EVENT_SUBJECT
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.discovery import FileDiscovery, MemDiscovery
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.tokens.hashing import block_hashes
from dynamo_tpu_torch.worker import (
    build_engine,
    build_runner,
    parse_args,
    serve_args,
)

# NVIDIA H100 SXM data sheet (dense): HBM3 rate and bf16 tensor-core peak
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
FP32_FLOPS_PER_S = 67e12  # outside the tensor cores
KERNEL_TOL = 0.03  # docs/PERF.md "Kernel parity gate" (max abs err, bf16)
# MLA prefill against prefill_mla_tiles_ref(round_p=True), which rounds P to
# bf16 as the kernel does: max err over the valid rows in bf16 ulps of the
# reference's value (values under 1/8 at 1/8's ulp). The kernel reads 1-6
# ulps there, the f32 plain version 2-5: the tensor cores' accumulation
# moves P by as much as rounding it does, while a missed tile or a mask
# off by one moves outputs by far more (PERF.md, MLA prefill findings)
TILES_ULPS = 8
# forward parity: per-row relative L2 error of the f32 logits between the
# kernel path and the plain path. Both run bf16 activations; the plain
# path also rounds scores and probabilities to bf16, a ~0.4% relative
# error per rounding that 28 layers grow to around 1%. A wrong page, mask
# or softmax moves the logits by O(1) relative.
FORWARD_REL_TOL = 0.05
# the GQA kernels at `kernels`' ragged cases and at `shapes`',
# gemma_kernels' and head_shape_kernels' cases, against the plain version
# in f32: per query row (one head's D
# outputs), the max abs error over the row's RMS. A row over n visible
# tokens has an RMS near n^-1/2 (0.022 at a 2047-token window), so an
# absolute limit is loose exactly where a long window's edge lies. Rounding
# P and the output to bf16 puts a right kernel near 0.01 (a few 2^-9 at
# the row's largest elements); a window edge moved by one token, or a
# skipped 64-token tile, moves some row by more. gemma_case plants both
# faults in the plain computation and fails unless each one breaks this
# limit (the readings on the card: PERF.md, "A row-relative gate")
ROW_REL_TOL = 0.04


def model_args(model: str, max_seq_len: int = 4096, kv_quantize: bool = False):
    """A full-size model's engine flags: 2048 pages of 16 tokens, batch 8,
    chunk 512, as ENGINE_ARGS."""
    return (["--model", model, "--num-pages", "2048", "--page-size", "16",
             "--max-seq-len", str(max_seq_len), "--max-batch", "8",
             "--chunk-size", "512"] + (["--kv-quantize", "int8"] if kv_quantize else []))


ENGINE_ARGS = model_args("llama-3.2-3b")


def timed_runner(args, params=None):
    """build_runner from engine flags: (runner, config, seconds to build)."""
    t0 = time.monotonic()
    runner, cfg = build_runner(parse_args(args), params=params)
    torch.cuda.synchronize()
    return runner, cfg, time.monotonic() - t0


def free(*runners):
    """Drop the runners' pools and params and return their memory."""
    for r in runners:
        r.k_pool = r.v_pool = r.params = None
    gc.collect()
    torch.cuda.empty_cache()


SOURCES = {
    "decode_paged_attention": (
        "dynamo_tpu_torch/ops/csrc/paged_attention.cu",
        "dynamo_tpu/ops/paged_attention.py:302"),
    "prefill_paged_attention": (
        "dynamo_tpu_torch/ops/csrc/flash_prefill.cu",
        "dynamo_tpu/ops/flash_prefill.py:313"),
    "ragged_paged_attention": (
        "dynamo_tpu_torch/ops/csrc/ragged_paged_attention.cu",
        "dynamo_tpu/ops/ragged_paged_attention.py:486"),
    "gather_pages": ("dynamo_tpu_torch/ops/csrc/block_copy.cu",
                     "dynamo_tpu/ops/block_copy.py:79"),
    "scatter_pages": ("dynamo_tpu_torch/ops/csrc/block_copy.cu",
                      "dynamo_tpu/ops/block_copy.py:226"),
    "scatter_pages_layers": ("dynamo_tpu_torch/ops/csrc/block_copy.cu",
                             "dynamo_tpu/ops/block_copy.py:186"),
    "decode_mla_attention": ("dynamo_tpu_torch/ops/csrc/mla_attention.cu",
                             "dynamo_tpu/ops/mla_attention.py:161"),
    "prefill_mla_attention": ("dynamo_tpu_torch/ops/csrc/mla_attention.cu",
                              "dynamo_tpu/ops/mla_attention.py:299"),
    # the grouped GEMM replaces no TPU kernel: XLA computes every expert
    "moe_gate_up": ("dynamo_tpu_torch/ops/csrc/moe_grouped_gemm.cu",
                    "dynamo_tpu/models/moe.py:69 (XLA vmap over experts; no Pallas kernel)"),
    "moe_down": ("dynamo_tpu_torch/ops/csrc/moe_grouped_gemm.cu",
                 "dynamo_tpu/models/moe.py:69 (XLA vmap over experts; no Pallas kernel)"),
}
KERNELS = {"decode_paged_attention": decode_paged_attention,
           "prefill_paged_attention": prefill_paged_attention,
           "ragged_paged_attention": ragged_paged_attention,
           "gather_pages": bc.gather_pages,
           "scatter_pages": bc.scatter_pages,
           "scatter_pages_layers": bc.scatter_pages_layers,
           "decode_mla_attention": decode_mla_attention,
           "prefill_mla_attention": prefill_mla_attention,
           "moe_gate_up": md.moe_gate_up,
           "moe_down": md.moe_down}
COPY_KERNELS = ("gather_pages", "scatter_pages", "scatter_pages_layers")
GQA_KERNELS = ("decode_paged_attention", "prefill_paged_attention",
               "ragged_paged_attention")
GQA_STEMS = ("paged_attention", "flash_prefill", "ragged_paged_attention")
MLA_KERNELS = ("decode_mla_attention", "prefill_mla_attention")
MOE_KERNELS = ("moe_gate_up", "moe_down")
# DeepSeek-V3's first three layers (dense FFN) at full width
MLA_CONFIG = get_config("deepseek-v3").with_(n_layers=3, n_experts=0)
# and its first MoE layer after them (256 experts, one shared, V3's routing)
MLA_MOE_CONFIG = get_config("deepseek-v3").with_(n_layers=4)


class CheckFailed(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over `iters` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Device time of one fn() call: `iters` calls captured in a CUDA
    graph, replayed `replays` times between CUDA events. The host's launch
    cost, which cuda_ms's back-to-back calls include for calls of tens of
    microseconds, is left out."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        fn()  # warm the allocator on the capture stream
        with torch.cuda.graph(graph, stream=side):
            for _ in range(iters):
                fn()
    torch.cuda.synchronize()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (replays * iters)
    del graph
    torch.cuda.empty_cache()
    return ms


def bound(n_bytes: float, n_flops: float, n_fp32: float = 0.0):
    """Least time (ms) for the bytes at the HBM rate, the bf16 tensor-core
    operations and the f32 ones outside the tensor cores (a soft cap's
    tanh) at their peaks, and which of the two kinds bounds it."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(n_flops / BF16_FLOPS_PER_S, n_fp32 / FP32_FLOPS_PER_S) * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def ptxas_lines(log: str):
    """ptxas -v per kernel instantiation: entry name, registers, spills."""
    return [ln.split(":", 1)[-1].strip() for ln in log.splitlines()
            if "Compiling entry" in ln or "registers" in ln or "spill" in ln]


def ptxas_entries(log: str):
    """{kernel instantiation: {registers, stack, spill_stores, spill_loads}}
    from `ptxas -v`, keyed by a short name: the kernel and its template
    arguments, e.g. "prefill_kernel<256,1,0>" (D 256, soft cap, no window)."""
    out, cur = {}, None
    for ln in log.splitlines():
        m = (re.search(r"Compiling entry function '([^']+)'", ln)
             or re.search(r"Function properties for (\S+)", ln))
        if m:
            name = m.group(1)
            kern = re.search(r"([A-Za-z_]+_kernel)", name)
            args = re.findall(r"L[ib](\d+)E", name)
            key = (kern.group(1) if kern else name) + (f"<{','.join(args)}>" if args else "")
            cur = out.setdefault(key, {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            cur.update(stack=int(m[1]), spill_stores=int(m[2]),
                       spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m[1])
    return out


def random_pages(gen, B, MP, NP, dev):
    """[B, MP] int32: distinct pages per row (pages 0..NP-1, a permutation
    slice), so a wrong table read lands on another row's data."""
    perm = torch.randperm(NP, generator=gen, device="cpu")[: B * MP]
    return perm.view(B, MP).to(torch.int32).to(dev)


def dense_kv(pool, page_table, Hk, G):
    """[B, H, C, D] K or V gathered from the pool, heads repeated for GQA
    (built once, outside the timed region of the library call)."""
    B, MP = page_table.shape
    _, PS, _, D = pool.shape
    x = pool[page_table.long()].reshape(B, MP * PS, Hk, D)
    return x.permute(0, 2, 1, 3).repeat_interleave(G, dim=1).contiguous()


# the ragged kernel's main-path step: the chip engine's T bucket (its
# 256-token mixed pool + 8 decode rows), 8 decode rows over contexts up
# to 4096 tokens and 4 chunks (q_len, prior) that cross q-block bounds
RAGGED_T = 264
RAGGED_DECODE_KV = [4096, 1, 17, 1000, 2048, 3333, 513, 64]
RAGGED_CHUNKS = [(125, 700), (67, 0), (48, 1500), (16, 3000)]


def ragged_inputs(gen, segs, T, Hk, G, D, PS, MP, dev):
    """q, pools and kernel operands for segments [(q_len, prior)], each
    on its own pages (a wrong table read lands on another's data)."""
    q_lens = [n for n, _ in segs]
    starts = [p for _, p in segs]
    NP = len(segs) * MP + 1
    pt = random_pages(gen, len(segs), MP, NP, "cpu")
    md = build_ragged_metadata(q_lens, starts, [p + n for n, p in segs],
                               pt.tolist(), T, max_pages=MP)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen).bfloat16().to(dev)

    ints = tuple(torch.from_numpy(md[k]).to(dev)
                 for k in ("seg_page_table", "seg_kv_lens", "meta"))
    return (rnd(T, Hk, G, D), rnd(NP, PS, Hk, D), rnd(NP, PS, Hk, D)) + ints, md


def plain32(tensors):
    """The plain version's f32 operands: bf16 tensors in f32, int8 pools
    (dicts, models/quant.py) as they are."""
    return tuple(x.float() if torch.is_tensor(x) and x.dtype == torch.bfloat16 else x
                 for x in tensors)


def row_rel_err(got, want):
    """Max over the rows (the last dim) of the max abs error over the
    row's RMS in `want`; a row that is 0 in both reads 0."""
    want = want.float()
    err = (got.float() - want).abs().amax(-1)
    rms = want.square().mean(-1).sqrt()
    return torch.where(err == 0, 0.0, err / rms).max().item()


def ragged_check(args, segs, what):
    """Kernel against the plain version on the real rows; tail rows (the
    dummy segment) must be exactly 0. Returns the max abs error and
    row_rel_err against the plain version in f32 (within ROW_REL_TOL)."""
    out = ragged_paged_attention(*args)
    torch.cuda.synchronize()
    ref = ragged_paged_attention_ref(*args)
    n = sum(q for q, _ in segs)
    err = (out[:n].float() - ref[:n].float()).abs().max().item()
    check(torch.isfinite(out.float()).all().item(),
          f"ragged kernel output not finite ({what})")
    check(n == out.shape[0] or out[n:].float().abs().max().item() == 0.0,
          f"ragged tail rows are not 0 ({what})")
    check(err <= KERNEL_TOL, f"ragged kernel max abs err {err} > {KERNEL_TOL} ({what})")
    e_rel = row_rel_err(out[:n], ragged_paged_attention_ref(*plain32(args[:3]),
                                                             *args[3:])[:n])
    check(e_rel <= ROW_REL_TOL, f"ragged kernel row error {e_rel} > {ROW_REL_TOL} ({what})")
    return err, e_rel


def capped_attention(qd, kd, vd, mask, scale, cap):
    """The soft-capped yardstick (no one PyTorch call caps scores): bmm,
    tanh, softmax, bmm over dense [.., H, S, D] and [.., H, C, D] under a
    boolean mask [.., S, C]."""
    def run():
        s = torch.matmul(qd, kd.transpose(-1, -2)).float() * scale
        s = (cap * torch.tanh(s / cap)).masked_fill(~mask, float("-inf"))
        return torch.matmul(torch.softmax(s, -1).to(vd.dtype), vd)
    return run


def ragged_library(args, segs, md, scale, window=0, softcap=0.0):
    """SDPA yardstick inputs: the real queries [1, H, n, D] against every
    segment's visible K/V gathered dense [1, H, C, D] beforehand, under a
    segment-causal mask [n, C] (and the window, if any; with a soft cap,
    capped_attention instead of SDPA)."""
    q, kp, vp = args[:3]
    T, Hk, G, D = q.shape
    dev = q.device
    ks, vs, col_seg, col_pos = [], [], [], []
    for s, (n, p) in enumerate(segs):
        pages = torch.from_numpy(md["seg_page_table"][s]).to(dev).long()
        ks.append(kp[pages].reshape(-1, Hk, D)[:p + n])
        vs.append(vp[pages].reshape(-1, Hk, D)[:p + n])
        col_seg.append(torch.full((p + n,), s, device=dev))
        col_pos.append(torch.arange(p + n, device=dev))

    def heads(x):
        return x.permute(1, 0, 2).repeat_interleave(G, dim=0)[None].contiguous()

    n = sum(q_len for q_len, _ in segs)
    tok_seg = torch.repeat_interleave(
        torch.arange(len(segs), device=dev),
        torch.tensor([q_len for q_len, _ in segs], device=dev))
    tok_pos = torch.from_numpy(md["tok_positions"][:n]).to(dev)
    col_seg, col_pos = torch.cat(col_seg), torch.cat(col_pos)
    mask = ((col_seg[None, :] == tok_seg[:, None])
            & (col_pos[None, :] <= tok_pos[:, None]))
    if window:
        mask &= col_pos[None, :] > tok_pos[:, None] - window
    mask = mask[None, None]
    qd = q[:n].reshape(n, Hk * G, D).transpose(0, 1)[None].contiguous()
    kd, vd = heads(torch.cat(ks)), heads(torch.cat(vs))
    if softcap:
        return capped_attention(qd, kd, vd, mask, scale, softcap)
    return lambda: F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask,
                                                  scale=scale)


def ragged_phase(gen, dev):
    """The ragged kernel at the main path's step (timed), the same step
    without its last chunk (a 16-row tail), a verify-shaped step and,
    untimed, rows at the edges of the kernel's context splits: decode
    rows at kv_len L_s - 1, L_s, L_s + 1 and 2 L_s and an 8-token chunk
    from L_s - 3 (L_s = SPLIT_TOKENS), T 16 (a 4-row tail)."""
    Hk, G, D, PS = 8, 3, 128, 16
    H, MP = Hk * G, 4096 // PS
    scale = D ** -0.5
    decode = [(1, kv - 1) for kv in RAGGED_DECODE_KV]
    L_s = SPLIT_TOKENS
    cases = {
        "mixed": decode + RAGGED_CHUNKS,
        "mixed_tail": decode + RAGGED_CHUNKS[:-1],
        "verify": [(5, max(kv - 5, 0)) for kv in RAGGED_DECODE_KV]
        + RAGGED_CHUNKS[:2],
        "split_edges": [(1, kv - 1) for kv in (L_s - 1, L_s, L_s + 1, 2 * L_s)]
        + [(8, L_s - 3)],
    }
    out = {}
    for name, segs in cases.items():
        T = 16 if name == "split_edges" else RAGGED_T
        args, md = ragged_inputs(gen, segs, T, Hk, G, D, PS, MP, dev)
        rec = {"segments": segs, "t_real": sum(n for n, _ in segs)}
        rec["max_abs_err"], rec["row_rel_err"] = ragged_check(args, segs, name)
        if name == "split_edges":
            out[name] = rec
            continue
        rec["ms"] = cuda_ms(lambda: ragged_paged_attention(*args))
        rec["plain_ms"] = cuda_ms(lambda: ragged_paged_attention_ref(*args),
                                  iters=5)
        if name == "mixed":
            # what the data needs: real q rows read, all T out rows
            # written, each segment's visible K/V once, the table entries
            # of its visible pages, seg_kv_lens and meta; one score and
            # one PV product per visible (query, key) pair
            kv_tok = sum(n + p for n, p in segs)
            n_bytes = (rec["t_real"] * H * D * 2 + RAGGED_T * H * D * 2
                       + kv_tok * Hk * D * 2 * 2
                       + sum(-(-(n + p) // PS) for n, p in segs) * 4
                       + md["seg_kv_lens"].size * 4 + md["meta"].size * 4)
            pairs = sum(p + i + 1 for n, p in segs for i in range(n))
            rec["bound_ms"], rec["bound_by"] = bound(n_bytes, 4 * pairs * H * D)
            lib = ragged_library(args, segs, md, scale)
            rec["library_ms"] = cuda_ms(lib)
            rec["device_ms"] = graph_ms(lambda: ragged_paged_attention(*args))
            rec["library_device_ms"] = graph_ms(lib)
        out[name] = rec
        del args
    top = {k: out["mixed"][k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms", "device_ms",
                                        "library_device_ms")}
    top["max_abs_err"] = max(c["max_abs_err"] for c in out.values())
    top["shape"] = {"T": RAGGED_T, "Hk": Hk, "G": G, "D": D, "PS": PS}
    top["cases"] = out
    return top


def kernel_phase(dev):
    gen = torch.Generator(device="cpu").manual_seed(0)
    Hk, G, D, PS = 8, 3, 128, 16
    H = Hk * G
    scale = D ** -0.5
    results = {}

    # decode: B = 8, ragged kv_len up to 4096, one empty row
    kv_list = [4096, 0, 1, 17, 1000, 2048, 3333, 513]
    B, MP = len(kv_list), 4096 // PS
    NP = B * MP + 1
    k_pool = torch.randn(NP, PS, Hk, D, generator=gen).bfloat16().to(dev)
    v_pool = torch.randn(NP, PS, Hk, D, generator=gen).bfloat16().to(dev)
    q = torch.randn(B, Hk, G, D, generator=gen).bfloat16().to(dev)
    pt = random_pages(gen, B, MP, NP, dev)
    kvl = torch.tensor(kv_list, dtype=torch.int32, device=dev)
    out = decode_paged_attention(q, k_pool, v_pool, pt, kvl)
    torch.cuda.synchronize()
    ref = decode_paged_attention_ref(q, k_pool, v_pool, pt, kvl)
    err = (out.float() - ref.float()).abs().max().item()
    check(torch.isfinite(out.float()).all().item(), "decode kernel output not finite")
    check(out[1].float().abs().max().item() == 0.0, "decode kv_len=0 row is not 0")
    check(err <= KERNEL_TOL, f"decode kernel max abs err {err} > {KERNEL_TOL}")
    kq = dense_kv(k_pool, pt, Hk, G)
    vq = dense_kv(v_pool, pt, Hk, G)
    qd = q.reshape(B, H, 1, D)
    mask = (torch.arange(MP * PS, device=dev)[None, :] < kvl[:, None])[:, None, None, :]
    n_tok = sum(kv_list)
    n_bytes = (2 * q.numel() * 2 + n_tok * Hk * D * 2 * 2
               + sum(-(-k // PS) for k in kv_list) * 4 + B * 4)
    bound_ms, bound_by = bound(n_bytes, 4 * n_tok * H * D)
    def decode():
        return decode_paged_attention(q, k_pool, v_pool, pt, kvl)

    def library():
        return F.scaled_dot_product_attention(qd, kq, vq, attn_mask=mask, scale=scale)

    results["decode_paged_attention"] = {
        "max_abs_err": err,
        "ms": cuda_ms(decode),
        "plain_ms": cuda_ms(lambda: decode_paged_attention_ref(q, k_pool, v_pool, pt, kvl)),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": cuda_ms(library),
        "device_ms": graph_ms(decode), "library_device_ms": graph_ms(library),
        "shape": {"B": B, "Hk": Hk, "G": G, "D": D, "PS": PS,
                  "kv_lens": kv_list},
    }
    del k_pool, v_pool, kq, vq

    # prefill: S = 512 with no prior context, then over 700 prior tokens,
    # both with q_len < S (padding rows)
    cases = []
    for prior, q_len in ((0, 500), (700, 450)):
        S, B = 512, 1
        kv = prior + q_len
        MP = -(-kv // PS) + 2  # table tail past kv_len: other pages
        NP = MP + 1
        k_pool = torch.randn(NP, PS, Hk, D, generator=gen).bfloat16().to(dev)
        v_pool = torch.randn(NP, PS, Hk, D, generator=gen).bfloat16().to(dev)
        q = torch.randn(B, S, Hk, G, D, generator=gen).bfloat16().to(dev)
        pt = random_pages(gen, B, MP, NP, dev)
        ints = [torch.tensor([x], dtype=torch.int32, device=dev)
                for x in (prior, q_len, kv)]
        args = (q, k_pool, v_pool, pt, *ints)
        out = prefill_paged_attention(*args)
        torch.cuda.synchronize()
        ref = prefill_paged_attention_ref(*args)
        err = (out[:, :q_len].float() - ref[:, :q_len].float()).abs().max().item()
        check(torch.isfinite(out.float()).all().item(), "prefill kernel output not finite")
        check(out[:, q_len:].float().abs().max().item() == 0.0,
              "prefill padding rows are not 0")
        check(err <= KERNEL_TOL, f"prefill kernel max abs err {err} > {KERNEL_TOL} "
              f"(prior {prior})")
        kq = dense_kv(k_pool, pt, Hk, G)
        vq = dense_kv(v_pool, pt, Hk, G)
        qd = q.reshape(B, S, H, D).transpose(1, 2)
        s_pos = prior + torch.arange(S, device=dev)
        c_pos = torch.arange(MP * PS, device=dev)
        mask = ((c_pos[None, :] <= s_pos[:, None]) & (c_pos[None, :] < kv))[None, None]
        # what the data needs: valid query rows (q read, out written in
        # full), the K/V rows below min(kv_len, causal top), and one score
        # and one PV product per visible (query, key) pair
        n_pairs = sum(min(prior + s + 1, kv) for s in range(q_len))
        n_bytes = (q_len * H * D * 2 + q.numel() * 2 + kv * Hk * D * 4
                   + (-(-kv // PS)) * 4 + 3 * 4)
        bound_ms, bound_by = bound(n_bytes, 4 * n_pairs * H * D)
        def library():
            return F.scaled_dot_product_attention(qd, kq, vq, attn_mask=mask,
                                                  scale=scale)

        cases.append({
            "prior": prior, "q_len": q_len, "S": S, "max_abs_err": err,
            "ms": cuda_ms(lambda: prefill_paged_attention(*args)),
            "plain_ms": cuda_ms(lambda: prefill_paged_attention_ref(*args)),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": cuda_ms(library),
            "device_ms": graph_ms(lambda: prefill_paged_attention(*args)),
            "library_device_ms": graph_ms(library),
        })
        del k_pool, v_pool, kq, vq
    top = dict(cases[-1])  # the chunked-prefill case heads the summary
    top["max_abs_err"] = max(c["max_abs_err"] for c in cases)
    for k in ("prior", "q_len", "S"):
        top.pop(k)
    top["cases"] = cases
    results["prefill_paged_attention"] = top
    results["ragged_paged_attention"] = ragged_phase(gen, dev)
    emit({"phase": "kernels", "tol": KERNEL_TOL, **results})
    return results


def shapes_phase(dev):
    """The three kernels against their plain versions at the other shapes
    the wrappers accept (head dims 64/96/128, GQA groups, page sizes 4 to
    32, the main path's G 3, qwen2.5-7b's G 7 and phi-3's D 96 among them,
    q-blocks that overrun S), small and untimed; their int8 bodies on the
    same rows, quantized, against the plain int8 versions in f32. Each is
    within KERNEL_TOL of the plain version and within ROW_REL_TOL (row by
    row) of the plain version in f32."""
    gen = torch.Generator(device="cpu").manual_seed(3)
    errs, rel = {}, {}

    def rows(out, ref, name):  # max row error over the plain version in f32
        e = row_rel_err(out, ref)
        check(e <= ROW_REL_TOL, f"{name}: row error {e} > {ROW_REL_TOL}")
        return e

    for D, G, PS in ((128, 4, 16), (128, 1, 8), (128, 8, 32), (64, 4, 16),
                     (64, 2, 4), (128, 3, 16), (128, 3, 4), (64, 3, 32),
                     (96, 1, 16), (96, 7, 4), (128, 7, 16), (96, 4, 32)):
        Hk, MP = 2, max(64, 1024 // PS)  # 1024+ tokens: two context splits
        NP = 3 * MP + 1
        name = f"D{D}_G{G}_PS{PS}"

        def rnd(*shape):
            return torch.randn(*shape, generator=gen).bfloat16().to(dev)

        k_pool, v_pool = rnd(NP, PS, Hk, D), rnd(NP, PS, Hk, D)
        pt = random_pages(gen, 3, MP, NP, dev)
        k8, v8 = kv_pool_quantize(k_pool), kv_pool_quantize(v_pool)
        q = rnd(3, Hk, G, D)
        kvl = torch.tensor([0, 37, 200], dtype=torch.int32, device=dev)
        out = decode_paged_attention(q, k_pool, v_pool, pt, kvl)
        ref = decode_paged_attention_ref(q, k_pool, v_pool, pt, kvl)
        e_dec = (out.float() - ref.float()).abs().max().item()
        r_dec = rows(out, decode_paged_attention_ref(
            *plain32((q, k_pool, v_pool)), pt, kvl), f"decode at {name}")
        check(out[0].float().abs().max().item() == 0.0,
              f"decode kv_len=0 row not 0 at D={D} G={G} PS={PS}")
        out = decode_paged_attention(q, k8, v8, pt, kvl)
        ref = decode_paged_attention_ref(q.float(), k8, v8, pt, kvl)
        e8_dec = (out.float() - ref).abs().max().item()
        r8_dec = rows(out, ref, f"int8 decode at {name}")
        check(out[0].float().abs().max().item() == 0.0,
              f"int8 decode kv_len=0 row not 0 at D={D} G={G} PS={PS}")
        S = 48
        q = rnd(2, S, Hk, G, D)
        qs, ql = [0, 30], [40, 17]
        ints = [torch.tensor(x, dtype=torch.int32, device=dev)
                for x in (qs, ql, [qs[0] + ql[0], qs[1] + ql[1] + 3])]
        args = (q, k_pool, v_pool, pt[:2].contiguous(), *ints)
        out = prefill_paged_attention(*args)
        ref = prefill_paged_attention_ref(*args)
        e_pre = (out.float() - ref.float()).abs().max().item()
        r_pre = rows(out, prefill_paged_attention_ref(*plain32(args[:3]), *args[3:]),
                     f"prefill at {name}")
        torch.cuda.synchronize()
        check(all(out[b, n:].float().abs().max().item() == 0.0
                  for b, n in enumerate(ql)), f"prefill padding rows not 0 at {name}")
        out = prefill_paged_attention(q, k8, v8, *args[3:])
        ref = prefill_paged_attention_ref(q.float(), k8, v8, *args[3:])
        e8_pre = (out.float() - ref).abs().max().item()
        r8_pre = rows(out, ref, f"int8 prefill at {name}")
        check(all(out[b, n:].float().abs().max().item() == 0.0
                  for b, n in enumerate(ql)), f"int8 prefill padding rows not 0 at {name}")
        # ragged: decode rows, chunks over prior context, a row and a
        # chunk past the first context split, a 9-row tail
        segs = [(1, 36), (1, 0), (21, 13), (9, 0), (5, 100), (1, 700),
                (9, SPLIT_TOKENS - 2)]
        args, _ = ragged_inputs(gen, segs, 56, Hk, G, D, PS, MP, dev)
        e_rag, r_rag = ragged_check(args, segs, name)
        args8 = (args[0], kv_pool_quantize(args[1]), kv_pool_quantize(args[2])) + args[3:]
        e8_rag, r8_rag = ragged_check(args8, segs, f"{name} int8")
        errs[name] = {"decode": e_dec, "prefill": e_pre, "ragged": e_rag,
                      "int8": {"decode": e8_dec, "prefill": e8_pre, "ragged": e8_rag}}
        rel[name] = {"decode": r_dec, "prefill": r_pre, "ragged": r_rag,
                     "int8": {"decode": r8_dec, "prefill": r8_pre, "ragged": r8_rag}}
        check(max(e_dec, e_pre, e8_dec, e8_pre) <= KERNEL_TOL,
              f"kernel parity at {name}: decode {e_dec}, prefill {e_pre}, "
              f"int8 decode {e8_dec}, int8 prefill {e8_pre}")
    # decode at every (D, G) its wrapper takes, rows over 1 to 4 splits
    for D in (64, 96, 128):
        for G in range(1, DECODE_MAX_G + 1):
            Hk, PS, MP = 2, 16, 64
            NP = 4 * MP + 1
            k_pool, v_pool = (torch.randn(NP, PS, Hk, D, generator=gen)
                              .bfloat16().to(dev) for _ in range(2))
            pt = random_pages(gen, 4, MP, NP, dev)
            q = torch.randn(4, Hk, G, D, generator=gen).bfloat16().to(dev)
            kvl = torch.tensor([0, 37, DECODE_SPLIT_TOKENS + 5, 1000],
                               dtype=torch.int32, device=dev)
            out = decode_paged_attention(q, k_pool, v_pool, pt, kvl)
            torch.cuda.synchronize()
            ref = decode_paged_attention_ref(q, k_pool, v_pool, pt, kvl)
            err = (out.float() - ref.float()).abs().max().item()
            check(out[0].float().abs().max().item() == 0.0,
                  f"decode kv_len=0 row not 0 at D={D} G={G}")
            check(err <= KERNEL_TOL, f"decode max abs err {err} at D={D} G={G}")
            errs[f"decode_D{D}_G{G}"] = err
            rel[f"decode_D{D}_G{G}"] = rows(out, decode_paged_attention_ref(
                *plain32((q, k_pool, v_pool)), pt, kvl), f"decode at D={D} G={G}")
    emit({"phase": "shapes", "tol": KERNEL_TOL, "max_abs_err": errs,
          "row_tol": ROW_REL_TOL, "row_rel_err": rel})


# page sizes of the int8 decode check beyond the engine's 16: the kernel
# loads a page (or 64 rows) of a head by one TMA box at 8, 32, 64 and 128,
# and a row at a time at 4
INT8_PAGE_SIZES = (4, 8, 32, 64, 128)


def int8_page_sizes(rnd, gate, kv_lens, dev):
    """The int8 decode kernel at INT8_PAGE_SIZES (D 128, Hk 2, G 3; rows at
    kv_lens, the edges of its split), global and with a 100-token window
    (whose low edge falls inside a page and a 64-token tile), against the
    plain int8 version in f32: max abs error within KERNEL_TOL, row error
    within ROW_REL_TOL, the kv_len-0 row exactly 0."""
    Hk, G, D = 2, 3, 128
    B = len(kv_lens)
    kvl = torch.tensor(kv_lens, dtype=torch.int32, device=dev)
    q = rnd(B, Hk, G, D)
    out = {}
    for ps in INT8_PAGE_SIZES:
        MP = -(-max(kv_lens) // ps)
        gen = torch.Generator(device="cpu").manual_seed(ps)
        pt = random_pages(gen, B, MP, B * MP + 1, dev)
        k8, v8 = (kv_pool_quantize(rnd(B * MP + 1, ps, Hk, D)) for _ in range(2))
        for window in (0, 100):
            got = decode_paged_attention(q, k8, v8, pt, kvl, window)
            torch.cuda.synchronize()
            want = decode_paged_attention_ref(q.float(), k8, v8, pt, kvl, window=window)
            what = f"int8 decode PS {ps} window {window}"
            rel = row_rel_err(got, want)
            check(rel <= ROW_REL_TOL, f"{what}: row error {rel} > {ROW_REL_TOL}")
            out[f"PS{ps}_w{window}"] = {"max_abs_err": gate(got, want, what),
                                        "row_rel_err": rel}
        del k8, v8
    return out


def decode_split_edges_phase(dev):
    """Both decode kernels with rows at the edges of their context splits
    (kv_len 0, 1, split - 1, split, split + 1, 2 split and 4096), GQA at
    the main path's heads and MLA at H 16, 32 and 128, bf16 and int8
    (the pools quantized; against the plain int8 version in f32; GQA int8
    at its own split, and at other page sizes: int8_page_sizes), untimed:
    max abs err within KERNEL_TOL, the kv_len-0 row exactly 0."""
    gen = torch.Generator(device="cpu").manual_seed(7)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen).bfloat16().to(dev)

    def edges(split):
        return [0, 1, split - 1, split, split + 1, 2 * split, 4096]

    def gate(out, ref, what):
        err = (out.float() - ref.float()).abs().max().item()
        check(torch.isfinite(out.float()).all().item(), f"{what}: output not finite")
        check(out[0].float().abs().max().item() == 0.0, f"{what}: kv_len=0 row is not 0")
        check(err <= KERNEL_TOL, f"{what}: max abs err {err} > {KERNEL_TOL}")
        return err

    PS, MP = 16, 4096 // 16
    kv_gqa = edges(DECODE_SPLIT_TOKENS)
    B = len(kv_gqa)
    Hk, G, D = 8, 3, 128
    pt = random_pages(gen, B, MP, B * MP + 1, dev)
    kp, vp = rnd(B * MP + 1, PS, Hk, D), rnd(B * MP + 1, PS, Hk, D)
    q = rnd(B, Hk, G, D)
    kvl = torch.tensor(kv_gqa, dtype=torch.int32, device=dev)
    out = decode_paged_attention(q, kp, vp, pt, kvl)
    torch.cuda.synchronize()
    rec = {"gqa": {"split": DECODE_SPLIT_TOKENS, "kv_lens": kv_gqa,
                   "max_abs_err": gate(out, decode_paged_attention_ref(
                       q, kp, vp, pt, kvl), "decode split edges")}}
    # int8 pools: the edges of their own split
    k8, v8 = kv_pool_quantize(kp), kv_pool_quantize(vp)
    kv8 = edges(decode_split_tokens(D, True))
    kvl = torch.tensor(kv8, dtype=torch.int32, device=dev)
    out = decode_paged_attention(q, k8, v8, pt, kvl)
    torch.cuda.synchronize()
    rec["gqa"].update(split_int8=decode_split_tokens(D, True), kv_lens_int8=kv8)
    rec["gqa"]["max_abs_err_int8"] = gate(
        out, decode_paged_attention_ref(q.float(), k8, v8, pt, kvl),
        "int8 decode split edges")
    del kp, vp, k8, v8
    rec["gqa"]["int8_page_sizes"] = int8_page_sizes(rnd, gate, kv8, dev)
    kv_mla = edges(MLA_SPLIT_TOKENS)
    kv_mla8 = edges(MLA_INT8_SPLIT_TOKENS)
    lat = rnd(B * MP + 1, PS, 1, MLA_DC + MLA_DR)
    lat8 = kv_pool_quantize(lat)
    scale = attn_score_scale(MLA_CONFIG, MLA_CONFIG.qk_nope_head_dim + MLA_DR)
    rec["mla"] = {"split": MLA_SPLIT_TOKENS, "kv_lens": kv_mla,
                  "split_int8": MLA_INT8_SPLIT_TOKENS, "kv_lens_int8": kv_mla8,
                  "max_abs_err": {}}
    for H in (16, 32, 128):
        q = rnd(B, H, MLA_DC + MLA_DR)
        for kind, pool, qr, kv in (("", lat, q, kv_mla), ("_int8", lat8, q.float(), kv_mla8)):
            kvl = torch.tensor(kv, dtype=torch.int32, device=dev)
            out = decode_mla_attention(q, pool, pt, kvl, dc=MLA_DC, scale=scale)
            torch.cuda.synchronize()
            ref = decode_mla_attention_ref(qr, pool, pt, kvl, dc=MLA_DC, scale=scale)
            rec["mla"]["max_abs_err"][f"H{H}{kind}"] = gate(
                out, ref, f"MLA{kind} decode split edges H {H}")
    del lat, lat8
    torch.cuda.empty_cache()
    emit({"phase": "decode_split_edges", "tol": KERNEL_TOL, **rec})


# the page-copy kernels at the 3B page shape: the pages of a 1500-token
# prompt in a 2048-page pool, and the onboard's 4 layer groups
COPY_SHAPE = (28, 2048, 16, 8, 128)  # L, NP, PS, Hk, D
COPY_N = 94
COPY_GROUPS = 4


def copy_kernel_phase(dev):
    """gather (token- and head-major), scatter and the layered scatter
    against their plain versions, bit for bit, each timed three ways: the
    kernel launch alone (`ms`, operands checked once beforehand), the
    wrapper with its checks (`wrapper_ms`: one readback of the page ids
    per call), the plain version and one PyTorch library call."""
    L, NP, PS, Hk, D = COPY_SHAPE
    dgen = torch.Generator(device=dev).manual_seed(4)
    cgen = torch.Generator(device="cpu").manual_seed(4)
    pool = torch.randn(COPY_SHAPE, generator=dgen, device=dev).bfloat16()
    pages = torch.randn((L, COPY_N, PS, Hk, D), generator=dgen, device=dev).bfloat16()
    idx = torch.randperm(NP, generator=cgen)[:COPY_N].to(torch.int32).to(dev)
    idx_l = idx.long()
    # read once and written once: the pages' bytes twice
    bound_ms, bound_by = bound(2 * pages.numel() * pages.element_size(), 0)
    out = {}

    def exact(a, b, what):
        check(torch.equal(a, b), f"{what}: kernel differs from its plain version")
        return (a.float() - b.float()).abs().max().item()

    for head_major in (False, True):
        got = bc.gather_pages(pool, idx, head_major=head_major)
        torch.cuda.synchronize()
        want = bc.gather_pages_ref(pool, idx, head_major=head_major)
        buf = torch.empty_like(got)
        rec = {
            "max_abs_err": exact(got, want, f"gather head_major={head_major}"),
            "ms": cuda_ms(lambda: bc._launch_gather(pool, idx, buf, head_major)),
            "wrapper_ms": cuda_ms(lambda: bc.gather_pages(pool, idx,
                                                          head_major=head_major)),
            "plain_ms": cuda_ms(lambda: bc.gather_pages_ref(pool, idx,
                                                            head_major=head_major)),
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        if head_major:
            rec["library_ms"] = cuda_ms(lambda: pool.index_select(1, idx_l)
                                        .transpose(2, 3).contiguous())
            out["gather_pages"]["cases"] = {"head_major": rec}
        else:
            rec["library_ms"] = cuda_ms(lambda: pool.index_select(1, idx_l))
            out["gather_pages"] = rec
    del got, want, buf

    a, b = pool.clone(), pool.clone()
    bc.scatter_pages(a, idx, pages)
    torch.cuda.synchronize()
    bc.scatter_pages_ref(b, idx, pages)
    out["scatter_pages"] = {
        "max_abs_err": exact(a, b, "scatter"),
        "ms": cuda_ms(lambda: bc._launch_scatter(a, idx, pages)),
        "wrapper_ms": cuda_ms(lambda: bc.scatter_pages(a, idx, pages)),
        "plain_ms": cuda_ms(lambda: bc.scatter_pages_ref(a, idx, pages)),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": cuda_ms(lambda: a.index_copy_(1, idx_l, pages)),
    }
    dup = idx.clone()
    dup[1] = dup[0]
    try:
        bc.scatter_pages(a, dup, pages)
        check(False, "scatter accepted repeated page ids")
    except ValueError:
        pass
    del a

    # the streamed onboard of one pool: 4 layer groups, 4 launches
    c = pool.clone()
    groups = [(g * L // COPY_GROUPS, (g + 1) * L // COPY_GROUPS)
              for g in range(COPY_GROUPS)]
    offs = torch.tensor([lo for lo, _ in groups], dtype=torch.int32, device=dev)
    slabs = [pages[lo:hi] for lo, hi in groups]

    def layered(fn):
        def run():
            for g in range(COPY_GROUPS):
                fn(c, idx, slabs[g], offs[g:g + 1])
        return run

    layered(bc.scatter_pages_layers)()
    torch.cuda.synchronize()
    out["scatter_pages_layers"] = {
        "groups": groups,
        "max_abs_err": exact(c, b, "layer scatter vs whole-pool scatter"),
        "ms": cuda_ms(layered(bc._launch_scatter)),
        "wrapper_ms": cuda_ms(layered(bc.scatter_pages_layers)),
        "plain_ms": cuda_ms(layered(bc.scatter_pages_layers_ref)),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": cuda_ms(lambda: [
            c[lo:hi].index_copy_(1, idx_l, slab)
            for (lo, hi), slab in zip(groups, slabs)]),
    }
    del b, c, pool, pages
    torch.cuda.empty_cache()
    emit({"phase": "copy_kernels", "tol": 0.0,
          "shape": {"L": L, "NP": NP, "PS": PS, "Hk": Hk, "D": D, "n": COPY_N,
                    "dtype": "bfloat16"}, **out})
    return out


# the MLA kernels at DeepSeek-V3's shapes
MLA_H, MLA_DC, MLA_DR, MLA_PS = 128, 512, 64, 16
MLA_DECODE_KV = [4096, 0, 1, 17, 1000, 2048, 3333, 513]
MLA_PACKED = [(256, 0), (130, 500), (0, 0), (77, 1500)]  # (q_len, prior)
# the timed prefill: S 512, q_len 450 over 700 prior tokens
MLA_TIMED_S, MLA_TIMED_SEG = 512, (450, 700)
# name: (PS, H, S, segments (q_len, prior[, kv_len past the chunk]))
MLA_PREFILL_CASES = {
    "packed": (MLA_PS, MLA_H, 256, MLA_PACKED),
    "PS8_H16": (8, 16, 200, [(200, 37), (1, 0), (0, 0)]),
    "PS32_H32": (32, 32, 200, [(64, 900), (33, 5)]),
    "S203": (MLA_PS, MLA_H, 203, [(203, 100), (150, 0)]),
    "short_chunk_long_prior": (MLA_PS, MLA_H, 8, [(5, 3000)]),
    "kv_past_chunk": (MLA_PS, MLA_H, 64, [(64, 300, 3), (40, 0, 3)]),
    "q_start_37": (MLA_PS, MLA_H, 128, [(128, 37), (100, 37)]),
}


def mla_rnd(gen, dev):
    return lambda *shape: torch.randn(*shape, generator=gen).bfloat16().to(dev)


def mla_decode_args(gen, dev, kv=MLA_DECODE_KV, PS=MLA_PS):
    """(q, lat, page_table, kv_lens): rows of kv tokens (MLA_DECODE_KV) at
    DeepSeek-V3's shapes, a 4096-token table a row."""
    rnd = mla_rnd(gen, dev)
    B, MP = len(kv), -(-4096 // PS)
    NP = B * MP + 1
    lat = rnd(NP, PS, 1, MLA_DC + MLA_DR)
    q = rnd(B, MLA_H, MLA_DC + MLA_DR)
    pt = random_pages(gen, B, MP, NP, dev)
    return q, lat, pt, torch.tensor(kv, dtype=torch.int32, device=dev)


def mla_prefill_args(gen, PS, H, S, segs, dev):
    """(q, lat, page_table, q_start, q_len, kv_lens) for segments (q_len,
    prior[, kv_len past the chunk]) over a shared pool, one table page past
    the longest row."""
    rnd = mla_rnd(gen, dev)
    B = len(segs)
    kv = [n + p + sum(x) for n, p, *x in segs]
    MP = max(-(-k // PS) for k in kv) + 1
    NP = B * MP + 1
    lat = rnd(NP, PS, 1, MLA_DC + MLA_DR)
    pt = random_pages(gen, B, MP, NP, dev)
    ints = [torch.tensor(x, dtype=torch.int32, device=dev)
            for x in ([p for _, p, *_ in segs], [n for n, *_ in segs], kv)]
    return (rnd(B, S, H, MLA_DC + MLA_DR), lat, pt, *ints)


def ulps_err(got, want, q_len):
    """A prefill output against a reference over the valid rows: (max abs
    err, max err in bf16 ulps of the reference's value, values under 1/8
    counted at 1/8's ulp)."""
    errs = []
    for b, n in enumerate(q_len):
        if n > 0:
            w = want[b, :n].float()
            ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp(min=0.125))) - 7)
            d = (got[b, :n].float() - w).abs()
            errs.append((d.max().item(), (d / ulp).max().item()))
    return max(e for e, _ in errs), max(u for _, u in errs)


def mla_library(q, dense, mask, dc, scale):
    """One PyTorch call for the same function over the latent gathered
    dense beforehand: q [B, H, n, Dl], dense [B, C, Dl], mask [B, 1, n, C].
    SDPA with K = the latent (one head shared by all) and V = its first dc
    columns, on the first fused backend that takes it; where every one
    refuses (Dk != Dv, Dk 576), a matmul-softmax-matmul. Returns (fn,
    backend name)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    k = dense[:, None]
    v = dense[:, None, :, :dc]
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION):
        def run(backend=backend):
            with sdpa_kernel([backend]):
                return F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, scale=scale, enable_gqa=True)
        try:
            with warnings.catch_warnings():  # each refusal warns its reason
                warnings.simplefilter("ignore", UserWarning)
                run()
            torch.cuda.synchronize()
            return run, f"sdpa_{backend.name.lower()}"
        except (RuntimeError, TypeError):
            continue
    B, H, n, Dl = q.shape
    qf = q.reshape(B, H * n, Dl)
    maskf = mask.expand(B, H, n, -1).reshape(B, H * n, -1)
    lat_t = dense.transpose(1, 2)
    val = dense[..., :dc]

    def mm():
        s = torch.bmm(qf, lat_t).float() * scale
        p = torch.softmax(s.masked_fill(~maskf, float("-inf")), -1)
        return torch.bmm(p.to(q.dtype), val)
    return mm, "matmul_softmax_matmul"


def mla_kernel_phase(dev):
    """Both MLA kernels against their plain versions at DeepSeek-V3's
    shapes, timed with their bound and the library yardstick; a packed
    prefill batch with an all-padding row; other page sizes and head
    counts, untimed."""
    gen = torch.Generator(device="cpu").manual_seed(6)
    H, dc, dr, PS = MLA_H, MLA_DC, MLA_DR, MLA_PS
    Dl = dc + dr
    scale = attn_score_scale(MLA_CONFIG, MLA_CONFIG.qk_nope_head_dim + dr)
    results = {}

    rnd = mla_rnd(gen, dev)

    # decode: B 8, kv_len up to 4096, one empty row
    kv_list = MLA_DECODE_KV
    args = mla_decode_args(gen, dev)
    q, lat, pt, kvl = args
    B, MP = len(kv_list), pt.shape[1]
    out = decode_mla_attention(*args, dc=dc, scale=scale)
    torch.cuda.synchronize()
    ref = decode_mla_attention_ref(*args, dc=dc, scale=scale)
    err = (out.float() - ref.float()).abs().max().item()
    check(torch.isfinite(out.float()).all().item(), "MLA decode output not finite")
    check(out[1].float().abs().max().item() == 0.0, "MLA decode kv_len=0 row is not 0")
    check(err <= KERNEL_TOL, f"MLA decode max abs err {err} > {KERNEL_TOL}")
    # what the data needs: q read, out written, each visible latent row
    # once, the table entries of the visible pages, kv_lens; one score
    # (Dl wide) and one PV product (dc wide) per (head, context token)
    n_tok = sum(kv_list)
    n_bytes = (q.numel() * 2 + B * H * dc * 2 + n_tok * Dl * 2
               + sum(-(-k // PS) for k in kv_list) * 4 + B * 4)
    bound_ms, bound_by = bound(n_bytes, 2 * n_tok * H * (Dl + dc))
    dense = lat[pt.long()].reshape(B, MP * PS, Dl)
    mask = (torch.arange(MP * PS, device=dev)[None, :] < kvl[:, None])[:, None, None, :]
    lib_fn, lib_name = mla_library(q[:, :, None], dense, mask, dc, scale)
    results["decode_mla_attention"] = {
        "max_abs_err": err,
        "ms": cuda_ms(lambda: decode_mla_attention(*args, dc=dc, scale=scale)),
        "plain_ms": cuda_ms(lambda: decode_mla_attention_ref(*args, dc=dc, scale=scale)),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": cuda_ms(lib_fn), "library": lib_name,
        "device_ms": graph_ms(lambda: decode_mla_attention(*args, dc=dc, scale=scale)),
        "library_device_ms": graph_ms(lib_fn),
        "shape": {"B": B, "H": H, "dc": dc, "dr": dr, "PS": PS, "kv_lens": kv_list},
    }
    del lat, dense, args

    # prefill: S 512, q_len 450 over 700 prior tokens (padding rows after)
    S, (q_len, prior) = MLA_TIMED_S, MLA_TIMED_SEG
    kv = prior + q_len
    MP = -(-kv // PS) + 2  # table tail past kv_len: other pages
    lat = rnd(MP + 1, PS, 1, Dl)
    q = rnd(1, S, H, Dl)
    pt = random_pages(gen, 1, MP, MP + 1, dev)
    ints = [torch.tensor([x], dtype=torch.int32, device=dev) for x in (prior, q_len, kv)]
    args = (q, lat, pt, *ints)
    out = prefill_mla_attention(*args, dc=dc, scale=scale)
    torch.cuda.synchronize()
    ref = prefill_mla_attention_ref(*args, dc=dc, scale=scale)
    err = (out[:, :q_len].float() - ref[:, :q_len].float()).abs().max().item()
    check(torch.isfinite(out.float()).all().item(), "MLA prefill output not finite")
    check(out[:, q_len:].float().abs().max().item() == 0.0,
          "MLA prefill padding rows are not 0")
    check(err <= KERNEL_TOL, f"MLA prefill max abs err {err} > {KERNEL_TOL}")
    want_t, _ = prefill_mla_tiles_ref(*args, dc=dc, scale=scale)
    err_t, ulps_t = ulps_err(out, want_t, [q_len])
    check(ulps_t <= TILES_ULPS, f"MLA prefill vs its tiles ref: {ulps_t} ulps > "
          f"{TILES_ULPS} (max abs err {err_t})")
    n_pairs = sum(min(prior + s + 1, kv) for s in range(q_len))
    n_bytes = (q_len * H * Dl * 2 + S * H * dc * 2 + kv * Dl * 2
               + (-(-kv // PS)) * 4 + 3 * 4)
    bound_ms, bound_by = bound(n_bytes, 2 * n_pairs * H * (Dl + dc))
    dense = lat[pt.long()].reshape(1, MP * PS, Dl)
    s_pos = prior + torch.arange(q_len, device=dev)
    c_pos = torch.arange(MP * PS, device=dev)
    mask = ((c_pos[None, :] <= s_pos[:, None]) & (c_pos[None, :] < kv))[None, None]
    q_heads = q[:, :q_len].permute(0, 2, 1, 3).contiguous()  # [1, H, n, Dl]
    lib_fn, lib_name = mla_library(q_heads, dense, mask, dc, scale)
    results["prefill_mla_attention"] = {
        "max_abs_err": err, "tiles_max_abs_err": err_t, "tiles_max_ulps": ulps_t,
        "plain_tiles_max_ulps": ulps_err(ref, want_t, [q_len])[1],
        "ms": cuda_ms(lambda: prefill_mla_attention(*args, dc=dc, scale=scale)),
        "plain_ms": cuda_ms(lambda: prefill_mla_attention_ref(*args, dc=dc, scale=scale),
                            iters=5),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": cuda_ms(lib_fn), "library": lib_name,
        "device_ms": graph_ms(lambda: prefill_mla_attention(*args, dc=dc, scale=scale)),
        "library_device_ms": graph_ms(lib_fn),
        "shape": {"S": S, "q_len": q_len, "prior": prior, "H": H, "dc": dc,
                  "dr": dr, "PS": PS},
    }
    del lat, dense, args, q_heads, want_t

    # a packed [4, 256] prefill batch (the padded fallback's shape) with an
    # all-padding row, other page sizes and head counts, then the causal
    # edges at DeepSeek-V3's shapes: S not a multiple of the block's 4
    # tokens, a short chunk over a long prior (timed: few blocks, long
    # walks), kv_len past the chunk, q_start off the 32-token tile
    cases = {}
    for name, (PSx, Hx, Sx, segs) in MLA_PREFILL_CASES.items():
        Bx = len(segs)
        ql = [n for n, *_ in segs]
        kvx = [n + p + sum(x) for n, p, *x in segs]
        pargs = mla_prefill_args(gen, PSx, Hx, Sx, segs, dev)
        lat = pargs[1]
        got = prefill_mla_attention(*pargs, dc=dc, scale=scale)
        dargs = (rnd(Bx, Hx, Dl), lat, pargs[2], pargs[5])
        got_d = decode_mla_attention(*dargs, dc=dc, scale=scale)
        torch.cuda.synchronize()
        want = prefill_mla_attention_ref(*pargs, dc=dc, scale=scale)
        want_d = decode_mla_attention_ref(*dargs, dc=dc, scale=scale)
        check(torch.isfinite(got.float()).all().item(), f"MLA prefill not finite ({name})")
        pad_zero = all(got[b, n:].float().abs().max().item() == 0.0
                       for b, n in enumerate(ql) if n < Sx)
        check(pad_zero, f"MLA prefill padding rows are not 0 ({name})")
        e_p = max((got[b, :n].float() - want[b, :n].float()).abs().max().item()
                  for b, n in enumerate(ql) if n > 0)
        e_d = (got_d.float() - want_d.float()).abs().max().item()
        check(max(e_p, e_d) <= KERNEL_TOL,
              f"MLA kernels at {name}: prefill {e_p}, decode {e_d}")
        want_t, _ = prefill_mla_tiles_ref(*pargs, dc=dc, scale=scale)
        e_t, u_t = ulps_err(got, want_t, ql)
        check(u_t <= TILES_ULPS, f"MLA prefill vs its tiles ref at {name}: {u_t} ulps > "
              f"{TILES_ULPS} (max abs err {e_t})")
        cases[name] = {"segments": segs, "S": Sx, "PS": PSx, "H": Hx,
                       "prefill_max_abs_err": e_p, "prefill_tiles_max_abs_err": e_t, "prefill_tiles_max_ulps": u_t,
                       "plain_tiles_max_ulps": ulps_err(want, want_t, ql)[1],
                       "decode_max_abs_err": e_d}
        if name == "short_chunk_long_prior":
            n_pairs = sum(min(p + s + 1, k) for (n, p, *_), k in zip(segs, kvx)
                          for s in range(n))
            n_bytes = (sum(ql) * Hx * Dl * 2 + Bx * Sx * Hx * dc * 2 + sum(kvx) * Dl * 2
                       + sum(-(-k // PSx) for k in kvx) * 4 + 3 * Bx * 4)
            cases[name]["bound_ms"], cases[name]["bound_by"] = bound(
                n_bytes, 2 * n_pairs * Hx * (Dl + dc))
            cases[name]["device_ms"] = graph_ms(
                lambda: prefill_mla_attention(*pargs, dc=dc, scale=scale))
        del lat, pargs, dargs, want_t
    results["prefill_mla_attention"]["cases"] = cases
    torch.cuda.empty_cache()
    emit({"phase": "mla_kernels", "tol": KERNEL_TOL, "tiles_ulps": TILES_ULPS, **results})
    return results


async def _serve(engine, reqs, shared_idx, late_req):
    """Serve `reqs` concurrently; `late_req` (sharing a prefix with
    reqs[shared_idx]) is sent once that request has its first token, so
    its prefix pages are registered and it hits the prefix cache."""
    first_token = asyncio.Event()

    async def collect(i, req):
        toks, finish, phases = [], None, {}
        async for item in engine.generate(req, Context(request_id=f"r{i}")):
            toks.extend(item["token_ids"])
            if item["token_ids"] and i == shared_idx:
                first_token.set()
            if item.get("finish_reason"):
                finish = item["finish_reason"]
                phases = item.get("phases") or {}
                if finish == "error":
                    raise CheckFailed(f"request r{i} finished with error")
        return toks, finish, phases

    tasks = [asyncio.create_task(collect(i, r)) for i, r in enumerate(reqs)]
    await first_token.wait()
    tasks.append(asyncio.create_task(collect(len(reqs), late_req)))
    return await asyncio.gather(*tasks)


N_OUT = 32  # output tokens per request


def workload(vocab_size: int, seed: int, extra=()):
    """8 requests from a seed: prompts of 17 to 1500 tokens (the long ones
    run chunked prefill over prior context, chunk 512), mostly greedy, two
    sampled (temperature 0.8, top_p 0.9, seeded); the last request shares
    a 256-token prefix with the one before it. `extra` adds greedy
    requests with prompts of those lengths (drawn after the others, so the
    eight stay the same), before the one the last shares its prefix with.
    Returns (all but the last, last)."""
    gen = torch.Generator(device="cpu").manual_seed(seed)

    def prompt(n):
        return torch.randint(0, vocab_size, (n,), generator=gen).tolist()

    def req(p, i):
        samp = {"temperature": 0.0}
        if i in (2, 5):
            samp = {"temperature": 0.8, "top_p": 0.9, "seed": 1000 + i}
        return {"token_ids": p, "sampling": samp,
                "stop": {"max_tokens": N_OUT, "stop_ids": []}}

    shared = prompt(256)
    prompts = [prompt(n) for n in (17, 64, 300, 700, 1100, 1500)]
    prompts.append(shared + prompt(150))
    late = shared + prompt(400)
    prompts[-1:-1] = [prompt(n) for n in extra]
    return [req(p, i) for i, p in enumerate(prompts)], req(late, len(prompts))


def spec_workload(vocab_size: int, seed: int):
    """workload()'s shape (8 requests, the last sharing a 256-token prefix
    with the one before it), all greedy, with prompts that repeat n-grams:
    each is a 12 to 40-token motif repeated, so n-gram drafts find
    matches. Returns (first 7, last)."""
    gen = torch.Generator(device="cpu").manual_seed(seed)

    def prompt(n, motif):
        m = torch.randint(0, vocab_size, (motif,), generator=gen).tolist()
        return (m * (n // motif + 1))[:n]

    def req(p):
        return {"token_ids": p, "sampling": {"temperature": 0.0},
                "stop": {"max_tokens": N_OUT, "stop_ids": []}}

    shared = prompt(256, 32)
    prompts = [prompt(n, m) for n, m in ((17, 12), (64, 16), (300, 20),
                                          (700, 24), (1100, 28), (1500, 40))]
    prompts.append(shared + prompt(150, 30))
    late = shared + prompt(400, 36)
    return [req(p) for p in prompts], req(late)


def serve(engine, seed: int, spec: bool = False, extra=()):
    """Serve workload(seed, extra) (spec_workload with spec) to
    completion, at most 900 s."""
    V = engine.runner.config.vocab_size
    reqs, late = spec_workload(V, seed) if spec else workload(V, seed, extra)
    prompts = [r["token_ids"] for r in reqs + [late]]
    return prompts, asyncio.run(asyncio.wait_for(
        _serve(engine, reqs, len(reqs) - 1, late), 900))


def check_launches(phase: str, launches, stats, L: int, mla: bool = False,
                   int8: bool = False, moe_layers: int = 0,
                   copies: bool = False) -> None:
    """Each kernel launched once per layer of each forward pass of its
    kind, and nowhere else (an MLA model launches no GQA kernel and the
    other way round; an int8 latent's prefill gathers, as the reference's
    does, and launches no MLA prefill kernel); each grouped-GEMM entry
    once per MoE layer (runner.moe_layers) of every pass, and never for a
    dense model."""
    prefill = stats["prefill_chunks"] + stats["padded_prefill_dispatches"]
    ragged = stats["ragged_mixed_dispatches"] + stats["ragged_verify_dispatches"]
    if mla:
        want = {"prefill_mla_attention": 0 if int8 else prefill,
                "decode_mla_attention": stats["decode_steps"]}
        want.update({name: 0 for name in GQA_KERNELS})
        check(ragged == 0, f"{phase}: an MLA model ran ragged passes: {stats}")
    else:
        want = {"prefill_paged_attention": prefill,
                "decode_paged_attention": stats["decode_steps"],
                "ragged_paged_attention": ragged}
        want.update({name: 0 for name in MLA_KERNELS})
    for name, n in want.items():
        check(launches[name] == n * L,
              f"{phase}: {name} launches {launches[name]} != {n} passes x {L}")
    passes = prefill + stats["decode_steps"] + ragged
    for name in MOE_KERNELS:
        check(launches[name] == passes * moe_layers,
              f"{phase}: {name} launches {launches[name]} != {passes} passes x "
              f"{moe_layers} MoE layers")
    for name in COPY_KERNELS if not copies else ():  # no transfer, no host tier
        check(launches[name] == 0, f"{phase}: {name} launched {launches[name]}")


def reset_launches():
    for fn in KERNELS.values():
        fn.launches = 0
    for name in GQA_KERNELS + ("decode_mla_attention",):
        KERNELS[name].bodies = {}


def engine_phase(runner, phase: str, fused: bool = None, spec: bool = False,
                 build_s: float = None, base_args=ENGINE_ARGS, extra=()):
    """Serve the workload on a fresh engine over `runner`, with every
    launch count and runner.stats set to 0 just before and read just
    after. fused=None keeps the engine's default (fused on a card);
    `extra` adds prompts to the workload."""
    args = base_args + (["--spec-ngram", "--spec-k", "4"] if spec else [])
    saved = os.environ.pop("DYN_FUSED_MIXED", None)
    if fused is not None:
        os.environ["DYN_FUSED_MIXED"] = "1" if fused else "0"
    try:
        engine = build_engine(parse_args(args), runner=runner)
    finally:
        os.environ.pop("DYN_FUSED_MIXED", None)
        if saved is not None:
            os.environ["DYN_FUSED_MIXED"] = saved
    V = runner.config.vocab_size
    L = runner.config.n_layers
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    runner.reset_stats()
    t0 = time.monotonic()
    try:
        prompts, results = serve(engine, seed=1, spec=spec, extra=extra)
    finally:
        engine.stop()
    torch.cuda.synchronize()  # a fault during the run surfaces here
    wall = time.monotonic() - t0
    launches = {name: fn.launches for name, fn in KERNELS.items()}
    bodies = {name: dict(KERNELS[name].bodies)
              for name in GQA_KERNELS + ("decode_mla_attention",)}
    stats = dict(runner.stats)
    for i, (toks, finish, _) in enumerate(results):
        check(finish in ("length", "stop"), f"{phase}: r{i} finished {finish!r}")
        check(finish != "length" or len(toks) == N_OUT,
              f"{phase}: r{i} emitted {len(toks)} tokens, wanted {N_OUT}")
        check(all(0 <= t < V for t in toks),
              f"{phase}: r{i} emitted a token out of range")
    check(stats["prefill_chunks"] > 0 and stats["decode_steps"] > 0,
          f"{phase}: engine ran no prefill or no decode: {stats}")
    check_launches(phase, launches, stats, L, mla=runner.config.is_mla,
                   int8=runner.kv_quantize is not None,
                   moe_layers=runner.moe_layers)
    reused = engine.scheduler.reused_prefix_tokens
    check(reused >= 256, f"{phase}: late request reused only {reused} prefix tokens")
    ttft = sorted(r[2].get("ttft_s", float("nan")) for r in results)
    decode_rates = sorted(
        (len(r[0]) - 1) / (r[2]["e2e_s"] - r[2]["ttft_s"]) for r in results)
    n_tokens = sum(len(r[0]) for r in results)
    rec = {
        "phase": f"engine_{phase}", "model": runner.config.name,
        "n_layers": L, "fused_mixed": engine.fused_mixed,
        "requests": len(results),
        "prompt_tokens": [len(p) for p in prompts],
        "output_tokens": [len(r[0]) for r in results],
        "finish": [r[1] for r in results],
        "stats": stats, "launches": launches, "bodies": bodies,
        "reused_prefix_tokens": reused,
        "ttft_s_min": ttft[0], "ttft_s_median": ttft[len(ttft) // 2],
        "ttft_s_max": ttft[-1],
        "decode_tok_s_per_request_median": decode_rates[len(decode_rates) // 2],
        "output_tok_s_overall": n_tokens / wall, "wall_s": wall,
        "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
        "kv_quantize": runner.kv_quantize,
    }
    if build_s is not None:
        rec["build_s"] = build_s
    if spec:
        rec["spec_stats"] = dict(engine.spec_stats)
        rec["acceptance_rate"] = (engine.spec_stats["accepted"]
                                  / max(1, engine.spec_stats["drafted"]))
    return rec, launches, results


def served_turn(runner, phase, fused, args, expect, extra=(), build_s=None):
    """engine_phase with the checks every model's turn holds: fused plans
    on the ragged kernel (fused=None, the card's default) or no ragged
    launch (fused=False); every request `length` with N_OUT tokens; each
    GQA kernel's launches by body equal to expect(n) for its n launches.
    Returns (rec, launches)."""
    rec, launches, results = engine_phase(runner, phase, fused=fused, build_s=build_s,
                                          base_args=args, extra=extra)
    st = rec["stats"]
    if fused is None:
        check(rec["fused_mixed"], f"{phase}: the engine did not fuse on the card")
        check(all(launches[k] > 0 for k in GQA_KERNELS),
              f"{phase}: a GQA kernel never launched: {launches}")
        check(st["ragged_mixed_dispatches"] > 0 and st["padded_prefill_dispatches"] == 0,
              f"{phase}: mixed plans did not ride the ragged step: {st}")
    else:
        check(not rec["fused_mixed"], f"{phase}: DYN_FUSED_MIXED=0 did not hold")
        check(launches["ragged_paged_attention"] == 0, f"{phase}: the ragged kernel ran")
    for i, (toks, finish, _) in enumerate(results):
        check(finish == "length" and len(toks) == N_OUT,
              f"{phase}: r{i} finished {finish!r} with {len(toks)} tokens")
    for name in GQA_KERNELS:
        b, n = rec["bodies"][name], launches[name]
        check(b == expect(n), f"{phase}: {name} bodies {b} for {n} launches")
    return rec, launches


def one_body(body):
    """served_turn's `expect` for a model whose every launch is on `body`."""
    return lambda n: {body: n} if n else {}


def engine_phases(dev):
    """The fused (main path), unfused and spec phases on one runner."""
    t0 = time.monotonic()
    runner, _ = build_runner(parse_args(ENGINE_ARGS))
    torch.cuda.synchronize()
    build_s = time.monotonic() - t0

    rec, launches, fused = engine_phase(runner, "fused", build_s=build_s)
    fused_bodies = rec["bodies"]
    fused_rec = rec
    st = rec["stats"]
    check(rec["fused_mixed"], "fused: the engine did not fuse on the card")
    check(all(launches[k] > 0 for k in GQA_KERNELS),
          f"fused: a kernel of the main path never launched: {launches}")
    # more chunks than fused dispatches: some plan packed two or more
    check(st["mixed_chunks"] > st["ragged_mixed_dispatches"] > 0,
          f"fused: no fused plan packed 2+ chunks: {st}")
    check(st["padded_prefill_dispatches"] == 0,
          f"fused: the padded fallback ran {st['padded_prefill_dispatches']} times")
    emit(rec)

    rec, _, unfused = engine_phase(runner, "unfused", fused=False)
    check(not rec["fused_mixed"], "unfused: DYN_FUSED_MIXED=0 did not hold")
    check(rec["launches"]["ragged_paged_attention"] == 0,
          "unfused: the ragged kernel ran")
    # information only: bf16 through other kernels may part on near-ties
    greedy = [i for i in range(len(fused)) if i not in (2, 5)]
    same = [fused[i][0] == unfused[i][0] for i in greedy]
    pos = [a == b for i in greedy for a, b in zip(fused[i][0], unfused[i][0])]
    rec["greedy_agreement_with_fused"] = {
        "streams_identical": sum(same), "streams": len(same),
        "token_agreement": sum(pos) / max(1, len(pos))}
    emit(rec)

    rec, _, _ = engine_phase(runner, "spec", spec=True)
    st = rec["stats"]
    check(rec["spec_stats"]["drafted"] > 0 and st["ragged_verify_dispatches"] > 0,
          f"spec: nothing was drafted or verified: {rec['spec_stats']}, {st}")
    emit(rec)
    return runner, launches, fused_bodies, fused_rec


DISAGG_ARGS = ["--model", "llama-3.2-3b", "--num-pages", "1024",
               "--page-size", "16", "--max-seq-len", "4096", "--max-batch", "8",
               "--chunk-size", "512"]
DISAGG_CHUNK_PAGES = 16
PAGE_SIZE = 16


def _reset(*runners):
    reset_launches()
    for r in runners:
        r.reset_stats()


async def _collect_timed(engine, req, rid, on_first=None):
    """One request through `engine` (the router, or an engine), timed on
    the client's clock: TTFT at the first item with tokens."""
    t0 = time.monotonic()
    toks, finish, phases, t_first = [], None, {}, None
    async for item in engine.generate(req, Context(request_id=rid)):
        if item["token_ids"] and t_first is None:
            t_first = time.monotonic()
            if on_first is not None:
                on_first.set()
        toks.extend(item["token_ids"])
        if item.get("finish_reason"):
            finish = item["finish_reason"]
            phases = item.get("phases") or {}
    t_end = time.monotonic()
    check(finish != "error", f"request {rid} finished with error")
    return {"tokens": toks, "finish": finish, "phases": phases,
            "ttft_s": (t_first or t_end) - t0, "e2e_s": t_end - t0,
            "t_first": t_first, "t_end": t_end}


def _spy_calls(runner, names):
    """Record the page count of every call of runner.<name>."""
    calls = {n: [] for n in names}
    for n in names:
        orig = getattr(runner, n)

        def spy(pages, *a, _orig=orig, _n=n, **kw):
            calls[_n].append(len(pages))
            return _orig(pages, *a, **kw)

        setattr(runner, n, spy)
    return calls


def _check_finished(phase, results, V):
    for i, r in enumerate(results):
        check(r["finish"] == "length" and len(r["tokens"]) == N_OUT,
              f"{phase}: r{i} finished {r['finish']!r} with {len(r['tokens'])} tokens")
        check(all(0 <= t < V for t in r["tokens"]), f"{phase}: r{i} token out of range")


def _runtime(realm: str, plane: str, events: str = "inproc"):
    """A runtime of chip_smoke's process on in-process discovery."""
    return DistributedRuntime(discovery=MemDiscovery(realm=realm),
                              event_transport=events, request_plane=plane)


async def _disagg_fleet(prefill, decode, p_args, d_args, plane, host_only):
    """Serve the prefill and the decode engine with serve_worker, each on
    its own runtime over `plane`, and put a PrefillRouter over them on a
    third: its prefill pool and its downstream decode client come from
    discovery. Unless `host_only`, the prefill engine is served twice, as
    a colocated instance (pulled on the device) and as one pulled
    host-staged through kv_fetch; the router alternates between them.
    Returns (router, prefill instances, decode worker, close)."""
    realm = f"{plane}-{host_only}"
    rts = [_runtime(realm, plane, "tcp") for _ in range(3)]
    p_ws = [await serve_args(rts[0], prefill, p_args, colocated=not host_only)]
    if not host_only:
        rts.append(_runtime(realm, plane))
        p_ws.append(await serve_args(rts[-1], prefill, p_args, colocated=False,
                                     publish_kv_events=False, publish_fpm=False))
    d_w = await serve_args(rts[1], decode, d_args, colocated=not host_only)
    front = rts[2]
    downstream = front.client(f"dyn/{d_args.component}/generate")
    pool = front.client(f"dyn/{p_args.component}/generate")
    await downstream.wait_ready(timeout=60)
    await pool.wait_ready(timeout=60)
    while len(pool.instances) < len(p_ws):
        await asyncio.sleep(0.01)
    router = PrefillRouter(downstream, DisaggPolicy(min_prefill_tokens=16))
    router.activate(pool, f"dyn/{p_args.component}/kv_fetch")

    async def close():
        await downstream.close()
        await pool.close()
        for rt in rts:
            await rt.shutdown(drain_timeout=10)
        for w in [d_w] + p_ws:
            await w.stop()

    return router, p_ws, d_w, close


async def _serve_disagg(router, reqs, late):
    """reqs concurrently through the router, then `late` once r6 (whose
    256-token prefix it shares) has its first token."""
    shared = asyncio.Event()
    tasks = [asyncio.create_task(_collect_timed(
        router, r, f"r{i}", shared if i == len(reqs) - 1 else None))
        for i, r in enumerate(reqs)]
    await shared.wait()
    tasks.append(asyncio.create_task(_collect_timed(router, late, f"r{len(reqs)}")))
    return await asyncio.gather(*tasks)


def _disagg_engines(params, chunk_pages=DISAGG_CHUNK_PAGES):
    p_args = parse_args(DISAGG_ARGS + ["--disagg-role", "prefill", "--component", "prefill"])
    d_args = parse_args(DISAGG_ARGS + ["--disagg-role", "decode", "--component", "decode",
                                       "--disagg-chunk-pages", str(chunk_pages)])
    prefill = build_engine(p_args, runner=build_runner(p_args, params=params)[0])
    decode = build_engine(d_args, runner=build_runner(d_args, params=params)[0])
    return prefill, decode, p_args, d_args


def _transfer(n_pages, results, page_bytes):
    """The pulls' wall on the decode side (the fetch, queueing on the
    prefill engine's step thread included, then the import on the decode
    engine's step thread), from the final items' phases."""
    rows = [(n, r["phases"]["kv_fetch_s"], r["phases"]["kv_import_s"])
            for n, r in zip(n_pages, results)]
    pages = sum(n for n, _, _ in rows)
    secs = sum(f + i for _, f, i in rows)
    return {
        "requests": len(rows), "pages": pages, "bytes": pages * page_bytes,
        "ms_per_request": [(f + i) * 1e3 for _, f, i in rows],
        "fetch_ms": [f * 1e3 for _, f, _ in rows],
        "import_ms": [i * 1e3 for _, _, i in rows],
        "prompt_pages": [n for n, _, _ in rows],
        "gb_per_s": pages * page_bytes / secs / 1e9,
    }


def disagg_phase(params):
    """The PrefillRouter → prefill worker (park) → KV pull (device for the
    colocated instance, host-staged chunks of 16 pages through kv_fetch for
    the other) → decode worker (admit with KV, decode), every hop over the
    in-process request plane."""
    prefill, decode, p_args, d_args = _disagg_engines(params)
    paths = {}
    imports = _spy_calls(decode.runner, ("import_pages_device", "import_pages"))
    V, L = prefill.runner.config.vocab_size, prefill.runner.config.n_layers
    reqs, late = workload(V, seed=1)
    prompts = [r["token_ids"] for r in reqs + [late]]

    async def serve():
        router, p_ws, d_w, close = await _disagg_fleet(
            prefill, decode, p_args, d_args, "inproc", host_only=False)
        fetch = d_w.handler._fetch
        iid_dev = p_ws[0].instance.instance_id

        async def fetch_by_path(src):
            paths[src["request_id"]] = "device" if src["instance_id"] == iid_dev else "host"
            return await fetch(src)

        d_w.handler._fetch = fetch_by_path
        torch.cuda.synchronize()
        _reset(prefill.runner, decode.runner)
        t0 = time.monotonic()
        try:
            return await _serve_disagg(router, reqs, late), t0, d_w
        finally:
            await close()

    results, t0, d_w = asyncio.run(asyncio.wait_for(serve(), 300))
    check(d_w.handler.fallbacks == 0,
          f"disagg: {d_w.handler.fallbacks} pulls fell back to recompute")
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {name: fn.launches for name, fn in KERNELS.items()}
    pst, dst = dict(prefill.runner.stats), dict(decode.runner.stats)
    _check_finished("disagg", results, V)
    path_of = [paths.get(f"r{i}:prefill") for i in range(len(prompts))]
    check(sorted(path_of) == ["device"] * 4 + ["host"] * 4,
          f"disagg: transfer paths {path_of}")
    # the decode engine admitted every prompt with its KV: no prefill
    check(dst["prefill_chunks"] == dst["mixed_chunks"] == 0
          and dst["padded_prefill_dispatches"] == 0,
          f"disagg: the decode engine prefilled: {dst}")
    check(pst["decode_steps"] == 0, f"disagg: the prefill engine decoded: {pst}")
    n_pages = [-(-len(p) // PAGE_SIZE) for p in prompts]
    check(pst["kv_pages_exported"] == sum(n_pages),
          f"disagg: exported {pst['kv_pages_exported']} pages, want {sum(n_pages)}")
    # one gather per pool per export: a device pull gathers once, a host
    # pull once per chunk of 16 pages
    exports = sum(1 if path == "device" else -(-n // DISAGG_CHUNK_PAGES)
                  for path, n in zip(path_of, n_pages))
    check(launches["gather_pages"] == 2 * exports,
          f"disagg: gather launches {launches['gather_pages']} != {exports} x 2")
    n_imports = len(imports["import_pages_device"]) + len(imports["import_pages"])
    check(len(imports["import_pages_device"]) == 4,
          f"disagg: device imports {imports['import_pages_device']}")
    check(launches["scatter_pages"] == 2 * n_imports,
          f"disagg: scatter launches {launches['scatter_pages']} != {n_imports} x 2")
    shared_pages = decode.scheduler.reused_prefix_tokens // PAGE_SIZE
    imported = sum(imports["import_pages_device"]) + sum(imports["import_pages"])
    check(dst["kv_pages_imported"] == imported == sum(n_pages) - shared_pages,
          f"disagg: imported {dst['kv_pages_imported']} pages, want "
          f"{sum(n_pages)} - {shared_pages} shared")
    check(launches["scatter_pages_layers"] == 0, "disagg: layer scatter ran")
    check(not prefill._parked and not prefill.pool.ref,
          "disagg: parked pages were not all released")
    # bytes: the decode engine's imported pages equal the prefill engine's,
    # read with plain indexing, for the longest request of each path
    compared = {}
    for path in ("device", "host"):
        i = max((j for j, p in enumerate(path_of) if p == path),
                key=lambda j: len(prompts[j]))
        hashes = block_hashes(prompts[i], PAGE_SIZE)
        p_pages = [prefill.pool.by_hash[h] for h in hashes]
        d_pages = [decode.pool.by_hash[h] for h in hashes]
        for pp, dp in ((prefill.runner.k_pool, decode.runner.k_pool),
                       (prefill.runner.v_pool, decode.runner.v_pool)):
            check(torch.equal(pp[:, p_pages], dp[:, d_pages]),
                  f"disagg: r{i}'s imported pages differ from the prefill engine's")
        compared[f"r{i}"] = {"path": path, "pages": len(hashes)}
    page_bytes = L * PAGE_SIZE * prefill.runner.config.n_kv_heads \
        * prefill.runner.config.head_dim * 2 * 2  # both pools, bf16
    # the pull's wall on the decode side (queueing on the prefill
    # engine's step thread included), then the import on the decode
    # engine's step thread
    transfer = {}
    for path in ("device", "host"):
        picked = [j for j, p in enumerate(path_of) if p == path]
        transfer[path] = _transfer([n_pages[j] for j in picked],
                                   [results[j] for j in picked], page_bytes)
    ttft = sorted(r["ttft_s"] for r in results)
    rates = sorted((len(r["tokens"]) - 1) / (r["t_end"] - r["t_first"]) for r in results)
    rec = {
        "phase": "engine_disagg", "model": prefill.runner.config.name,
        "n_layers": L, "requests": len(results),
        "prompt_tokens": [len(p) for p in prompts], "paths": path_of,
        "output_tokens": [len(r["tokens"]) for r in results],
        "prefill_stats": pst, "decode_stats": dst, "launches": launches,
        "export_calls": exports, "import_calls": n_imports,
        "decode_reused_prefix_tokens": decode.scheduler.reused_prefix_tokens,
        "bytes_equal": compared, "transfer": transfer,
        "ttft_s_min": ttft[0], "ttft_s_median": ttft[len(ttft) // 2],
        "ttft_s_max": ttft[-1],
        "decode_tok_s_per_request_median": rates[len(rates) // 2],
        "output_tok_s_overall": sum(len(r["tokens"]) for r in results) / wall,
        "wall_s": wall,
    }
    emit(rec)
    for name in ("gather_pages", "scatter_pages"):
        check(launches[name] > 0, f"disagg: {name} never launched")
    return launches, rec


ROOT = Path(__file__).resolve().parent
SERVE_TIMEOUT_S = 300  # the worker's start (weights drawn on the card) and drain


async def _one_then_all(engine, reqs):
    """`reqs` one at a time, then all at once, through `engine` (an
    engine or a client): (one-at-a-time results, all-at-once results,
    the all-at-once wall)."""
    alone = [await _collect_timed(engine, r, f"r{i}") for i, r in enumerate(reqs)]
    t0 = time.monotonic()
    together = await asyncio.gather(*[_collect_timed(engine, r, f"c{i}")
                                      for i, r in enumerate(reqs)])
    return alone, together, time.monotonic() - t0


def alone_phase(runner):
    """workload(seed 1)'s 8 requests served by a fresh engine over
    `runner` in this process, one at a time, then all at once (the second
    pass hits the first's prefix cache, as the served worker's does): the
    streams engine_served holds the served worker's against, and the
    in-process TTFT and e2e beside the wire's."""
    engine = build_engine(parse_args(ENGINE_ARGS), runner=runner)
    reqs, late = workload(runner.config.vocab_size, seed=1)
    try:
        return asyncio.run(asyncio.wait_for(_one_then_all(engine, reqs + [late]), 300))
    finally:
        engine.stop()


def _latency(results):
    ttft = sorted(r["ttft_s"] for r in results)
    e2e = sorted(r["e2e_s"] for r in results)
    return {"ttft_s": [r["ttft_s"] for r in results], "e2e_s": [r["e2e_s"] for r in results],
            "ttft_s_median": ttft[len(ttft) // 2], "e2e_s_median": e2e[len(e2e) // 2]}


async def _read_serving_line(proc, log_path):
    while True:
        line = (await proc.stdout.readline()).decode()
        if not line:
            tail = Path(log_path).read_text()[-3000:]
            raise CheckFailed(f"served: the worker exited ({await proc.wait()}) "
                              f"before serving:\n{tail}")
        if line.startswith("worker serving"):
            return line.strip()


def served_phase(in_process, fused_rec, V):
    """`python -m dynamo_tpu_torch.worker` serving llama-3.2-3b as a
    process on the card (the engine_fused flags, file discovery on a
    temporary root), and a client runtime in this process that discovers
    it. The worker first serves workload(seed 2) one request at a time
    (its first run of each shape, which this process's runner is past),
    then workload(seed 1) as alone_phase does: one at a time, each greedy
    stream equal to the in-process engine's, then all 8 at once, each
    finishing with its N_OUT tokens. Then SIGTERM, after which the worker
    must exit 0."""
    alone, together_in, together_in_wall = in_process
    reqs, late = workload(V, seed=1)
    reqs = reqs + [late]
    warm, warm_late = workload(V, seed=2)
    greedy = [i for i in range(len(reqs)) if i not in (2, 5)]

    async def run(root):
        log_path = os.path.join(root, "worker.log")
        with open(log_path, "w") as log_file:
            t0 = time.monotonic()
            proc = await asyncio.create_subprocess_exec(
                sys.executable, "-m", "dynamo_tpu_torch.worker", *ENGINE_ARGS,
                "--discovery-backend", "file", "--discovery-root", root,
                cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)),
                stdout=asyncio.subprocess.PIPE, stderr=log_file)
        rt = DistributedRuntime(discovery=FileDiscovery(root, poll_interval=0.05))
        try:
            line = await asyncio.wait_for(_read_serving_line(proc, log_path), SERVE_TIMEOUT_S)
            start_s = time.monotonic() - t0
            client = rt.client("dyn/tpu-worker/generate")
            await client.wait_ready(timeout=60)  # raises when nothing registered
            instances = len(client.instances)
            first = [await _collect_timed(client, r, f"w{i}")
                     for i, r in enumerate(warm + [warm_late])]
            alone_wire, together, together_wall = await _one_then_all(client, reqs)
            await client.close()
            t2 = time.monotonic()
            proc.send_signal(signal.SIGTERM)
            rc = await asyncio.wait_for(proc.wait(), SERVE_TIMEOUT_S)
            exit_s = time.monotonic() - t2
        finally:
            if proc.returncode is None:
                proc.kill()
                await proc.wait()
            await rt.shutdown(drain_timeout=1)
        return (line, start_s, instances, first, alone_wire, together, together_wall,
                rc, exit_s)

    with tempfile.TemporaryDirectory() as root:
        (line, start_s, instances, first, alone_wire, together, together_wall, rc,
         exit_s) = asyncio.run(run(root))
    check(instances == 1, f"served: {instances} instances registered")
    check(rc == 0, f"served: the worker exited {rc} after SIGTERM")
    _check_finished("served_first", first, V)
    _check_finished("served_alone", alone_wire, V)
    _check_finished("served_together", together, V)
    same = [alone_wire[i]["tokens"] == alone[i]["tokens"] for i in range(len(reqs))]
    check(all(same[i] for i in greedy),
          f"served: greedy streams differ from the in-process engine's: {same}")
    rec = {
        "phase": "engine_served", "model": ENGINE_ARGS[1], "worker": line,
        "worker_start_s": start_s, "worker_exit_code": rc, "worker_exit_s": exit_s,
        "requests": len(reqs), "prompt_tokens": [len(r["token_ids"]) for r in reqs],
        "greedy_streams_equal": sum(same[i] for i in greedy), "greedy_streams": len(greedy),
        "sampled_streams_equal": [same[i] for i in range(len(reqs)) if i not in greedy],
        "first_shapes_wire": _latency(first),
        "one_at_a_time": {"wire": _latency(alone_wire), "in_process": _latency(alone)},
        "all_at_once": {
            "wire": {**_latency(together), "wall_s": together_wall,
                     "output_tok_s_overall": sum(len(r["tokens"]) for r in together)
                     / together_wall},
            "in_process": {**_latency(together_in), "wall_s": together_in_wall,
                           "output_tok_s_overall": sum(len(r["tokens"]) for r in together_in)
                           / together_in_wall}},
        "in_process_engine_fused": {
            k: fused_rec[k] for k in ("ttft_s_min", "ttft_s_median", "ttft_s_max",
                                      "decode_tok_s_per_request_median",
                                      "output_tok_s_overall", "wall_s")},
    }
    emit(rec)
    return rec


def served_disagg_phase(params, disagg_rec):
    """A prefill and a decode worker served by serve_worker over the TCP
    request plane on loopback, in this process (so the launch counts can
    be read), neither registered colocated: every pull goes host-staged
    through the prefill worker's kv_fetch in chunks of 16 pages. The
    router's prefill pool and decode client come from discovery, and a
    subscriber on the prefill worker's event publisher collects its KV
    events."""
    prefill, decode, p_args, d_args = _disagg_engines(params)
    imports = _spy_calls(decode.runner, ("import_pages_device", "import_pages"))
    V, L = prefill.runner.config.vocab_size, prefill.runner.config.n_layers
    reqs, late = workload(V, seed=1)
    prompts = [r["token_ids"] for r in reqs + [late]]
    stored = set()

    async def serve():
        router, p_ws, d_w, close = await _disagg_fleet(
            prefill, decode, p_args, d_args, "tcp", host_only=True)
        addresses = {"prefill": p_ws[0].instance.address, "decode": d_w.instance.address}
        sub = p_ws[0].runtime.event_subscriber([KV_EVENT_SUBJECT])
        sub.connect(p_ws[0].instance.metadata["kv_publisher"])
        pub = p_ws[0].runtime.event_publisher()
        while not pub._subs:
            await asyncio.sleep(0.01)

        async def listen():
            async for _, payload in sub.events():
                stored.update(h for e in payload["events"] if e["kind"] == "store"
                              and e["tier"] == "device" for h in e["block_hashes"])

        listener = asyncio.create_task(listen())
        torch.cuda.synchronize()
        _reset(prefill.runner, decode.runner)
        t0 = time.monotonic()
        try:
            results = await _serve_disagg(router, reqs, late)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            launches = {name: fn.launches for name, fn in KERNELS.items()}
            want = set(h for p in prompts for h in block_hashes(p, PAGE_SIZE))
            while not want <= stored:  # bounded by the caller's wait_for
                await asyncio.sleep(0.01)
            return results, wall, launches, d_w, addresses
        finally:
            listener.cancel()
            await sub.close()
            await close()

    results, wall, launches, d_w, addresses = asyncio.run(asyncio.wait_for(serve(), 300))
    pst, dst = dict(prefill.runner.stats), dict(decode.runner.stats)
    _check_finished("served_disagg", results, V)
    check(d_w.handler.fallbacks == 0,
          f"served_disagg: {d_w.handler.fallbacks} pulls fell back to recompute")
    check(not imports["import_pages_device"],
          f"served_disagg: a pull took the device path: {imports['import_pages_device']}")
    check(dst["prefill_chunks"] == dst["mixed_chunks"] == 0
          and dst["padded_prefill_dispatches"] == 0,
          f"served_disagg: the decode worker prefilled: {dst}")
    n_pages = [-(-len(p) // PAGE_SIZE) for p in prompts]
    chunks = sum(-(-n // DISAGG_CHUNK_PAGES) for n in n_pages)
    check(pst["kv_pages_exported"] == sum(n_pages),
          f"served_disagg: exported {pst['kv_pages_exported']} pages, want {sum(n_pages)}")
    check(launches["gather_pages"] == 2 * chunks,
          f"served_disagg: gather launches {launches['gather_pages']} != {chunks} x 2")
    n_imports = len(imports["import_pages"])
    check(launches["scatter_pages"] == 2 * n_imports,
          f"served_disagg: scatter launches {launches['scatter_pages']} != {n_imports} x 2")
    check(launches["scatter_pages_layers"] == 0, "served_disagg: layer scatter ran")
    both = {k: pst[k] + dst[k] for k in pst}
    check_launches("served_disagg", launches, both, L, copies=True)
    check(not prefill._parked and not prefill.pool.ref,
          "served_disagg: parked pages were not all released")
    page_bytes = L * PAGE_SIZE * prefill.runner.config.n_kv_heads \
        * prefill.runner.config.head_dim * 2 * 2  # both pools, bf16
    ttft = sorted(r["ttft_s"] for r in results)
    rec = {
        "phase": "engine_served_disagg", "model": prefill.runner.config.name,
        "n_layers": L, "requests": len(results), "addresses": addresses,
        "prompt_tokens": [len(p) for p in prompts],
        "output_tokens": [len(r["tokens"]) for r in results],
        "prefill_stats": pst, "decode_stats": dst, "launches": launches,
        "chunks_pulled": chunks, "import_calls": n_imports,
        "fallbacks": d_w.handler.fallbacks, "stored_blocks": len(stored),
        "transfer_tcp": _transfer(n_pages, results, page_bytes),
        "transfer_in_process_host": disagg_rec["transfer"]["host"],
        "ttft_s_min": ttft[0], "ttft_s_median": ttft[len(ttft) // 2],
        "ttft_s_max": ttft[-1], "wall_s": wall,
        "output_tok_s_overall": sum(len(r["tokens"]) for r in results) / wall,
    }
    emit(rec)
    return rec


TIER_ARGS = ["--model", "llama-3.2-3b", "--num-pages", "160", "--page-size", "16",
             "--max-seq-len", "4096", "--max-batch", "8", "--chunk-size", "512"]
TIER_HOST = ["--host-kv-blocks", "512", "--onboard-layer-groups", "4"]


def tiers_phase(params):
    """G2 host tier: a 1100-token request A, two 1500-token fillers that
    evict A's pages from the 160-page pool to the host, then A2 = A's
    first 1024 tokens + 100 new ones, onboarded from the host in 4 layer
    groups. A cold engine over the same runner serves A2 first: the
    tiered stream must equal it."""
    runner, _ = build_runner(parse_args(TIER_ARGS), params=params)
    cold = build_engine(parse_args(TIER_ARGS), runner=runner)
    tiered = build_engine(parse_args(TIER_ARGS + TIER_HOST), runner=runner)
    V, L = runner.config.vocab_size, runner.config.n_layers
    gen = torch.Generator(device="cpu").manual_seed(5)

    def prompt(n):
        return torch.randint(0, V, (n,), generator=gen).tolist()

    def req(p):
        return {"token_ids": p, "sampling": {"temperature": 0.0},
                "stop": {"max_tokens": N_OUT, "stop_ids": []}}

    a = prompt(1100)
    fillers = [prompt(1500), prompt(1500)]
    a2 = a[:1024] + prompt(100)
    shared = block_hashes(a2, PAGE_SIZE)[:1024 // PAGE_SIZE]

    async def serve(engine, prompts, tag):
        return [await _collect_timed(engine, req(p), f"{tag}{i}")
                for i, p in enumerate(prompts)]

    torch.cuda.synchronize()
    _reset(runner)
    t0 = time.monotonic()
    try:
        cold_out = asyncio.run(asyncio.wait_for(serve(cold, [a2], "cold"), 300))
        cold.stop()
        warm = asyncio.run(asyncio.wait_for(serve(tiered, [a] + fillers, "t"), 300))
        on_host = tiered.host_pool.match(shared)
        before = tiered.scheduler.reused_prefix_tokens
        hit = asyncio.run(asyncio.wait_for(serve(tiered, [a2], "hit"), 300))
        reused = tiered.scheduler.reused_prefix_tokens - before
    finally:
        cold.stop()
        tiered.stop()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {name: fn.launches for name, fn in KERNELS.items()}
    st = dict(runner.stats)
    host = dict(tiered.host_pool.stats)
    onboard = dict(tiered.onboard_stats)
    results = cold_out + warm + hit
    _check_finished("tiers", results, V)
    check(on_host == len(shared), f"tiers: only {on_host} of A's {len(shared)} "
          "shared pages reached the host tier")
    check(reused >= 1024 and onboard["blocks"] == len(shared),
          f"tiers: A2 reused {reused} tokens, {onboard['blocks']} from the host")
    check(hit[0]["tokens"] == cold_out[0]["tokens"],
          "tiers: the onboarded stream differs from the cold prefill's")
    groups = tiered.onboard_layer_groups
    check(launches["scatter_pages_layers"] == onboard["onboards"] * groups * 2
          == st["kv_layer_group_scatters"] * 2 and onboard["onboards"] > 0,
          f"tiers: layer scatters {launches['scatter_pages_layers']} != "
          f"{onboard['onboards']} onboards x {groups} groups x 2 pools")
    # every offload exports one page: one gather per pool
    check(launches["gather_pages"] == 2 * host["offloaded"] == 2 * st["kv_pages_exported"],
          f"tiers: gathers {launches['gather_pages']} for {host['offloaded']} offloads")
    check(launches["scatter_pages"] == 0, "tiers: whole-pool scatter ran")
    # the onboarded device pages hold exactly the bytes that were offloaded
    pages = [tiered.pool.by_hash[h] for h in shared]
    hk, hv = tiered.host_pool.get(shared)
    check(torch.equal(runner.k_pool[:, pages].cpu(), hk)
          and torch.equal(runner.v_pool[:, pages].cpu(), hv),
          "tiers: onboarded pages differ from the offloaded bytes")
    onboard_bytes = onboard["blocks"] * 2 * L * PAGE_SIZE * runner.config.n_kv_heads \
        * runner.config.head_dim * 2
    rec = {
        "phase": "engine_tiers", "model": runner.config.name, "n_layers": L,
        "num_pages": runner.num_pages, "host_kv_blocks": tiered.host_pool.capacity,
        "onboard_layer_groups": groups,
        "prompt_tokens": {"A": len(a), "fillers": [len(f) for f in fillers],
                          "A2": len(a2), "A2_shared_with_A": 1024},
        "stats": st, "launches": launches, "host_pool": host,
        "onboard": onboard, "reused_prefix_tokens_A2": reused,
        "kv_onboard_s": hit[0]["phases"].get("kv_onboard_s"),
        "onboard_bytes": onboard_bytes,
        "onboard_gb_per_s": onboard_bytes / onboard["seconds"] / 1e9,
        "ttft_s_A2_onboarded": hit[0]["ttft_s"], "ttft_s_A2_cold": cold_out[0]["ttft_s"],
        "wall_s": wall,
    }
    emit(rec)
    check(launches["gather_pages"] > 0 and launches["scatter_pages_layers"] > 0,
          f"tiers: a copy kernel never launched: {launches}")
    return launches


def parity_phase(runner, dev, phase: str = "parity", ragged: bool = True,
                 lens=(300, 180, 90), S: int = 320, MP: int = 24, NP: int = 80,
                 moe_sels=None, gate: bool = True, against: str = "ref"):
    """Three sequences of `lens` tokens prefilled in chunks of S (one
    chunk by default; padding rows, and rows that have finished in later
    chunks), two decode steps of the first two (the third a padding row),
    then (`ragged`) one ragged dispatch: both decode rows and a 77-token
    chunk of the third over its prior tokens (T 88, a 9-row tail).
    Through forward(attn_impl="kernel") and forward(attn_impl="ref") on
    their own pools (the runner's kind: int8 with kv_quantize); decode
    inputs are the kernel path's greedy tokens, fed to both. Only rows
    with tokens in a step are compared. With int8 pools the kernel path
    also runs on bf16 pools, and the int8 logits' distance to those is
    reported as information. `moe_sels` (from record_selections, around
    the call) adds how many top-k choices differ between the paths;
    gate=False reports the errors without holding them to the limit.
    against="kernel" runs the kernel path in place of the plain one, on
    pools of its own, and holds the two to bit-for-bit equality: the
    engine's greedy streams repeat run to run only if every kernel and
    the glue between them do."""
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.models.toolkit import make_kv_pool

    cfg, params = runner.config, runner.params
    PS = 16
    gen = torch.Generator(device="cpu").manual_seed(2)
    lens = list(lens)
    n_chunks = -(-max(lens) // S)
    toks = [torch.randint(0, cfg.vocab_size, (3, S), generator=gen)
            for _ in range(n_chunks)]
    pages = torch.randperm(NP, generator=gen)[: 3 * MP].view(3, MP).to(torch.int32)
    pages = pages.to(dev)
    # path name -> (attn_impl, pools)
    paths = {name: (impl, make_kv_pool(cfg, NP + 1, PS, runner.dtype, dev,
                                       kv_quantize=runner.kv_quantize))
             for name, impl in (("kernel", "kernel"), ("ref", against))}
    if runner.kv_quantize:
        paths["kernel_bf16"] = ("kernel", make_kv_pool(cfg, NP + 1, PS, runner.dtype, dev))
    rel, agree, worst_abs = [], [], 0.0
    rel_bf16, agree_bf16 = [], []

    def compare(logits, rows=None):
        nonlocal worst_abs
        a, b = logits["kernel"], logits["ref"]
        c = logits.get("kernel_bf16")
        if rows is not None:
            a, b = a[rows], b[rows]
            c = None if c is None else c[rows]
        check(torch.isfinite(a).all().item(), "kernel-path logits not finite")
        rel.append(((a - b).norm(dim=-1) / b.norm(dim=-1)).max().item())
        worst_abs = max(worst_abs, (a - b).abs().max().item())
        agree.extend((a.argmax(-1) == b.argmax(-1)).tolist())
        if c is not None:
            rel_bf16.append(((a - c).norm(dim=-1) / c.norm(dim=-1)).max().item())
            agree_bf16.extend((a.argmax(-1) == c.argmax(-1)).tolist())
        return logits["kernel"].argmax(-1).to(torch.int32)

    nxt = torch.zeros(3, dtype=torch.int32, device=dev)
    real = []  # each step's real (not padding) tokens, flat
    for ci in range(n_chunks):  # chunked prefill, all rows in one batch
        pos = torch.full((3, S), -1, dtype=torch.int32)
        kvl = torch.zeros(3, dtype=torch.int32)
        last = torch.zeros(3, dtype=torch.long)
        for b, n in enumerate(lens):
            lo, hi = ci * S, min(n, (ci + 1) * S)
            if hi > lo:
                pos[b, :hi - lo] = torch.arange(lo, hi)
                kvl[b], last[b] = hi, hi - 1 - lo
        live = torch.tensor([n > ci * S for n in lens], device=dev)
        real.append((pos >= 0).reshape(-1))
        out = compare({
            name: llama.forward(cfg, params, toks[ci].to(dev), pos.to(dev),
                                *pl, pages, kvl.to(dev), last.to(dev),
                                attn_impl=impl)[:, -1]
            for name, (impl, pl) in paths.items()}, None if live.all() else live)
        done = torch.tensor([ci * S < n <= (ci + 1) * S for n in lens], device=dev)
        nxt = torch.where(done, out, nxt)
    for t in range(2):
        p1 = torch.tensor([[lens[0] + t], [lens[1] + t], [-1]],
                          dtype=torch.int32, device=dev)
        kvl = torch.where(p1[:, 0] < 0, 0, p1[:, 0] + 1).to(torch.int32)
        real.append((p1 >= 0).reshape(-1).cpu())
        nxt = compare({
            name: llama.forward(cfg, params, nxt[:, None], p1, *pl,
                                pages, kvl, None, attn_impl=impl)[:, -1]
            for name, (impl, pl) in paths.items()})
    steps_run = ["prefill"] * n_chunks + ["decode", "decode"]
    if ragged:
        ragged_parity_step(cfg, params, paths, nxt, lens, pages, MP, gen, dev,
                           compare)
        real.append(torch.arange(88) < 79)  # two decode rows, a 77-token chunk
        steps_run.append("ragged")
    worst = max(rel)
    rec = {"phase": phase, "model": cfg.name, "lens": lens, "steps": steps_run,
           "kv_quantize": runner.kv_quantize, "against": against,
           "rel_l2_err_per_step": rel, "max_abs_err": worst_abs,
           "tol_rel_l2": FORWARD_REL_TOL if against == "ref" else 0.0,
           "greedy_agreement": sum(agree) / len(agree)}
    if rel_bf16:  # information only: int8 against bf16 pools, both kernels
        rec["vs_bf16_pools"] = {"rel_l2_err_per_step": rel_bf16,
                                "greedy_agreement": sum(agree_bf16) / len(agree_bf16)}
    if moe_sels is not None:
        rec["moe_topk"] = selection_flips(moe_sels, len(paths), runner.moe_layers,
                                          real)
    rec["gated"] = gate
    emit(rec)
    check(not gate or worst <= rec["tol_rel_l2"],
          f"{phase}: kernel vs {against} forward: relative L2 error {worst} > "
          f"{rec['tol_rel_l2']}")
    check(not gate or against == "ref" or worst_abs == 0.0,
          f"{phase}: the kernel path twice: logits differ by {worst_abs}")


def ragged_parity_step(cfg, params, paths, nxt, lens, pages, MP, gen, dev,
                       compare):
    """The ragged dispatch of parity_phase over its paths (name ->
    (attn_impl, pools)): the decode rows' next tokens at lens + 2, and the
    third sequence's 77-token chunk."""
    from dynamo_tpu_torch.models import llama

    chunk = torch.randint(0, cfg.vocab_size, (77,), generator=gen).tolist()
    q_lens, starts = [1, 1, 77], [lens[0] + 2, lens[1] + 2, lens[2]]
    md = build_ragged_metadata(q_lens, starts, [s + n for s, n in zip(starts, q_lens)],
                               pages.tolist(), 88, max_pages=MP)
    flat = torch.zeros(88, dtype=torch.int32)
    flat[:2] = nxt[:2].cpu()
    flat[2:79] = torch.tensor(chunk)
    gather = torch.zeros(md["seg_kv_lens"].shape[0], dtype=torch.int32)
    gather[:3] = torch.from_numpy(md["last_index"])
    ragged = tuple(torch.from_numpy(md[k]).to(dev)
                   for k in ("seg_page_table", "seg_kv_lens", "meta"))
    positions = torch.from_numpy(md["tok_positions"]).to(dev)[None]
    compare({name: llama.forward(cfg, params, flat.to(dev)[None], positions,
                                 *pl, last_index=gather.to(dev),
                                 attn_impl=impl, ragged=ragged)[0, :3]
             for name, (impl, pl) in paths.items()})


def mla_pages_phase(engine, prompt) -> None:
    """MLA pages through the copy kernels: the latent and stub pages of
    `prompt` (cached by the finished engine) go export_pages_device ->
    import_pages_device into fresh slots, and export_pages ->
    import_pages(layer_groups=3) into others, bit for bit, with the copy
    kernels' launches counted."""
    runner = engine.runner
    src = [engine.pool.by_hash[h] for h in block_hashes(prompt, PAGE_SIZE)]
    free = [pg for pg in range(runner.num_pages - 1, -1, -1) if pg not in set(src)]
    dev_dst, wire_dst = free[:len(src)], free[len(src):2 * len(src)]
    torch.cuda.synchronize()
    _reset(runner)
    k, v = runner.export_pages_device(src)
    runner.import_pages_device(dev_dst, 0, k, v)
    payload = runner.export_pages(src)
    runner.import_pages(wire_dst, 0, payload, layer_groups=3)
    torch.cuda.synchronize()
    launches = {name: KERNELS[name].launches for name in COPY_KERNELS}
    for pool in (runner.k_pool, runner.v_pool):
        check(torch.equal(pool[:, dev_dst], pool[:, src]),
              "mla_pages: the device round trip changed the pages")
        check(torch.equal(pool[:, wire_dst], pool[:, src]),
              "mla_pages: the wire round trip changed the pages")
    check(runner.k_pool[:, src].float().abs().sum().item() > 0,
          "mla_pages: the exported latent pages are empty")
    # each export gathers and each import scatters once per pool
    want = {"gather_pages": 4, "scatter_pages": 2, "scatter_pages_layers": 6}
    check(launches == want, f"mla_pages: copy launches {launches} != {want}")
    emit({"phase": "mla_pages", "pages": len(src),
          "k_page_shape": list(runner.k_pool.shape[2:]),
          "v_page_shape": list(runner.v_pool.shape[2:]),
          "payload_shape": payload["shape"], "payload_v_shape": payload["v_shape"],
          "launches": launches, "bit_exact": True})


def mla_phases(dev):
    """DeepSeek-V3's three dense layers at full width: the engine phase
    (launch identities, every request length 32), the page round trip
    through the copy kernels, and the forward parity."""
    t0 = time.monotonic()
    runner = ModelRunner(MLA_CONFIG, num_pages=2048, page_size=PAGE_SIZE,
                         max_pages_per_seq=4096 // PAGE_SIZE)
    torch.cuda.synchronize()
    build_s = time.monotonic() - t0
    check(not runner.ragged_mixed, "engine_mla: the runner kept the ragged path")
    check(runner.kv_page_shape == (3, PAGE_SIZE, 1, MLA_CONFIG.mla_cache_dim),
          f"engine_mla: page shape {runner.kv_page_shape}")
    rec, launches, results = engine_phase(runner, "mla", build_s=build_s)
    st = rec["stats"]
    check(rec["fused_mixed"], "engine_mla: the engine did not fuse on the card")
    for name in MLA_KERNELS:
        check(launches[name] > 0, f"engine_mla: {name} never launched")
    check(st["padded_prefill_dispatches"] > 0 and st["ragged_mixed_dispatches"] == 0,
          f"engine_mla: mixed plans did not take the padded fallback: {st}")
    for i, (toks, finish, _) in enumerate(results):
        check(finish == "length" and len(toks) == N_OUT,
              f"engine_mla: r{i} finished {finish!r} with {len(toks)} tokens")
    rec["config"] = {k: getattr(MLA_CONFIG, k) for k in (
        "name", "dim", "n_layers", "n_heads", "q_lora_rank", "kv_lora_rank",
        "qk_rope_head_dim", "qk_nope_head_dim", "v_head_dim", "ffn_dim",
        "vocab_size", "rope_scaling", "rope_factor")}
    rec["kv_bytes_per_token_per_layer"] = MLA_CONFIG.mla_cache_dim * 2
    emit(rec)
    engine = build_engine(parse_args(ENGINE_ARGS), runner=runner)
    try:
        prompt = workload(MLA_CONFIG.vocab_size, seed=1)[0][5]["token_ids"]
        asyncio.run(asyncio.wait_for(_collect_timed(engine, {
            "token_ids": prompt, "sampling": {"temperature": 0.0},
            "stop": {"max_tokens": 2, "stop_ids": []}}, "pages"), 300))
    finally:
        engine.stop()
    mla_pages_phase(engine, prompt)
    parity_phase(runner, dev, phase="parity_mla", ragged=False)

    # the int8 latent (same params): decode on the int8 body, prefill on
    # the reference's gather (no MLA prefill launch)
    runner8 = ModelRunner(MLA_CONFIG, num_pages=2048, page_size=PAGE_SIZE,
                          max_pages_per_seq=4096 // PAGE_SIZE, params=runner.params,
                          kv_quantize="int8")
    rec, launches8, results = engine_phase(runner8, "mla_int8")
    n = launches8["decode_mla_attention"]
    check(rec["fused_mixed"], "engine_mla_int8: the engine did not fuse on the card")
    check(n > 0 and rec["bodies"]["decode_mla_attention"] == {"int8": n},
          f"engine_mla_int8: MLA decode launches {n}, bodies "
          f"{rec['bodies']['decode_mla_attention']}")
    for i, (toks, finish, _) in enumerate(results):
        check(finish == "length" and len(toks) == N_OUT,
              f"engine_mla_int8: r{i} finished {finish!r} with {len(toks)} tokens")
    rec["kv_bytes_per_token_per_layer"] = MLA_CONFIG.mla_cache_dim + 4 + 1 + 4
    emit(rec)
    return launches, launches8


# the slice's main path: llama-3.1-8b at full width and depth (32 layers,
# 32 / 8 heads, head dim 128, bf16 random weights, seed 0) over int8 KV
# pools, 2048 pages x 16, serving workload()'s 8 requests
ENGINE_8B_ARGS = model_args("llama-3.1-8b", kv_quantize=True)


def int8kv_phases(dev, smi):
    """`engine_int8kv` (fused, the card's default) and
    `engine_int8kv_unfused` on one llama-3.1-8b runner with int8 pools:
    every request `length`, each GQA kernel's launches equal to its passes
    x 32, all on the D128_int8 bodies; the pools' bytes beside a bf16
    pool's; then `parity_int8kv`. Returns the fused phase's launches and
    the bodies of both phases."""
    runner, cfg, build_s = timed_runner(ENGINE_8B_ARGS)
    L = cfg.n_layers
    check(runner.kv_quantize == "int8" and runner.k_pool["q"].dtype == torch.int8,
          "engine_int8kv: the runner's pools are not int8")
    check(runner.kv_page_shape == (L, PAGE_SIZE, cfg.n_kv_heads, cfg.head_dim),
          f"engine_int8kv: page shape {runner.kv_page_shape}")
    pool_bytes = sum(t.numel() * t.element_size()
                     for pool in (runner.k_pool, runner.v_pool) for t in pool.values())
    bf16_bytes = 2 * runner.k_pool["q"].numel() * 2
    body = f"D{cfg.head_dim}_int8"
    found, fused_launches = {}, None
    for phase, fused in (("int8kv", None), ("int8kv_unfused", False)):
        rec, launches = served_turn(runner, phase, fused, ENGINE_8B_ARGS, one_body(body),
                                    build_s=build_s if fused is None else None)
        if fused is None:
            fused_launches = launches
        rec["kv_pool_bytes"] = pool_bytes
        rec["kv_pool_bytes_if_bf16"] = bf16_bytes
        rec["config"] = {k: getattr(cfg, k) for k in (
            "name", "dim", "n_layers", "n_heads", "n_kv_heads", "head_dim",
            "ffn_dim", "vocab_size", "rope_scaling")}
        rec["nvidia_smi"] = smi
        found[phase] = rec["bodies"]
        emit(rec)
    parity_phase(runner, dev, phase="parity_int8kv")
    return fused_launches, found


# Gemma-2 9B at full width and depth: 42 layers, head dim 256, G 2, a
# 4096-token window on the even layers, soft caps 50 (scores) and 30
# (logits), served with workload()'s 8 requests and two prompts past the
# window
GEMMA_ARGS = model_args("gemma-2-9b", 8192)
GEMMA_LONG_PROMPTS = (4600, 5200)
GEMMA_WINDOW = 4096
# gemma_kernels: (Hk, G, D) of Gemma-2 9B and of the 3B's heads; 16-token
# pages, 384 of them a row (6144 tokens)
GEMMA_SHAPES = {"D256_G2": (8, 2, 256), "D128_G3": (8, 3, 128)}
GEMMA_MP = 384
# contexts around the 4096-token window, and contexts whose 7-token window
# crosses page (16), tile (64), decode-split (384) and ragged-split (512)
# edges
GEMMA_LONG = [1, 4095, 4096, 4097, 6000]
GEMMA_EDGES = [1, 7, 8, 20, 67, 388, 515, 1000]
# case: (contexts, window, softcap, scale, query scale); scale None is
# D^-0.5. The soft-capped cases draw queries 20x larger, so that scores
# reach the cap (std about 20): a body that skipped the cap would miss by
# far more than KERNEL_TOL. Every case is held against the plain version
# run in f32 on the same (bf16) inputs, as the MLA kernels are.
GEMMA_CASES = {
    "gemma2": (GEMMA_LONG, GEMMA_WINDOW, 50.0, 256 ** -0.5, 20.0),
    "window_4096": (GEMMA_LONG, GEMMA_WINDOW, 0.0, None, 1.0),
    "window_7": (GEMMA_EDGES, 7, 0.0, None, 1.0),
    "window_0": (GEMMA_LONG, 0, 0.0, None, 1.0),
    "softcap_50": (GEMMA_LONG, None, 50.0, None, 20.0),
    "scale": (GEMMA_LONG, None, 0.0, 0.05, 1.0),
}
GEMMA_CHUNK = 512  # prefill chunk: q_len = min(context, 512)
GEMMA_RAGGED_CHUNK = 48  # ragged chunk rows beside each decode row
# soft cap in the kernels: 7 f32 operations a score (two multiplies, ex2,
# add, rcp, fma, multiply)
CAP_FP32_OPS = 7


# int8 decode's warps a block at each head dim, one tile slot each
# (paged_attention.cu code_warps)
DECODE_CODE_WARPS = {64: 4, 96: 4, 128: 4, 256: 6}


def gqa_smem_bytes(D: int):
    """Dynamic shared memory of each GQA kernel's bf16 body at head dim D
    (the layouts of paged_attention.cu DecShape and paged_flash.cuh Shape:
    rows D + 8 bf16 apart, 64-token tiles, mbarriers) and of the int8
    decode kernel (DecCodeShape: per warp a slot of 64 K and 64 V rows of D
    + 16 bytes and their scales)."""
    row = (D + 8) * 2
    slots = DECODE_CODE_WARPS[D]
    return {"decode": (16 + 2 * 3 * 64) * row + 8 * 3,
            "decode_int8": slots * (2 * 64 * (D + 16) + 2 * 64 * 4 + 8),
            "prefill": (128 + 2 * 2 * 64) * row + 8 * 2,
            "ragged": (64 + 2 * 2 * 64) * row + 8 * 2}


def visible(q_start, q_len, kv, window):
    """(visible (query, key) pairs, visible tokens, their pages) of q_len
    query tokens from q_start over a kv-token context: the token at p sees
    [p - window + 1 (0 without a window), min(p, kv - 1)]."""
    pairs = 0
    for p in range(q_start, q_start + q_len):
        first = max(p - window + 1, 0) if window else 0
        pairs += max(min(p, kv - 1) - first + 1, 0)
    if q_len <= 0 or kv <= 0:
        return pairs, 0, 0
    first = max(q_start - window + 1, 0) if window else 0
    last = min(q_start + q_len - 1, kv - 1)
    if last < first:
        return pairs, 0, 0
    return pairs, last - first + 1, last // PAGE_SIZE - first // PAGE_SIZE + 1


def kv_row_bytes(D: int, int8: bool = False) -> int:
    """Bytes of one token's K and V rows of one head: bf16, or int8 codes
    and an f32 scale each."""
    return 2 * (D + 4) if int8 else 2 * D * 2


def gemma_bound(H, Hk, D, spans, window, io_rows, n_ints, softcap, int8=False):
    """Bound over what the data needs: `spans` [(q_start, q_len, kv)] of
    each sequence, whose visible K/V tokens are read once with their table
    entries (kv_row_bytes a head); `io_rows` query rows read and output
    rows written (H x D bf16 each); n_ints int32 metadata; one score and
    one PV product per visible pair and head, and the cap's f32 operations
    per score."""
    pairs = toks = pages = 0
    for q_start, q_len, kv in spans:
        p, t, g = visible(q_start, q_len, kv, window)
        pairs, toks, pages = pairs + p, toks + t, pages + g
    n_bytes = (io_rows * H * D * 2 + toks * Hk * kv_row_bytes(D, int8) + pages * 4
               + n_ints * 4)
    return bound(n_bytes, 4 * pairs * H * D,
                 CAP_FP32_OPS * pairs * H if softcap else 0.0)


def gemma_case_inputs(kernel, contexts, Hk, G, D, q_mul, pools, gen, dgen, dev,
                      lib_pools=None):
    """Operands of one gemma_kernels case (on the shape's shared pools,
    each sequence on its own random pages), its Spans, the rows to check,
    the query/output row count and int32 metadata count of its bound, and
    the yardstick's dense operands (q, K, V [.., H, ., D], from `lib_pools`,
    the bf16 pools, default `pools`) and mask without the window."""
    NP = pool_values(pools[0]).shape[0]
    kp, vp = pools if lib_pools is None else lib_pools
    H, MP, PS = Hk * G, GEMMA_MP, PAGE_SIZE

    def qrand(*shape):
        return (torch.randn(*shape, generator=dgen, device=dev) * q_mul).bfloat16()

    def dense(pt):  # [B, H, MP * PS, D] K and V of each row's pages
        return dense_kv(kp, pt, Hk, G), dense_kv(vp, pt, Hk, G)

    c_pos = torch.arange(MP * PS, device=dev)
    if kernel == "decode":
        kv = contexts + [0]
        B = len(kv)
        pt = random_pages(gen, B, MP, NP, dev)
        q = qrand(B, Hk, G, D)
        kvl = torch.tensor(kv, dtype=torch.int32, device=dev)
        kd, vd = dense(pt)
        pos = kvl.long()[:, None] - 1  # [B, 1] query positions
        mask = (c_pos[None, None, :] <= pos[:, :, None])[:, None]
        return {"args": (q, *pools, pt, kvl), "rows": B - 1,
                "spans": [(k - 1, 1, k) for k in kv if k > 0], "io_rows": 2 * B,
                "n_ints": B, "lib": (q.reshape(B, H, 1, D), kd, vd, mask, pos)}
    if kernel == "prefill":
        B, S = len(contexts), GEMMA_CHUNK
        q_len = [min(c, S) for c in contexts]
        q_start = [c - n for c, n in zip(contexts, q_len)]
        pt = random_pages(gen, B, MP, NP, dev)
        q = qrand(B, S, Hk, G, D)
        ints = [torch.tensor(x, dtype=torch.int32, device=dev)
                for x in (q_start, q_len, contexts)]
        kd, vd = dense(pt)
        pos = ints[0].long()[:, None] + torch.arange(S, device=dev)[None, :]
        mask = ((c_pos[None, None, :] <= pos[:, :, None])
                & (c_pos[None, None, :] < ints[2].long()[:, None, None]))[:, None]
        return {"args": (q, *pools, pt, *ints), "rows": q_len,
                "spans": list(zip(q_start, q_len, contexts)),
                "io_rows": sum(q_len) + B * S, "n_ints": 3 * B,
                "lib": (q.reshape(B, S, H, D).transpose(1, 2), kd, vd, mask, pos)}
    segs = [(1, c - 1) for c in contexts]
    segs += [(min(GEMMA_RAGGED_CHUNK, c), c - min(GEMMA_RAGGED_CHUNK, c))
             for c in contexts if c > 1]
    t_real = sum(n for n, _ in segs)
    T = -(-(t_real + 1) // 8) * 8  # a tail of dummy rows
    pt = random_pages(gen, len(segs), MP, NP, "cpu")
    md = build_ragged_metadata([n for n, _ in segs], [p for _, p in segs],
                               [p + n for n, p in segs], pt.tolist(), T,
                               max_pages=MP)
    ints = tuple(torch.from_numpy(md[k]).to(dev)
                 for k in ("seg_page_table", "seg_kv_lens", "meta"))
    return {"args": (qrand(T, Hk, G, D), *pools) + ints, "segs": segs, "md": md,
            "rows": t_real, "spans": [(p, n, p + n) for n, p in segs],
            "io_rows": t_real + T,
            "n_ints": md["seg_kv_lens"].size + md["meta"].size}


def gemma_plain_f32(kernel, inp, window, scale, softcap):
    """The plain version on the case's inputs in f32 (ragged: segment by
    segment, each flat token being an S = 1 row of its segment, so the
    gathered context stays a few GB)."""
    args = inp["args"]
    q = args[0].float()
    kw = dict(softcap=softcap, window=window)
    if kernel == "decode":
        return decode_paged_attention_ref(q, inp["kp32"], inp["vp32"], *args[3:],
                                          scale, **kw)
    if kernel == "prefill":
        return prefill_paged_attention_ref(q, inp["kp32"], inp["vp32"], *args[3:],
                                           scale, **kw)
    segs, md = inp["segs"], inp["md"]
    out = torch.zeros_like(q)
    lo = 0
    for s, (n, p) in enumerate(segs):
        tb = -(-n // 8) * 8
        ms = build_ragged_metadata([n], [p], [p + n], [md["seg_page_table"][s].tolist()],
                                   tb, max_pages=GEMMA_MP)
        ops = [torch.from_numpy(ms[k]).to(q.device)
               for k in ("seg_page_table", "seg_kv_lens", "meta")]
        qs = torch.zeros((tb,) + q.shape[1:], device=q.device)
        qs[:n] = q[lo:lo + n]
        out[lo:lo + n] = ragged_paged_attention_ref(
            qs, inp["kp32"], inp["vp32"], *ops, window, scale=scale,
            softcap=softcap)[:n]
        lo += n
    return out


def case_errors(kernel, got, want, rows):
    """(max abs error, row_rel_err) of a case's output over its valid rows
    (prefill: the first q_len rows of each sequence)."""
    if kernel == "prefill":
        pairs = [(got[b, :n], want[b, :n]) for b, n in enumerate(rows) if n]
    else:
        pairs = [(got[:rows], want[:rows])]
    return (max((g.float() - w.float()).abs().max().item() for g, w in pairs),
            max(row_rel_err(g, w) for g, w in pairs))


def planted_faults(kernel, inp, window, scale):
    """The plain computation (f32 SDPA over the case's dense K/V) with a
    fault planted: the window's edge moved one token either way, and, in
    each row that sees a whole 64-token tile before the tile of its last
    visible token, that tile skipped. {fault: output, laid out as the
    kernel's}; decode and prefill cases only."""
    qd, kd, vd, mask, pos = inp["lib"]
    args = inp["args"]
    c = torch.arange(kd.shape[2], device=kd.device)[None, None, None, :]
    kv = args[-1].long()[:, None, None, None]
    p = pos[:, None, :, None]  # [B, 1, S, 1] query positions
    seen = mask & (c < kv)
    first = (p - window + 1).clamp_min(0) if window else torch.zeros_like(p)
    t0 = (torch.minimum(p, kv - 1) // 64 - 1) * 64
    skipped = (c >= t0) & (c < t0 + 64) & (t0 >= first)
    masks = {}
    if (skipped & seen).any():
        masks["tile"] = seen & (c >= first) & ~skipped
    if window and window > 1:
        masks["window+1"] = seen & (c > p - window - 1)
        masks["window-1"] = seen & (c > p - window + 1)
    q32, k32, v32 = qd.float(), kd.float(), vd.float()
    shape = args[0].shape
    out = {}
    for name, m in masks.items():
        o = F.scaled_dot_product_attention(q32, k32, v32, attn_mask=m, scale=scale)
        out[name] = (o.reshape(shape) if kernel == "decode"
                     else o.transpose(1, 2).reshape(shape))
    return out


def planted_faults_ragged(inp, want, window, scale, kpool, vpool):
    """planted_faults for a ragged case, segment by segment (each a
    one-sequence prefill over the segment's dense K/V from `kpool`,
    `vpool`); a segment where a fault does not apply keeps `want`'s rows."""
    q = inp["args"][0]
    T, Hk, G, D = q.shape
    out = {}
    lo = 0
    for s, (n, p) in enumerate(inp["segs"]):
        pt = torch.from_numpy(inp["md"]["seg_page_table"][s:s + 1]).to(q.device)
        kd, vd = dense_kv(kpool, pt, Hk, G), dense_kv(vpool, pt, Hk, G)
        pos = torch.arange(p, p + n, device=q.device)[None]
        c = torch.arange(kd.shape[2], device=q.device)
        mask = (c[None, None, :] <= pos[:, :, None])[:, None]
        kvl = torch.tensor([p + n], dtype=torch.int32, device=q.device)
        seg = {"lib": (q[lo:lo + n].reshape(1, n, Hk * G, D).transpose(1, 2), kd, vd,
                       mask, pos),
               "args": (q[lo:lo + n][None], kvl)}
        for name, o in planted_faults("prefill", seg, window, scale).items():
            out.setdefault(name, want.clone())[lo:lo + n] = o[0]
        lo += n
    return out


def code_perms(D: int):
    """The int8 walk's dim orders (paged_flash.cuh code_slice, code_cols):
    q_perm[j] is the dim of Q that the kernel stages at j, o_perm[j] the dim
    that O's column j holds before the epilogue puts it back."""
    g64 = D // 64 * 64
    q_perm = [0] * D
    for d0 in range(0, D, 4):
        width, base = (64, d0 // 64 * 64) if d0 < g64 else (32, g64)
        off = d0 - base
        s, t4 = base // 16 + off % (width // 4) // 4, off // (width // 4)
        for k, d in ((2 * t4, d0), (2 * t4 + 1, d0 + 2), (2 * t4 + 8, d0 + 1),
                     (2 * t4 + 9, d0 + 3)):
            q_perm[16 * s + k] = d
    o_perm = [32 * c + 16 * (w >> 1) + 4 * t4 + (w & 1) + 2 * j
              for c in range(D // 32) for w in range(4) for t4 in range(4)
              for j in range(2)]
    return q_perm, o_perm


def int8_faults(kernel, inp, want, window, scale, softcap):
    """The plain version in f32 with a fault of the int8 walk planted
    (outputs laid out as the kernel's): each token's K or V scale read from
    the slot before it, every scale from the next head, O's columns left in
    the kernel's order, and Q's dims in the kernel's order against K's own.
    Over pools whose scales spread over decades (spread_int8_pool) each
    must break ROW_REL_TOL."""
    kp, vp = inp["kp32"], inp["vp32"]
    D = inp["args"][0].shape[-1]
    q_perm, o_perm = code_perms(D)

    def roll(pool, dim):
        return {"q": pool["q"], "s": pool["s"].roll(1, dims=dim)}

    def plain(**over):
        return gemma_plain_f32(kernel, {**inp, **over}, window, scale, softcap)

    args = inp["args"]
    return {
        "k_scale_token": plain(kp32=roll(kp, 1)),
        "v_scale_token": plain(vp32=roll(vp, 1)),
        "scale_head": plain(kp32=roll(kp, 2), vp32=roll(vp, 2)),
        "cols": want[..., o_perm],
        "dims": plain(args=(args[0][..., q_perm],) + tuple(args[1:])),
    }


def spread_int8_pool(x, gen, decades: float = 3.0):
    """int8_pool of bf16 rows x [NP, PS, Hk, D], each (token, head) row
    first scaled by 10^u, u uniform in [-decades, 0]: scales `decades`
    decades apart, dequantized values at most x's."""
    u = torch.rand(x.shape[:-1], generator=gen, device=x.device) * -decades
    return int8_pool((x.float() * torch.pow(10.0, u)[..., None]).bfloat16())


def gemma_case(kernel, what, heads, case, pools, pools32, gen, dgen, dev,
               lib_pools=None, spread=False, timed=True):
    """One kernel at `heads` (Hk, G, D) and `case` (a GEMMA_CASES tuple):
    checked against the plain version in f32 (max abs error within
    KERNEL_TOL, row_rel_err within ROW_REL_TOL; with no cap, each planted
    fault must break ROW_REL_TOL: on bf16 pools decode and prefill, on
    int8 pools prefill and ragged, and with `spread` (int8 pools from
    spread_int8_pool) decode's and int8_faults too), timed (unless not
    `timed`) with its
    yardstick and the plain version. Int8 dict `pools` are their own f32
    plain operands (`pools32`), and `lib_pools` their dequantized bf16
    pools for the yardstick and the planted faults. Everything it
    allocates is freed on return (the engine phases' peak memory is read
    later)."""
    Hk, G, D = heads
    contexts, window, softcap, scale, q_mul = case
    fn = {"decode": decode_paged_attention, "prefill": prefill_paged_attention,
          "ragged": ragged_paged_attention}[kernel]
    sc = D ** -0.5 if scale is None else scale
    int8 = lib_pools is not None
    inp = gemma_case_inputs(kernel, contexts, Hk, G, D, q_mul, pools, gen, dgen, dev,
                            lib_pools)
    inp["kp32"], inp["vp32"] = pools32
    args = inp["args"]
    kw = dict(scale=scale, softcap=softcap)
    got = fn(*args, window, **kw)
    torch.cuda.synchronize()
    want = gemma_plain_f32(kernel, inp, window, scale, softcap)
    rows = inp["rows"]
    err, rel = case_errors(kernel, got, want, rows)
    if kernel == "prefill":
        zero = all(got[b, n:].float().abs().max().item() == 0.0
                   for b, n in enumerate(rows) if n < GEMMA_CHUNK)
    else:
        tail = got[rows:] if kernel == "ragged" else got[-1:]
        zero = tail.numel() == 0 or tail.float().abs().max().item() == 0.0
    what = f"{what} {kernel}"
    check(torch.isfinite(got.float()).all().item(), f"{what}: not finite")
    check(zero, f"{what}: padding, tail or empty rows are not 0")
    check(err <= KERNEL_TOL, f"{what}: max abs err {err} > {KERNEL_TOL}")
    check(rel <= ROW_REL_TOL, f"{what}: row error {rel} > {ROW_REL_TOL}")
    bad = {}
    if not softcap and (kernel == "prefill" or (kernel == "ragged" and int8)
                        or (kernel == "decode" and (spread or not int8))):
        bad = (planted_faults_ragged(inp, want, window, sc, *lib_pools) if kernel == "ragged"
               else planted_faults(kernel, inp, window, sc))
    if spread:
        bad.update(int8_faults(kernel, inp, want, window, scale, softcap))
    faults = {}
    for name in list(bad):
        faults[name] = case_errors(kernel, bad.pop(name), want, rows)[1]
        check(faults[name] > ROW_REL_TOL,
              f"{what}: planted fault {name} reads {faults[name]}, "
              f"within ROW_REL_TOL {ROW_REL_TOL}")
    if not timed:
        return {"max_abs_err": err, "row_rel_err": rel, "planted_faults": faults}
    b_ms, b_by = gemma_bound(Hk * G, Hk, D, inp["spans"], window, inp["io_rows"],
                             inp["n_ints"], softcap, int8)
    if kernel == "ragged":
        lib_args = args if not int8 else (args[0], *lib_pools) + tuple(args[3:])
        lib = ragged_library(lib_args, inp["segs"], inp["md"], sc, window=window,
                             softcap=softcap)
    else:
        qd, kd, vd, mask, pos = inp["lib"]
        c = torch.arange(kd.shape[2], device=dev)[None, None, None, :]
        mask = mask & (c < args[-1].long()[:, None, None, None])
        if window:
            mask = mask & (c > pos[:, None, :, None] - window)
        lib = (capped_attention(qd, kd, vd, mask, sc, softcap) if softcap else
               lambda: F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask,
                                                      scale=sc))
    del want

    def call():
        return fn(*args, window, **kw)

    return {"max_abs_err": err, "row_rel_err": rel, "planted_faults": faults,
            "ms": cuda_ms(call), "device_ms": graph_ms(call),
            "plain_ms": cuda_ms(
                lambda: gemma_plain_f32(kernel, inp, window, scale, softcap),
                iters=2, warmup=1),
            "bound_ms": b_ms, "bound_by": b_by,
            "library": "bmm-tanh-softmax-bmm" if softcap else "sdpa",
            "library_ms": cuda_ms(lib), "library_device_ms": graph_ms(lib)}


def gemma_kernels_phase(dev):
    """The three GQA kernels' Gemma-2 bodies (window, soft cap, scale
    override, D 256) against their plain versions in f32, at Gemma-2's
    heads (Hk 8, G 2, D 256) and the 3B's (Hk 8, G 3, D 128): decode rows
    at the case's contexts (and an empty row), prefill chunks of up to 512
    tokens ending there, and a ragged step of a decode row and a 48-token
    chunk at each. Each case is timed back to back and replayed from a CUDA
    graph beside its yardstick (SDPA under a boolean window mask over
    dense K/V; with a soft cap, the bmm-tanh-softmax-bmm calls), with a
    bound over the visible bytes and operations only."""
    gen = torch.Generator(device="cpu").manual_seed(11)
    dgen = torch.Generator(device=dev).manual_seed(11)
    torch.cuda.synchronize()
    mem = {"start": torch.cuda.memory_allocated()}
    out = {}
    for shape, (Hk, G, D) in GEMMA_SHAPES.items():
        NP = 2 * len(GEMMA_EDGES) * GEMMA_MP + 1
        pools = tuple(torch.randn(NP, PAGE_SIZE, Hk, D, generator=dgen,
                                  device=dev).bfloat16() for _ in range(2))
        pools32 = tuple(x.float() for x in pools)
        rec = {"Hk": Hk, "G": G, "D": D, "smem_bytes": gqa_smem_bytes(D),
               "cases": {}}
        for case, (contexts, window, softcap, scale, q_mul) in GEMMA_CASES.items():
            crec = {"contexts": contexts, "window": window, "softcap": softcap,
                    "scale": scale, "q_scale": q_mul}
            for kernel in ("decode", "prefill", "ragged"):
                crec[kernel] = gemma_case(
                    kernel, f"gemma_kernels {shape} {case}", (Hk, G, D),
                    GEMMA_CASES[case], pools, pools32, gen, dgen, dev)
                torch.cuda.empty_cache()
            rec["cases"][case] = crec
        out[shape] = rec
        del pools, pools32
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    mem["end"] = torch.cuda.memory_allocated()
    # cuBLAS keeps a workspace for each stream it ran on, here the capped
    # yardstick's matmuls on graph_ms's capture streams: free them, so
    # that they do not count in the engine phases' peak memory
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
        mem["after_clearing_cublas_workspaces"] = torch.cuda.memory_allocated()
    emit({"phase": "gemma_kernels", "tol": KERNEL_TOL, "row_tol": ROW_REL_TOL,
          "memory_allocated_bytes": mem, **out})
    return out


# int8 KV (models/quant.py pools): the int8 bodies of the three GQA kernels
# at `kernels`' D 128 G 3 shapes and at gemma_kernels' Gemma-2 case, and of
# MLA decode at mla_kernels' decode shape; the kernels-line entries they
# head and the TPU kernel bodies they replace
INT8_SOURCES = {
    "decode_paged_attention_int8": (
        "dynamo_tpu_torch/ops/csrc/paged_attention.cu",
        "dynamo_tpu/ops/paged_attention.py:147"),
    "prefill_paged_attention_int8": (
        "dynamo_tpu_torch/ops/csrc/flash_prefill.cu",
        "dynamo_tpu/ops/flash_prefill.py:157"),
    "ragged_paged_attention_int8": (
        "dynamo_tpu_torch/ops/csrc/ragged_paged_attention.cu",
        "dynamo_tpu/ops/ragged_paged_attention.py:303"),
    "decode_mla_attention_int8": (
        "dynamo_tpu_torch/ops/csrc/mla_attention.cu",
        "dynamo_tpu/ops/mla_attention.py:107"),
}


def int8_pool(x):
    """An int8 pool quantized from bf16 rows x (codes and scales as the
    engine writes them) and its dequantized bf16 pool, the yardstick's
    operand (dequantized here, outside every timed call)."""
    d = kv_pool_quantize(x)
    return d, kv_pool_dequantize(d, torch.bfloat16)


def int8_record(call, plain, lib, n_bytes, n_flops, err):
    """Times of an int8 kernel call (back to back and replayed), its plain
    version (back to back) and its yardstick, and the bound."""
    b_ms, b_by = bound(n_bytes, n_flops)
    return {"max_abs_err": err, "ms": cuda_ms(call), "device_ms": graph_ms(call),
            "plain_ms": cuda_ms(plain, iters=5), "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": cuda_ms(lib), "library_device_ms": graph_ms(lib)}


# the engine-shaped int8 MLA decode batch: workload()'s prompt lengths and
# 16 output tokens
MLA_ENGINE_KV = [n + 16 for n in (17, 64, 300, 700, 1100, 1500, 406, 656)]
# kv lengths of the int8 MLA gate: the edges of its 64-token tiles and of its
# first two MLA_INT8_SPLIT_TOKENS splits, 0, 1 and 4096
MLA_I8_EDGES = sorted({0, 1, 4096}
                      | {k * INT8_TILE_TOKENS + d for k in (1, 2, 3) for d in (-1, 0, 1)}
                      | {k * MLA_INT8_SPLIT_TOKENS + d for k in (1, 2) for d in (-1, 0, 1)})
# page sizes of the gate: 16 (the engine's), TMA boxes of 8, 32 and 64 rows
# (64-row boxes inside 128-token pages) and a copy a token at 4 and 48
MLA_I8_PAGE_SIZES = (16, 4, 8, 32, 48, 64, 128)


def mla_int8_bytes(kv_lens):
    """Bytes int8 MLA decode moves at least: q and out once, each context
    token's codes and scale, its table entries and kv_lens."""
    Dl = MLA_DC + MLA_DR
    B = len(kv_lens)
    return (B * MLA_H * (Dl + MLA_DC) * 2 + sum(kv_lens) * (Dl + 4)
            + sum(-(-k // MLA_PS) for k in kv_lens) * 4 + B * 4)


def mla_decode_flops(kv_lens):
    return 2 * sum(kv_lens) * MLA_H * (2 * MLA_DC + MLA_DR)


def mla_int8_perms():
    """The int8 MLA kernel's orders: q_perm[j] the dim of Q it stages at j
    (code_perms' order in each 64-dim chunk), o_perm[j] the dim that O^T's
    row j holds (m-block 64 mb, warp rows 16 w + g + 8 h: dim 64 mb + 16 w
    + 2 g + h)."""
    q_perm, _ = code_perms(MLA_DC + MLA_DR)
    o_perm = [64 * mb + 16 * w + 2 * g + h for mb in range(MLA_DC // 64)
              for w in range(4) for h in range(2) for g in range(8)]
    return q_perm, o_perm


def mla_int8_gate(gen, dev, scale):
    """int8 MLA decode at H 128 with rows at MLA_I8_EDGES, over pools whose
    per-token scales spread over three decades, at MLA_I8_PAGE_SIZES
    (TMA boxes and copies a token), untimed: max abs err within KERNEL_TOL,
    each row's error over its RMS within ROW_REL_TOL, the kv_len-0 row
    exactly 0. At page size 16, faults planted in the plain f32 version must
    each break ROW_REL_TOL: each token's scale read from the slot before
    it, a row's last 64-token tile left out, O's dims left in the kernel's
    order, Q's dims in the kernel's order against the codes' own."""
    dgen = torch.Generator(device=dev).manual_seed(15)
    kv = MLA_I8_EDGES
    B = len(kv)
    kvl = torch.tensor(kv, dtype=torch.int32, device=dev)
    q = torch.randn(B, MLA_H, MLA_DC + MLA_DR, generator=dgen, device=dev).bfloat16()
    out = {"kv_lens": kv, "page_sizes": {}}
    for ps in MLA_I8_PAGE_SIZES:
        MP = -(-max(kv) // ps)
        pt = random_pages(gen, B, MP, B * MP + 1, dev)
        lq, _ = spread_int8_pool(
            torch.randn(B * MP + 1, ps, 1, MLA_DC + MLA_DR, generator=dgen,
                        device=dev).bfloat16(), dgen)
        got = decode_mla_attention(q, lq, pt, kvl, dc=MLA_DC, scale=scale)
        torch.cuda.synchronize()

        def plain(q=q.float(), pool=lq, kvl=kvl):
            return decode_mla_attention_ref(q, pool, pt, kvl, dc=MLA_DC, scale=scale)

        want = plain()
        what = f"int8 MLA decode gate PS {ps}"
        err = (got.float() - want).abs().max().item()
        rel = row_rel_err(got, want)
        check(torch.isfinite(got.float()).all().item(), f"{what}: not finite")
        check(got[kv.index(0)].float().abs().max().item() == 0.0,
              f"{what}: the kv_len-0 row is not 0")
        check(err <= KERNEL_TOL, f"{what}: max abs err {err} > {KERNEL_TOL}")
        check(rel <= ROW_REL_TOL, f"{what}: row error {rel} > {ROW_REL_TOL}")
        rec = {"max_abs_err": err, "row_rel_err": rel}
        if ps == MLA_PS:
            q_perm, o_perm = mla_int8_perms()
            tile = INT8_TILE_TOKENS
            short = torch.tensor([k - 1 - (k - 1) % tile if k > tile else k for k in kv],
                                 dtype=torch.int32, device=dev)
            bad = {"scale_token": plain(pool={"q": lq["q"], "s": lq["s"].roll(1, dims=1)}),
                   "tile_left_out": plain(kvl=short),
                   "cols": want[..., o_perm],
                   "dims": plain(q=q.float()[..., q_perm])}
            rec["planted_faults"] = {}
            for name, x in bad.items():
                f = row_rel_err(x, want)
                rec["planted_faults"][name] = f
                check(f > ROW_REL_TOL, f"{what}: planted fault {name} reads {f}, within "
                                       f"ROW_REL_TOL {ROW_REL_TOL}")
        out["page_sizes"][f"PS{ps}"] = rec
        del lq, got, want
    torch.cuda.empty_cache()
    return out


def kv_quantize_check(dev):
    """kv_quantize on the card against the CPU's on the same bf16 rows:
    codes equal, scales within 1 ulp."""
    gen = torch.Generator(device="cpu").manual_seed(13)
    x = (torch.randn(4096, 8, 128, generator=gen) * 3).bfloat16()
    x[0, 0] = 0.0
    cpu, card = kv_quantize(x), kv_quantize(x.to(dev))
    q_equal = torch.equal(card["q"].cpu(), cpu["q"])
    ulps = (card["s"].cpu().view(torch.int32).long()
            - cpu["s"].view(torch.int32).long()).abs().max().item()
    check(q_equal, "kv_quantize: the card's codes differ from the CPU's")
    check(ulps <= 1, f"kv_quantize: the card's scales differ by {ulps} ulps")
    return {"rows": list(x.shape), "q_equal": q_equal, "s_max_ulps": ulps}


# kv lengths of the int8 gate at the 3B shape: 64-token tile edges, and
# contexts whose walks wrap the 2- and 3-stage rings many times
I8_EDGES = [1, 63, 64, 65, 127, 128, 129, 700, 2047, 2048, 2049, 4095, 4096, 4097]
# ... and, for decode, the edges of its first two context splits
I8_DECODE_EDGES = sorted(set(I8_EDGES) | {k * decode_split_tokens(128, True) + d
                                          for k in (1, 2) for d in (-1, 0, 1)})


def int8_kernels_phase(dev, bf16_ms, gemma_bf16):
    """The int8 bodies against their plain int8 versions in f32 (the scale
    fold in the TPU kernels' order), each timed back to back and as a
    CUDA-graph replay beside its bf16 yardstick over the dequantized K/V,
    with a bound over the codes and scales the data needs: GQA decode,
    prefill and ragged at `kernels`' D 128 G 3 shapes (each held row by
    row too and with the bf16 body's replay from `bf16_ms` {kernel: ms}
    beside it; prefill and ragged over spread_int8_pool pools), the
    gate_3b cases (I8_EDGES, untimed, with planted faults), the Gemma-2 case
    (window 4096, cap 50, scale 1/16) at D 256 G 2 (beside its bf16 row,
    `gemma_bf16` {"decode": record, ...}), MLA decode at its
    main-path shape; and kv_quantize on the card against the CPU's."""
    gen = torch.Generator(device="cpu").manual_seed(12)
    dgen = torch.Generator(device=dev).manual_seed(12)
    Hk, G, D, PS = 8, 3, 128, 16
    H = Hk * G
    scale = D ** -0.5
    torch.cuda.synchronize()
    mem = {"start": torch.cuda.memory_allocated()}
    out = {"kv_quantize": kv_quantize_check(dev)}

    def rnd(*shape):
        return torch.randn(*shape, generator=dgen, device=dev).bfloat16()

    def pools(NP, Hk, D):
        (kq, kd), (vq, vd) = int8_pool(rnd(NP, PS, Hk, D)), int8_pool(rnd(NP, PS, Hk, D))
        return (kq, vq), (kd, vd)

    # decode: `kernels`' rows, kv_len up to 4096, one empty row
    kv_list = [4096, 0, 1, 17, 1000, 2048, 3333, 513]
    B, MP = len(kv_list), 4096 // PS
    (kq, vq), (kd, vd) = pools(B * MP + 1, Hk, D)
    q = rnd(B, Hk, G, D)
    pt = random_pages(gen, B, MP, B * MP + 1, dev)
    kvl = torch.tensor(kv_list, dtype=torch.int32, device=dev)
    got = decode_paged_attention(q, kq, vq, pt, kvl)
    torch.cuda.synchronize()
    want = decode_paged_attention_ref(q.float(), kq, vq, pt, kvl)
    err = (got.float() - want).abs().max().item()
    rel = row_rel_err(got, want)
    check(torch.isfinite(got.float()).all().item(), "int8 decode output not finite")
    check(got[1].float().abs().max().item() == 0.0, "int8 decode kv_len=0 row is not 0")
    check(err <= KERNEL_TOL, f"int8 decode max abs err {err} > {KERNEL_TOL}")
    check(rel <= ROW_REL_TOL, f"int8 decode row error {rel} > {ROW_REL_TOL}")
    kdd, vdd = dense_kv(kd, pt, Hk, G), dense_kv(vd, pt, Hk, G)
    mask = (torch.arange(MP * PS, device=dev)[None, :] < kvl[:, None])[:, None, None, :]
    qd = q.reshape(B, H, 1, D)
    n_tok = sum(kv_list)
    out["decode_paged_attention_int8"] = dict(int8_record(
        lambda: decode_paged_attention(q, kq, vq, pt, kvl),
        lambda: decode_paged_attention_ref(q.float(), kq, vq, pt, kvl),
        lambda: F.scaled_dot_product_attention(qd, kdd, vdd, attn_mask=mask,
                                               scale=scale),
        2 * q.numel() * 2 + n_tok * Hk * kv_row_bytes(D, True)
        + sum(-(-k // PS) for k in kv_list) * 4 + B * 4,
        4 * n_tok * H * D, err), row_rel_err=rel,
        bf16_device_ms=bf16_ms.get("decode_paged_attention"),
        shape={"B": B, "Hk": Hk, "G": G, "D": D, "PS": PS, "kv_lens": kv_list})
    del kq, vq, kd, vd, kdd, vdd

    # prefill: S 512, q_len 450 over 700 prior tokens (padding rows after),
    # over pools whose scales spread over three decades
    S, prior, q_len = 512, 700, 450
    kv = prior + q_len
    MP = -(-kv // PS) + 2
    (kq, kd), (vq, vd) = (spread_int8_pool(rnd(MP + 1, PS, Hk, D), dgen) for _ in range(2))
    q = rnd(1, S, Hk, G, D)
    pt = random_pages(gen, 1, MP, MP + 1, dev)
    ints = [torch.tensor([x], dtype=torch.int32, device=dev) for x in (prior, q_len, kv)]
    got = prefill_paged_attention(q, kq, vq, pt, *ints)
    torch.cuda.synchronize()
    want = prefill_paged_attention_ref(q.float(), kq, vq, pt, *ints)
    err = (got[:, :q_len].float() - want[:, :q_len]).abs().max().item()
    rel = row_rel_err(got[:, :q_len], want[:, :q_len])
    check(torch.isfinite(got.float()).all().item(), "int8 prefill output not finite")
    check(got[:, q_len:].float().abs().max().item() == 0.0,
          "int8 prefill padding rows are not 0")
    check(err <= KERNEL_TOL, f"int8 prefill max abs err {err} > {KERNEL_TOL}")
    check(rel <= ROW_REL_TOL, f"int8 prefill row error {rel} > {ROW_REL_TOL}")
    kdd, vdd = dense_kv(kd, pt, Hk, G), dense_kv(vd, pt, Hk, G)
    s_pos = prior + torch.arange(S, device=dev)
    c_pos = torch.arange(MP * PS, device=dev)
    mask = ((c_pos[None, :] <= s_pos[:, None]) & (c_pos[None, :] < kv))[None, None]
    qd = q.reshape(1, S, H, D).transpose(1, 2)
    n_pairs = sum(min(prior + s + 1, kv) for s in range(q_len))
    out["prefill_paged_attention_int8"] = dict(int8_record(
        lambda: prefill_paged_attention(q, kq, vq, pt, *ints),
        lambda: prefill_paged_attention_ref(q.float(), kq, vq, pt, *ints),
        lambda: F.scaled_dot_product_attention(qd, kdd, vdd, attn_mask=mask,
                                               scale=scale),
        q_len * H * D * 2 + q.numel() * 2 + kv * Hk * kv_row_bytes(D, True)
        + (-(-kv // PS)) * 4 + 3 * 4,
        4 * n_pairs * H * D, err), row_rel_err=rel,
        bf16_device_ms=bf16_ms.get("prefill_paged_attention"),
        shape={"S": S, "prior": prior, "q_len": q_len})
    del kq, vq, kd, vd, kdd, vdd

    # ragged: the 264-token mixed step of 8 decode rows and 4 chunks
    segs = [(1, kv - 1) for kv in RAGGED_DECODE_KV] + RAGGED_CHUNKS
    args, md = ragged_inputs(gen, segs, RAGGED_T, Hk, G, D, PS, 4096 // PS, dev)
    (kq, kd), (vq, vd) = spread_int8_pool(args[1], dgen), spread_int8_pool(args[2], dgen)
    a8 = (args[0], kq, vq) + tuple(args[3:])
    got = ragged_paged_attention(*a8)
    torch.cuda.synchronize()
    want = ragged_paged_attention_ref(args[0].float(), kq, vq, *args[3:])
    n = sum(q_len for q_len, _ in segs)
    err = (got[:n].float() - want[:n]).abs().max().item()
    rel = row_rel_err(got[:n], want[:n])
    check(torch.isfinite(got.float()).all().item(), "int8 ragged output not finite")
    check(n == got.shape[0] or got[n:].float().abs().max().item() == 0.0,
          "int8 ragged tail rows are not 0")
    check(err <= KERNEL_TOL, f"int8 ragged max abs err {err} > {KERNEL_TOL}")
    check(rel <= ROW_REL_TOL, f"int8 ragged row error {rel} > {ROW_REL_TOL}")
    kv_tok = sum(q_len + p for q_len, p in segs)
    pairs = sum(p + i + 1 for q_len, p in segs for i in range(q_len))
    out["ragged_paged_attention_int8"] = dict(int8_record(
        lambda: ragged_paged_attention(*a8),
        lambda: ragged_paged_attention_ref(args[0].float(), kq, vq, *args[3:]),
        ragged_library((args[0], kd, vd) + tuple(args[3:]), segs, md, scale),
        n * H * D * 2 + RAGGED_T * H * D * 2 + kv_tok * Hk * kv_row_bytes(D, True)
        + sum(-(-(q_len + p) // PS) for q_len, p in segs) * 4
        + md["seg_kv_lens"].size * 4 + md["meta"].size * 4,
        4 * pairs * H * D, err), row_rel_err=rel,
        bf16_device_ms=bf16_ms.get("ragged_paged_attention"),
        shape={"T": RAGGED_T, "segments": segs})
    del args, a8, kq, vq, kd, vd

    # the gate at the 3B shape (untimed): decode rows at I8_DECODE_EDGES,
    # prefill chunks and ragged steps ending at I8_EDGES, over pools whose
    # scales spread over three decades, held row by row with gemma_case's
    # planted faults and int8_faults
    NP = 2 * len(I8_DECODE_EDGES) * GEMMA_MP + 1
    (kq, kd), (vq, vd) = (spread_int8_pool(rnd(NP, PS, Hk, D), dgen) for _ in range(2))
    out["gate_3b"] = {
        kernel: gemma_case(kernel, "int8_kernels gate_3b", (Hk, G, D),
                           (I8_DECODE_EDGES if kernel == "decode" else I8_EDGES, 0, 0.0,
                            None, 1.0), (kq, vq), (kq, vq), gen, dgen,
                           dev, lib_pools=(kd, vd), spread=True, timed=False)
        for kernel in ("decode", "prefill", "ragged")}
    del kq, vq, kd, vd
    torch.cuda.empty_cache()

    # the Gemma-2 case at D 256 G 2: the int8 window + soft-cap bodies
    Hk2, G2, D2 = GEMMA_SHAPES["D256_G2"]
    NP = 2 * len(GEMMA_EDGES) * GEMMA_MP + 1
    (kq, kd), (vq, vd) = (int8_pool(rnd(NP, PS, Hk2, D2)) for _ in range(2))
    out["gemma2_D256_G2"] = {
        kernel: dict(gemma_case(kernel, "int8_kernels gemma2", (Hk2, G2, D2),
                                GEMMA_CASES["gemma2"],
                                (kq, vq), (kq, vq), gen, dgen, dev, lib_pools=(kd, vd)),
                     bf16_device_ms=gemma_bf16[kernel]["device_ms"])
        for kernel in ("decode", "prefill", "ragged")}
    del kq, vq, kd, vd
    torch.cuda.empty_cache()

    # MLA decode: mla_kernels' decode rows at DeepSeek-V3's shapes, beside
    # the bf16 body's replay; the engine-shaped batch; then the gate
    dc, dr = MLA_DC, MLA_DR
    Dl = dc + dr
    mscale = attn_score_scale(MLA_CONFIG, MLA_CONFIG.qk_nope_head_dim + dr)
    q, lat, pt, kvl = mla_decode_args(gen, dev)
    lq, ld = int8_pool(lat)
    B, MP = len(MLA_DECODE_KV), pt.shape[1]
    got = decode_mla_attention(q, lq, pt, kvl, dc=dc, scale=mscale)
    torch.cuda.synchronize()
    want = decode_mla_attention_ref(q.float(), lq, pt, kvl, dc=dc, scale=mscale)
    err = (got.float() - want.float()).abs().max().item()
    rel = row_rel_err(got, want)
    check(torch.isfinite(got.float()).all().item(), "int8 MLA decode output not finite")
    check(got[1].float().abs().max().item() == 0.0, "int8 MLA decode kv_len=0 row is not 0")
    check(err <= KERNEL_TOL, f"int8 MLA decode max abs err {err} > {KERNEL_TOL}")
    check(rel <= ROW_REL_TOL, f"int8 MLA decode row error {rel} > {ROW_REL_TOL}")
    dense = ld[pt.long()].reshape(B, MP * MLA_PS, Dl)
    mask = (torch.arange(MP * MLA_PS, device=dev)[None, :] < kvl[:, None])[:, None, None, :]
    lib_fn, lib_name = mla_library(q[:, :, None], dense, mask, dc, mscale)
    out["decode_mla_attention_int8"] = dict(int8_record(
        lambda: decode_mla_attention(q, lq, pt, kvl, dc=dc, scale=mscale),
        lambda: decode_mla_attention_ref(q.float(), lq, pt, kvl, dc=dc, scale=mscale),
        lib_fn, mla_int8_bytes(MLA_DECODE_KV), mla_decode_flops(MLA_DECODE_KV), err),
        row_rel_err=rel, library=lib_name,
        bf16_device_ms=bf16_ms.get("decode_mla_attention"),
        shape={"B": B, "H": MLA_H, "dc": dc, "dr": dr, "PS": MLA_PS,
               "kv_lens": MLA_DECODE_KV, "split": MLA_INT8_SPLIT_TOKENS})
    del q, lat, lq, ld, dense, want
    # the engine-shaped batch: workload()'s prompts and 16 output tokens,
    # int8 beside the bf16 body on the latent it was quantized from
    q, lat, pt, kvl = mla_decode_args(gen, dev, MLA_ENGINE_KV)
    lq, _ = int8_pool(lat)
    got = decode_mla_attention(q, lq, pt, kvl, dc=dc, scale=mscale)
    torch.cuda.synchronize()
    want = decode_mla_attention_ref(q.float(), lq, pt, kvl, dc=dc, scale=mscale)
    err = (got.float() - want.float()).abs().max().item()
    rel = row_rel_err(got, want)
    check(err <= KERNEL_TOL and rel <= ROW_REL_TOL,
          f"int8 MLA decode, engine shape: max abs err {err}, row error {rel}")
    b_ms, b_by = bound(mla_int8_bytes(MLA_ENGINE_KV), mla_decode_flops(MLA_ENGINE_KV))
    out["decode_mla_attention_int8"]["engine_shape"] = {
        "kv_lens": MLA_ENGINE_KV, "max_abs_err": err, "row_rel_err": rel,
        "device_ms": graph_ms(lambda: decode_mla_attention(q, lq, pt, kvl, dc=dc,
                                                           scale=mscale)),
        "bf16_device_ms": graph_ms(lambda: decode_mla_attention(q, lat, pt, kvl, dc=dc,
                                                                scale=mscale)),
        "bound_ms": b_ms, "bound_by": b_by}
    del q, lat, lq, want
    out["decode_mla_attention_int8"]["gate"] = mla_int8_gate(gen, dev, mscale)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    mem["end"] = torch.cuda.memory_allocated()
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
        mem["after_clearing_cublas_workspaces"] = torch.cuda.memory_allocated()
    emit({"phase": "int8_kernels", "tol": KERNEL_TOL, "memory_allocated_bytes": mem,
          **out})
    return out


# head_shape_kernels: the head shapes (Hk, G, D) of qwen2.5-7b (G 7),
# phi-3-mini-4k (D 96, MHA, a 2047-token window on every layer) and
# llama-3.2-1b (D 64), each with a gemma_kernels case (contexts, window,
# softcap, scale, query scale): decode rows at the contexts (and an empty
# row), prefill chunks of up to 512 tokens ending there, and a ragged step
# of a decode row and a 48-token chunk at each. qwen2.5-7b and
# llama-3.2-1b: `kernels`' decode contexts; phi-3: contexts around the
# window's edge, whose chunks straddle it, and gemma_kernels' 7-token
# window, whose edge moves O(1) outputs
HEAD_SHAPES = {
    "qwen2_G7_D128": ((4, 7, 128), ([4096, 1, 17, 1000, 2048, 3333, 513],
                                    0, 0.0, None, 1.0)),
    "phi3_G1_D96": ((32, 1, 96), ([1, 2046, 2047, 2048, 2049, 4000],
                                  2047, 0.0, None, 1.0)),
    "phi3_G1_D96_window_7": ((32, 1, 96), GEMMA_CASES["window_7"]),
    "llama1b_G4_D64": ((8, 4, 64), ([4096, 1, 17, 1000, 2048, 3333, 513],
                                    0, 0.0, None, 1.0)),
}


def head_shape_kernels_phase(dev):
    """The three GQA kernels at HEAD_SHAPES, bf16 and int8 (the pools
    quantized; the yardstick over them dequantized beforehand), each
    against its plain version in f32 (gemma_case: KERNEL_TOL, ROW_REL_TOL
    and the planted faults) and timed back to back, as a CUDA-graph replay
    and beside the plain version and SDPA, with the bound over what the
    data needs."""
    gen = torch.Generator(device="cpu").manual_seed(17)
    dgen = torch.Generator(device=dev).manual_seed(17)
    out = {}
    for shape, (heads, case) in HEAD_SHAPES.items():
        Hk, G, D = heads
        NP = 2 * len(case[0]) * GEMMA_MP + 1
        bf = tuple(torch.randn(NP, PAGE_SIZE, Hk, D, generator=dgen,
                               device=dev).bfloat16() for _ in range(2))
        rec = {"Hk": Hk, "G": G, "D": D, "smem_bytes": gqa_smem_bytes(D),
               "contexts": case[0], "window": case[1]}
        for kind in ("bf16", "int8"):
            if kind == "bf16":
                pools, pools32, lib = bf, tuple(x.float() for x in bf), None
            else:
                (kq, kd), (vq, vd) = int8_pool(bf[0]), int8_pool(bf[1])
                pools = pools32 = (kq, vq)
                lib = (kd, vd)
            rec[kind] = {kernel: gemma_case(kernel, f"head_shape_kernels {shape} {kind}",
                                            heads, case, pools, pools32, gen, dgen, dev,
                                            lib_pools=lib)
                         for kernel in ("decode", "prefill", "ragged")}
            del pools, pools32, lib
            torch.cuda.empty_cache()
        for kernel, r in rec["int8"].items():  # each int8 row beside its bf16 row
            r["bf16_device_ms"] = rec["bf16"][kernel]["device_ms"]
        out[shape] = rec
        del bf
        torch.cuda.empty_cache()
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    emit({"phase": "head_shape_kernels", "tol": KERNEL_TOL, "row_tol": ROW_REL_TOL,
          **out})
    return out


def gemma_phases(dev, smi):
    """gemma-2-9b at full width and depth: `engine_gemma2` (the card's
    default, fused: ragged and decode kernels; a prefill chunk with no
    decode row on the prefill kernel) and `engine_gemma2_unfused`
    (DYN_FUSED_MIXED=0: prefill and decode kernels) on one runner, each
    request finishing `length`, each kernel's launches equal to its
    passes x 42, half of them on the window bodies; then `parity_gemma2`,
    a 4700- and a 4500-token sequence prefilled in 512-token chunks, two
    decode steps and a ragged step with a chunk past the window."""
    runner, cfg, build_s = timed_runner(GEMMA_ARGS)
    L = cfg.n_layers
    check(runner.kv_page_shape == (L, PAGE_SIZE, cfg.n_kv_heads, cfg.head_dim),
          f"engine_gemma2: page shape {runner.kv_page_shape}")
    sliding = sum(1 for l in range(L) if l % cfg.sw_period != cfg.sw_global_residue)
    found = {}

    def turn(runner, phase, fused, args):
        # sliding layers launch the window bodies, global layers the others
        body = f"D{cfg.head_dim}" + ("_int8" if runner.kv_quantize else "") + "_softcap"
        win = body.replace("_softcap", "_window_softcap")

        def expect(n):
            return {k: v for k, v in ((win, n // L * sliding),
                                      (body, n - n // L * sliding)) if v}

        rec, _ = served_turn(runner, phase, fused, args, expect, extra=GEMMA_LONG_PROMPTS,
                             build_s=build_s if phase == "gemma2" else None)
        check(max(rec["prompt_tokens"]) > GEMMA_WINDOW,
              f"{phase}: no request ran past the window")
        rec["config"] = {k: getattr(cfg, k) for k in (
            "name", "dim", "n_layers", "n_heads", "n_kv_heads", "head_dim",
            "ffn_dim", "vocab_size", "sliding_window", "attn_logit_softcap",
            "final_logit_softcap", "query_pre_attn_scalar")}
        rec["nvidia_smi"] = smi
        found[phase] = rec["bodies"]
        emit(rec)

    turn(runner, "gemma2", None, GEMMA_ARGS)
    turn(runner, "gemma2_unfused", False, GEMMA_ARGS)
    parity_phase(runner, dev, phase="parity_gemma2", lens=(4700, 180, 4500),
                 S=512, MP=300, NP=960)
    # the int8 turn: the same params over int8 pools (the bf16 pools freed)
    params = runner.params
    free(runner)
    args8 = GEMMA_ARGS + ["--kv-quantize", "int8"]
    runner8, _, _ = timed_runner(args8, params=params)
    turn(runner8, "gemma2_int8", None, args8)
    free(runner8)
    return found


CONFIG_FIELDS = ("name", "dim", "n_layers", "n_heads", "n_kv_heads", "head_dim",
                 "ffn_dim", "vocab_size", "sliding_window", "sw_period",
                 "attn_bias", "qk_norm", "qk_norm_wide", "pre_norms", "post_norms",
                 "embed_multiplier", "residual_multiplier", "attn_scale",
                 "logits_divider", "act", "norm_zero_centered", "n_experts",
                 "n_experts_active", "moe_ffn_dim")


def family_turn(runner, phase, fused, args, body, smi, extra=(), build_s=None):
    """served_turn with every launch on `body`, the config and the card
    recorded; with `extra` prompts, one must run past the window. Returns
    (bodies, launches)."""
    rec, launches = served_turn(runner, phase, fused, args, one_body(body),
                                extra=extra, build_s=build_s)
    cfg = runner.config
    if extra and cfg.sliding_window:
        check(max(rec["prompt_tokens"]) > cfg.sliding_window,
              f"{phase}: no request ran past the window")
    rec["config"] = {k: getattr(cfg, k) for k in CONFIG_FIELDS}
    rec["nvidia_smi"] = smi
    emit(rec)
    return rec["bodies"], launches


# qwen2.5-7b: 28 layers, 28 query heads over 4 KV heads (G 7), q/k/v biases
QWEN2_ARGS = model_args("qwen2.5-7b")
# phi-3-mini-4k: 32 layers, MHA at head dim 96, a 2047-token window on every
# layer; two prompts past the window
PHI3_ARGS = model_args("phi-3-mini-4k")
PHI3_LONG_PROMPTS = (2600, 3900)


def qwen2_phases(dev, smi):
    """`engine_qwen2` (fused) and `engine_qwen2_unfused` on one runner
    whose q/k/v biases are drawn non-zero (k's larger, as in Qwen2.5
    checkpoints): every request `length`, launches = passes x 28, all on
    D128 (G 7); then `parity_qwen2`. Returns the fused launches and both
    phases' bodies."""
    runner, cfg, build_s = timed_runner(QWEN2_ARGS)
    check(cfg.n_heads // cfg.n_kv_heads == 7 and cfg.attn_bias,
          f"engine_qwen2: not qwen2.5-7b's heads: {cfg}")
    g = torch.Generator(device=dev).manual_seed(5)
    for name, std in (("bq", 0.5), ("bk", 2.0), ("bv", 0.5)):
        b = runner.params["layers"][name]
        b.copy_(torch.randn(b.shape, generator=g, device=dev) * std)
    found, fused_launches = {}, None
    for phase, fused in (("qwen2", None), ("qwen2_unfused", False)):
        found[phase], launches = family_turn(
            runner, phase, fused, QWEN2_ARGS, "D128", smi,
            build_s=build_s if fused is None else None)
        fused_launches = fused_launches or launches
    parity_phase(runner, dev, phase="parity_qwen2")
    free(runner)
    return fused_launches, found


def phi3_phases(dev, smi):
    """`engine_phi3` (fused), `engine_phi3_unfused` and, on the same params
    over int8 pools, `engine_phi3_int8`: the 3B's traffic and two prompts
    past the 2047-token window, every request `length`, launches = passes
    x 32, all on D96_window (int8: D96_int8_window); between them
    `parity_phi3`, a 2600- and a 2300-token sequence prefilled in 512-token
    chunks, two decode steps and a ragged step, all past the window.
    Returns the fused bf16 and int8 launches and every phase's bodies."""
    runner, cfg, build_s = timed_runner(PHI3_ARGS)
    check(cfg.head_dim == 96 and cfg.n_heads == cfg.n_kv_heads
          and {layer_window(cfg, l) for l in range(cfg.n_layers)} == {2047},
          f"engine_phi3: not phi-3's heads and window: {cfg}")
    found, fused_launches = {}, None
    for phase, fused in (("phi3", None), ("phi3_unfused", False)):
        found[phase], launches = family_turn(
            runner, phase, fused, PHI3_ARGS, "D96_window", smi,
            extra=PHI3_LONG_PROMPTS, build_s=build_s if fused is None else None)
        fused_launches = fused_launches or launches
    parity_phase(runner, dev, phase="parity_phi3", lens=(2600, 180, 2300), S=512,
                 MP=170, NP=520)
    params = runner.params
    free(runner)
    args8 = model_args("phi-3-mini-4k", kv_quantize=True)
    runner8, _, _ = timed_runner(args8, params=params)
    found["phi3_int8"], int8_launches = family_turn(
        runner8, "phi3_int8", None, args8, "D96_int8_window", smi,
        extra=PHI3_LONG_PROMPTS)
    free(runner8)
    return fused_launches, int8_launches, found


# the other dense families, one fused turn each at full width and depth:
# (preset, max_seq_len, prompts added to the 3B's, the body every launch
# takes, int8 pools). Mistral's prompts run past its 4096-token window;
# llama-3.2-1b (16 layers, Hk 8, G 4) is the card's path through the D 64
# bodies, over int8 pools
FAMILIES = {
    "qwen3": ("qwen3-8b", 4096, (), "D128", False),
    "mistral": ("mistral-7b", 8192, (4600, 5200), "D128_window", False),
    "gemma7b": ("gemma-7b", 4096, (), "D256", False),
    "olmo2": ("olmo-2-7b", 4096, (), "D128", False),
    "granite": ("granite-3.1-8b", 4096, (), "D128", False),
    "llama1b_int8": ("llama-3.2-1b", 4096, (), "D64_int8", True),
}


def families_phase(dev, smi):
    """Each of FAMILIES in turn, random weights freed before the next:
    `engine_<family>` (fused) and `parity_<family>`. Returns the bodies."""
    found = {}
    for fam, (model, max_seq_len, extra, body, int8) in FAMILIES.items():
        args = model_args(model, max_seq_len, kv_quantize=int8)
        runner, _, build_s = timed_runner(args)
        found[fam], _ = family_turn(runner, fam, None, args, body, smi, extra=extra,
                                    build_s=build_s)
        parity_phase(runner, dev, phase=f"parity_{fam}")
        free(runner)
    return found


# -- MoE: the grouped GEMM and the MoE models ---------------------------------

# the grouped GEMM's cases: each model's (E, F, n_experts, k) and the
# tokens a step gives it: a decode batch of 8, the fused ragged step (T
# 264) and a 512-token chunk
MOE_SHAPES = {"qwen3-30b-a3b": ((2048, 768, 128, 8), (8, 264, 512)),
              "deepseek-v3": ((7168, 2048, 256, 8), (8, 512))}
MOE_ROUTINGS = ("uniform", "skewed")
# the kernels line's case: qwen3-30b-a3b's fused step, uniform routing
MOE_HEAD = ("qwen3-30b-a3b", 264, "uniform")
# x's RMS in the kernel cases held to KERNEL_TOL: a quarter of a normed
# hidden state's. With the init's 1/sqrt(fan_in) weights, g and u then have
# an RMS of about 0.25 and h and y about 0.03, so KERNEL_TOL is about a
# typical output there and the max-abs limit is nominal: the row gates
# (ROW_REL_TOL, each row against its own scale) carry the check. At RMS
# 0.5 the reference's bf16 roundings of the largest outputs already reach
# 0.0314 on an H100 (PERF.md §6, the grouped GEMM), so no max-abs limit
# holds at the engine's scale; MOE_RMS1_CASES run there, at the RMS 1 of
# the engine's normed x, held by the row gates alone
MOE_X_RMS = 0.25
MOE_RMS1_CASES = (("qwen3-30b-a3b", 264, "uniform"), ("deepseek-v3", 8, "uniform"))


def moe_routing(gen, T, k, n, how):
    """sel [T, k]: `uniform`, k distinct experts a token drawn uniformly;
    `skewed`, half the pairs on expert 0 and the rest on experts 1 to
    n/2 - 1, so that the upper half of the experts gets no row (padding
    tokens of a bucket all route alike; the kernel takes any sel)."""
    if how == "uniform":
        return torch.rand(T, n, generator=gen).topk(k, dim=-1).indices
    pick = torch.randint(1, n // 2, (T, k), generator=gen)
    return torch.where(torch.rand(T, k, generator=gen) < 0.5, 0, pick)


def row_errs(got, want, scale=None):
    """The grouped GEMM's row errors: over the rows (the last dim), the max
    of each row's max abs error against `want` divided by the row's RMS
    (row_rel_err's form), and divided by the row's max abs value, both taken in
    `scale` (default `want`; a planted fault is read against the right
    rows' scale). A row with no error reads 0."""
    want = want.float()
    scale = want if scale is None else scale.float()
    err = (got.float() - want).abs().amax(-1)

    def form(den):
        return torch.where(err == 0, 0.0, err / den).max().item()

    return {"rms": form(scale.square().mean(-1).sqrt()),
            "max": form(scale.abs().amax(-1))}


def skipped_rows(a, r0, r1, skip):
    """The rows of a [r1 - r0, K] that skip = (s0, s1, k0) covers, as
    (first, end) in a's rows, with the K slice k0 .. k0 + MOE_BK zeroed:
    a ring stage the kernel skipped (None where the spans miss)."""
    if skip is None:
        return None
    s0, s1, k0 = skip
    lo, hi = max(r0, s0), min(r1, s1)
    if lo >= hi:
        return None
    part = a[lo - r0:hi - r0].clone()
    part[:, k0:k0 + md.MOE_BK] = 0
    return lo, hi, part


def gate_up_plain32(x, tok, wg, wu, tiles, wrong_row=None, skip=None):
    """moe_gate_up's plain version in f32 from the bf16 operands, expert by
    expert (each expert's weights converted on their own: V3's in f32
    would be 15 GB). wrong_row plants a fault: that row computed with the
    next expert's weights; skip = (first row, end row, k0) another: those
    rows with the 64-deep K slice from k0 left out of both sums."""
    n = wg.shape[0]
    h = torch.zeros(tok.shape[0], wg.shape[-1], device=x.device)
    for e, r0, r1 in md.expert_rows(tiles):
        xr = x[tok[r0:r1].long()].float()
        h[r0:r1] = F.silu(xr @ wg[e].float()) * (xr @ wu[e].float())
        if wrong_row is not None and r0 <= wrong_row < r1:
            xw, f = xr[wrong_row - r0], (e + 1) % n
            h[wrong_row] = F.silu(xw @ wg[f].float()) * (xw @ wu[f].float())
        part = skipped_rows(xr, r0, r1, skip)
        if part is not None:
            lo, hi, xs = part
            h[lo:hi] = F.silu(xs @ wg[e].float()) * (xs @ wu[e].float())
    return h


def down_plain32(h, wd, tiles, wrong_row=None, skip=None):
    """moe_down's plain version in f32 (and its two faults)."""
    n = wd.shape[0]
    y = torch.zeros(h.shape[0], wd.shape[-1], device=h.device)
    for e, r0, r1 in md.expert_rows(tiles):
        hr = h[r0:r1].float()
        y[r0:r1] = hr @ wd[e].float()
        if wrong_row is not None and r0 <= wrong_row < r1:
            y[wrong_row] = h[wrong_row].float() @ wd[(e + 1) % n].float()
        part = skipped_rows(hr, r0, r1, skip)
        if part is not None:
            lo, hi, hs = part
            y[lo:hi] = hs @ wd[e].float()
    return y


def moe_case(what, x, sel, wg, wu, wd, k, abs_gate=True):
    """Both grouped-GEMM entries on one routing, against their plain
    versions in f32: max abs error (held to KERNEL_TOL with `abs_gate`), the row errors over the row's RMS
    (row_rel_err's form) and over the row's max abs value, the planted faults
    (a pair on the wrong expert, the last tile dropped, the last tile's
    middle 64-deep K slice left out: a ring stage skipped), times (b2b and
    CUDA-graph replay) beside the plain version (the per-expert
    torch.matmul loop), the dense every-expert form (the reference's) and
    torch._grouped_mm where the card's torch has it, and the bound."""
    dev = x.device
    T, E = x.shape
    n, _, F_ = wg.shape
    r = md.route(sel.to(dev), n)
    h = md.moe_gate_up(x, r.tok, wg, wu, r.tiles)
    y = md.moe_down(h, wd, r.tiles)
    torch.cuda.synchronize()
    live = [t for t in r.tiles.tolist() if t[0] >= 0]
    counts = torch.bincount(sel.reshape(-1), minlength=n)
    touched = int((counts > 0).sum())
    P = T * k
    # the faults: the first row of the last expert with rows on the next
    # expert's weights; the rows of the last tile left 0; the last tile's
    # rows without the middle 64-deep K slice of their sums
    wrong = md.expert_rows(r.tiles)[-1][1]
    last0, last1 = live[-1][1], live[-1][2]
    out = {"routing": what, "T": T, "pairs": P, "touched_experts": touched,
           "x_rms": x.float().square().mean().sqrt().item(), "abs_gated": abs_gate,
           "tiles": len(live), "grid_tiles": r.tiles.shape[0],
           "max_rows_an_expert": int(counts.max())}
    entries = {
        "moe_gate_up": (h, lambda wr=None, sk=None: gate_up_plain32(
            x, r.tok, wg, wu, r.tiles, wr, sk), "max", E),
        "moe_down": (y, lambda wr=None, sk=None: down_plain32(h, wd, r.tiles, wr, sk),
                     "rms", F_),  # each with its K: the skipped stage's depth
    }
    for name, (got, plain, gate, K) in entries.items():
        want = plain()
        check(torch.isfinite(got.float()).all().item(), f"{name} {what}: not finite")
        err = (got.float() - want).abs().max().item()
        rel = row_errs(got, want)
        dropped = want.clone()
        dropped[last0:last1] = 0
        k_mid = K // md.MOE_BK // 2 * md.MOE_BK
        faults = {"wrong_expert": plain(wrong), "dropped_tile": dropped,
                  "skipped_stage": plain(sk=(last0, last1, k_mid))}
        fault_rel = {f: row_errs(got, w, want)[gate] for f, w in faults.items()}
        out[name] = {"max_abs_err": err, "row_rel_err_rms": rel["rms"],
                     "row_rel_err_max": rel["max"], "row_gate": gate,
                     "planted_faults": fault_rel}
    # bounds: the touched experts' weights, each input row read once and
    # each output row written once, the maps; or the FLOPs
    maps = P * 4 + r.tiles.numel() * 4
    gu_bytes = touched * 2 * E * F_ * 2 + T * E * 2 + P * F_ * 2 + maps
    dn_bytes = touched * F_ * E * 2 + P * F_ * 2 + P * E * 2 + r.tiles.numel() * 4
    bounds = {"moe_gate_up": bound(gu_bytes, 2 * P * E * F_ * 2),
              "moe_down": bound(dn_bytes, 2 * P * F_ * E)}
    # yardsticks: the dense every-expert form over all n experts, and
    # torch._grouped_mm over the sorted rows (x gathered, h as it is)
    h_dense = F.silu(torch.matmul(x, wg)) * torch.matmul(x, wu)
    calls = {
        "moe_gate_up": (lambda: md.moe_gate_up(x, r.tok, wg, wu, r.tiles),
                        lambda: md.moe_gate_up_ref(x, r.tok, wg, wu, r.tiles),
                        lambda: F.silu(torch.matmul(x, wg)) * torch.matmul(x, wu)),
        "moe_down": (lambda: md.moe_down(h, wd, r.tiles),
                     lambda: md.moe_down_ref(h, wd, r.tiles),
                     lambda: torch.matmul(h_dense, wd)),
    }
    offs = torch.cumsum(counts, 0).to(torch.int32).to(dev)
    xs = x[r.tok.long()]
    grouped = {"moe_gate_up": lambda: (torch._grouped_mm(xs, wg, offs=offs),
                                       torch._grouped_mm(xs, wu, offs=offs)),
               "moe_down": lambda: torch._grouped_mm(h, wd, offs=offs)}
    for name, (kern, plain, dense) in calls.items():
        bms, by = bounds[name]
        rec = out[name]
        rec.update({"ms": cuda_ms(kern), "device_ms": graph_ms(kern),
                    "plain_ms": cuda_ms(plain, iters=5, warmup=1),
                    "bound_ms": bms, "bound_by": by,
                    "dense_ms": cuda_ms(dense, iters=5, warmup=1),
                    "dense_device_ms": graph_ms(dense, iters=5, replays=2)})
        try:
            rec["grouped_mm_ms"] = cuda_ms(grouped[name])
            rec["grouped_mm_device_ms"] = graph_ms(grouped[name])
        except (AttributeError, RuntimeError) as e:  # a yardstick only
            rec["grouped_mm_ms"] = rec["grouped_mm_device_ms"] = None
            rec["grouped_mm_error"] = str(e)[:200]
        rec["device_ms_over_bound"] = rec["device_ms"] / bms
    del h_dense, xs
    emit({"phase": "moe_case", **out})
    for name in MOE_KERNELS:  # the checks, after the record is out
        rec = out[name]
        err, gate = rec["max_abs_err"], rec["row_gate"]
        rel = rec[f"row_rel_err_{gate}"]
        check(not abs_gate or err <= KERNEL_TOL,
              f"{name} {what}: max abs err {err} > {KERNEL_TOL}")
        check(rel <= ROW_REL_TOL,
              f"{name} {what}: row error {rel} ({gate} form) > {ROW_REL_TOL}")
        for f, v in rec["planted_faults"].items():
            check(v > ROW_REL_TOL, f"{name} {what}: the planted {f} reads {v}, "
                  f"under {ROW_REL_TOL}")
    return out


def moe_sync_check(x, wg, wu, wd, k, dev):
    """One moe_block (routing, both entries, the combine) on CUDA tensors
    under torch.cuda.set_sync_debug_mode("error"): any host sync raises.
    Its output beside the every-expert path's (information)."""
    cfg = get_config("qwen3-30b-a3b")
    gen = torch.Generator(device=dev).manual_seed(7)
    E, n = wg.shape[1], wg.shape[0]
    lp = {"w_router": (torch.randn(E, n, generator=gen, device=dev) * E ** -0.5
                       ).bfloat16(),
          "we_gate": wg, "we_up": wu, "we_down": wd}
    xb = x[None]
    torch.cuda.synchronize()
    before = md.moe_gate_up.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        y = moe_model.moe_block(cfg, lp, xb, "kernel")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    check(md.moe_gate_up.launches == before + 1, "moe_block did not launch the kernel")
    ref = moe_model.moe_block(cfg, lp, xb, "ref")
    return {"T": x.shape[0], "host_syncs": 0,
            "vs_every_expert_max_abs": (y.float() - ref.float()).abs().max().item(),
            "vs_every_expert_row_errs": row_errs(y[0], ref[0])}


def moe_kernels_phase(dev):
    """Both grouped-GEMM entries at qwen3-30b-a3b's and DeepSeek-V3's
    expert shapes, random bf16 weights at the init's scale, each T of
    MOE_SHAPES under each routing of MOE_ROUTINGS at x RMS MOE_X_RMS, and
    MOE_RMS1_CASES again at x RMS 1 (row gates alone); then the sync
    check. Returns the kernels line's records (MOE_HEAD's case; its
    max_abs_err the largest of the cases held to KERNEL_TOL)."""
    lib = _build.load()["moe_grouped_gemm"]
    check(lib.moe_tile_rows() == md.MOE_BM,
          f"grouped GEMM tiles of {lib.moe_tile_rows()} rows, route's {md.MOE_BM}")
    gen = torch.Generator(device="cpu").manual_seed(11)
    dgen = torch.Generator(device=dev).manual_seed(11)
    cases, rms1, head, sync = [], [], {}, None
    for model, ((E, F_, n, k), Ts) in MOE_SHAPES.items():
        def w(*shape):
            return torch.randn(shape, generator=dgen, device=dev,
                               dtype=torch.bfloat16).mul_(shape[-2] ** -0.5)
        wg, wu, wd = w(n, E, F_), w(n, E, F_), w(n, F_, E)
        for T in Ts:
            x = (torch.randn(T, E, generator=dgen, device=dev) * MOE_X_RMS).bfloat16()
            for how in MOE_ROUTINGS:
                rec = moe_case(f"{model} T {T} {how}", x,
                               moe_routing(gen, T, k, n, how), wg, wu, wd, k)
                rec.update(model=model, routing=how)
                cases.append(rec)
                if (model, T, how) == MOE_HEAD:
                    head = rec
            if (model, T) == MOE_HEAD[:2]:
                sync = moe_sync_check(x, wg, wu, wd, k, dev)
            for how in (h for m, t, h in MOE_RMS1_CASES if (m, t) == (model, T)):
                x1 = (x.float() / MOE_X_RMS).bfloat16()
                rec = moe_case(f"{model} T {T} {how} x RMS 1", x1,
                               moe_routing(gen, T, k, n, how), wg, wu, wd, k,
                               abs_gate=False)
                rec.update(model=model, routing=how)
                rms1.append(rec)
        del wg, wu, wd
        gc.collect()
        torch.cuda.empty_cache()
    # each entry's registers and spills in both configurations, 128 x 128
    # and 64 x 64 items (ptxas -v, when built in this run)
    ents = ptxas_entries(_build.build_log.get("moe_grouped_gemm", ""))
    ptxas = {name: {cfg: ents.get(f"moe_gemm_kernel<{gated},{small}>")
                    for cfg, small in (("128x128", 0), ("64x64", 1))}
             for name, gated in zip(MOE_KERNELS, (1, 0))}
    emit({"phase": "moe_kernels", "tol": KERNEL_TOL, "row_tol": ROW_REL_TOL,
          "x_rms": MOE_X_RMS, "tile_rows": md.MOE_BM, "ptxas": ptxas,
          "sync_check": sync,
          "cases": [{k: c[k] for k in ("model", "T", "routing")} for c in cases],
          "row_gated_only_at_x_rms_1": [{k: c[k] for k in ("model", "T", "routing")}
                                        for c in rms1]})
    out = {}
    for name in MOE_KERNELS:
        rec = dict(head[name])
        rec["max_abs_err"] = max(c[name]["max_abs_err"] for c in cases)
        # torch._grouped_mm computes moe_down in one call; gate/up takes two
        # and the SwiGLU besides, so it has no one-call yardstick
        rec["library_ms"] = rec["grouped_mm_ms"] if name == "moe_down" else None
        rec["case"] = {"model": MOE_HEAD[0], "T": MOE_HEAD[1], "routing": MOE_HEAD[2]}
        out[name] = rec
    return out


class record_selections:
    """Within it, every moe_block's routing (weights, top-k ids) is kept in
    call order (parity_phase's `moe_sels`: each step runs the kernel path's
    layers, then the plain path's). With `pin`, the plain path's block l
    takes the kernel path's routing of block l instead of its own, so the
    two paths compute the same experts and differ only in arithmetic."""

    def __init__(self, moe_layers: int, pin: bool = False):
        self.moe_layers, self.pin = moe_layers, pin

    def __enter__(self):
        self.sels, self._orig = [], moe_model.router_topk
        routes = []

        def recording(*a, **kw):
            weights, sel = self._orig(*a, **kw)
            i = len(routes) % (2 * self.moe_layers)
            if self.pin and i >= self.moe_layers:  # the plain path
                weights, sel = routes[-self.moe_layers]
            routes.append((weights, sel))
            self.sels.append(sel)
            return weights, sel

        moe_model.router_topk = recording
        return self.sels

    def __exit__(self, *exc):
        moe_model.router_topk = self._orig


def selection_flips(sels, n_paths: int, moe_layers: int, real):
    """The top-k choices of the kernel path (the first of parity_phase's
    paths) that the plain path (the second) did not make, over every
    step's MoE layers, at the step's real tokens (`real`, one mask a step;
    padding tokens are routed too, on other attention outputs in each
    path): each path's forward runs its layers in turn, the paths one
    after the other."""
    chunks = [sels[i:i + moe_layers] for i in range(0, len(sels), moe_layers)]
    check(len(chunks) == n_paths * len(real),
          f"{len(chunks)} MoE forwards recorded for {len(real)} steps")
    choices = differ = tokens = token_layers = 0
    for step, mask in enumerate(real):
        i = step * n_paths
        for a, b in zip(chunks[i], chunks[i + 1]):
            a, b = a[mask.to(a.device)], b[mask.to(b.device)]
            same = (a[..., :, None] == b[..., None, :]).any(-1)
            choices += a.numel()
            differ += int((~same).sum())
            tokens += int((~same).any(-1).sum())
            token_layers += a.shape[0]
    return {"choices": choices, "choices_differing": differ,
            "token_layers": token_layers, "token_layers_differing": tokens}


def moe_parity(runner, dev, phase, **kw):
    """parity_phase on a MoE model three times: `<phase>_free`, each path
    routing on its own logits (information: a top-k choice near a tie
    flips between paths that differ in bf16 rounding, and a flipped
    expert moves the token's output by its whole weight), then `<phase>`,
    the plain path on the kernel path's routing, held to FORWARD_REL_TOL.
    Both report the choices that differ (0 when pinned). Last,
    `repeat_<model>`: the kernel path twice, held to equal logits."""
    with record_selections(runner.moe_layers) as sels:
        parity_phase(runner, dev, phase=f"{phase}_free", moe_sels=sels, gate=False,
                     **kw)
    with record_selections(runner.moe_layers, pin=True) as sels:
        parity_phase(runner, dev, phase=phase, moe_sels=sels, **kw)
    parity_phase(runner, dev, phase=phase.replace("parity", "repeat"),
                 against="kernel", **kw)


# qwen3-30b-a3b: 48 MoE layers (128 experts, top 8, width 768), 32 / 4 heads
# (G 8) at D 128 with qk-norm; 61 GB of bf16 weights: the card to itself
QWEN3MOE_ARGS = model_args("qwen3-30b-a3b")


def qwen3moe_phases(dev, smi):
    """`engine_qwen3moe` (fused) and `engine_qwen3moe_unfused` on one
    runner at full width and depth: every request `length`, each GQA
    kernel's launches = passes x 48 on D128 (G 8), each grouped-GEMM
    entry's = passes x 48; then `parity_qwen3moe` with the top-k choices
    that differ between the paths. Returns the fused launches and the
    phases' bodies."""
    runner, cfg, build_s = timed_runner(QWEN3MOE_ARGS)
    check(cfg.n_heads // cfg.n_kv_heads == 8 and runner.moe_layers == 48,
          f"engine_qwen3moe: not qwen3-30b-a3b's heads and experts: {cfg}")
    found, fused_launches = {}, None
    for phase, fused in (("qwen3moe", None), ("qwen3moe_unfused", False)):
        found[phase], launches = family_turn(
            runner, phase, fused, QWEN3MOE_ARGS, "D128", smi,
            build_s=build_s if fused is None else None)
        check(launches["moe_gate_up"] > 0, f"{phase}: the grouped GEMM never ran")
        fused_launches = fused_launches or launches
    moe_parity(runner, dev, "parity_qwen3moe")
    free(runner)
    return fused_launches, found


def mla_moe_phases(dev, smi):
    """DeepSeek-V3's three dense layers and its first MoE layer at full
    width (256 experts, sigmoid gates with the selection bias, 8 groups
    keeping 4, routed scale 2.5, one shared expert): `engine_mla_moe` on
    the padded fallback (MLA launches = passes x 4, grouped GEMM = passes
    x 1 each) and `parity_mla_moe`."""
    cfg = MLA_MOE_CONFIG
    t0 = time.monotonic()
    runner = ModelRunner(cfg, num_pages=2048, page_size=PAGE_SIZE,
                         max_pages_per_seq=4096 // PAGE_SIZE)
    torch.cuda.synchronize()
    build_s = time.monotonic() - t0
    check(runner.moe_layers == 1 and "layers_dense" in runner.params,
          f"engine_mla_moe: {runner.moe_layers} MoE layers")
    # the selection bias drawn away from 0, so that it moves the choice
    g = torch.Generator(device=dev).manual_seed(6)
    bias = runner.params["layers"]["router_bias"]
    bias.copy_(torch.randn(bias.shape, generator=g, device=dev) * 0.01)
    rec, launches, results = engine_phase(runner, "mla_moe", build_s=build_s)
    st = rec["stats"]
    check(rec["fused_mixed"], "engine_mla_moe: the engine did not fuse on the card")
    check(st["padded_prefill_dispatches"] > 0 and st["ragged_mixed_dispatches"] == 0,
          f"engine_mla_moe: mixed plans did not take the padded fallback: {st}")
    for i, (toks, finish, _) in enumerate(results):
        check(finish == "length" and len(toks) == N_OUT,
              f"engine_mla_moe: r{i} finished {finish!r} with {len(toks)} tokens")
    rec["config"] = {k: getattr(cfg, k) for k in (
        "name", "dim", "n_layers", "n_dense_layers", "n_experts", "n_experts_active",
        "moe_ffn_dim", "n_shared_experts", "moe_scoring", "n_expert_groups",
        "topk_groups", "moe_routed_scale")}
    rec["nvidia_smi"] = smi
    emit(rec)
    moe_parity(runner, dev, "parity_mla_moe", ragged=False)
    free(runner)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "kind": kind, "count": count, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.monotonic()
    _build.load()
    ptxas = {stem: ptxas_lines(log) for stem, log in _build.build_log.items()}
    # the GQA kernels' instantiations (D 64 / 96 / 128 / 256, soft cap 0 / 1)
    gqa_ptxas = {stem: ptxas_entries(_build.build_log[stem])
                 for stem in GQA_STEMS if stem in _build.build_log}
    # the int8 decode kernel's instantiations (D x soft cap)
    int8_decode = {k: v for k, v in gqa_ptxas.get("paged_attention", {}).items()
                   if k.startswith("decode_codes_kernel")}
    # the MLA kernels (int8 decode: mla_decode_codes_kernel), and ptxas's
    # notes on their wgmma products
    mla_log = _build.build_log.get("mla_attention", "")
    mla_ptxas = ptxas_entries(mla_log)
    wgmma_notes = [ln.strip() for ln in mla_log.splitlines() if "wgmma" in ln]
    emit({"phase": "build", "seconds": time.monotonic() - t0, "ptxas": ptxas,
          "gqa_kernels": gqa_ptxas, "int8_decode_kernels": int8_decode,
          "mla_kernels": mla_ptxas, "mla_wgmma_notes": wgmma_notes})

    try:
        # the MLA kernels sit at the register cap of one block an SM
        spills = [ln for ln in ptxas.get("mla_attention", [])
                  if any(int(n) for n in re.findall(r"(\d+) bytes spill", ln))]
        check(not spills, f"MLA kernels spill: {spills}")
        # int8 MLA decode is a kernel of its own
        check(any("mla_decode_codes_kernel" in k for k in mla_ptxas) or not mla_log,
              f"no int8 MLA decode kernel among {sorted(mla_ptxas)}")
        # nor may the grouped GEMM's entries (a spilled accumulator would
        # leave the wgmma registers for local memory)
        spills = [ln for ln in ptxas.get("moe_grouped_gemm", [])
                  if any(int(n) for n in re.findall(r"(\d+) bytes spill", ln))]
        check(not spills, f"grouped GEMM spills: {spills}")
        # nor the int8 decode kernel at any head dim (8 instantiations)
        check(len(int8_decode) == 8 or "paged_attention" not in gqa_ptxas,
              f"int8 decode instantiations: {sorted(int8_decode)}")
        check(all(v.get("spill_stores", 1) == 0 and v.get("spill_loads", 1) == 0
                  for v in int8_decode.values()), f"int8 decode kernels spill: {int8_decode}")
        # ptxas keeps the ragged bodies at 128-211 registers (three or four
        # 128-thread blocks an SM), and a few int8 ones (D 64, D 128
        # plain) spill 8-16 bytes; builds that do not spill ran 10-25%
        # slower (scripts/int8_body_variants.py --min-blocks, PERF.md)
        # D 256: O alone is 128 registers a thread; no instantiation spills
        # (decode 4 bodies + the bf16 and int8 merges, prefill 8, ragged 8 +
        # merge: bf16 and int8 each)
        d256 = {f"{stem}:{k}": v for stem, ents in gqa_ptxas.items()
                for k, v in ents.items() if "<256" in k}
        check(len(d256) == 23 or len(gqa_ptxas) < len(GQA_STEMS),
              f"GQA D 256 instantiations: {sorted(d256)}")
        check(all(v.get("spill_stores", 1) == 0 and v.get("spill_loads", 1) == 0
                  for v in d256.values()), f"GQA D 256 kernels spill: {d256}")
        kern = kernel_phase(dev)
        shapes_phase(dev)
        kern.update(copy_kernel_phase(dev))
        kern.update(mla_kernel_phase(dev))
        decode_split_edges_phase(dev)
        gem = gemma_kernels_phase(dev)
        kern.update(int8_kernels_phase(
            dev, {name: kern[name]["device_ms"]
                  for name in GQA_KERNELS + ("decode_mla_attention",)},
            gem["D256_G2"]["cases"]["gemma2"]))
        del gem
        head = head_shape_kernels_phase(dev)
        kern.update(moe_kernels_phase(dev))
        runner, launches, bodies, fused_rec = engine_phases(dev)
        variants = {name: {"engine_fused": bodies[name]} for name in GQA_KERNELS}
        # each copy kernel's launches from the phase that runs it
        disagg, disagg_rec = disagg_phase(runner.params)
        launches["gather_pages"] = disagg["gather_pages"]
        launches["scatter_pages"] = disagg["scatter_pages"]
        launches["scatter_pages_layers"] = tiers_phase(runner.params)[
            "scatter_pages_layers"]
        parity_phase(runner, dev)
        # the request plane: the in-process streams served one at a time,
        # the disaggregated pair over TCP, then (this process's runners
        # freed) the worker as a process of its own
        in_process = alone_phase(runner)
        served_disagg_phase(runner.params, disagg_rec)
        V = runner.config.vocab_size
        del runner, disagg
        gc.collect()
        torch.cuda.empty_cache()
        served_phase(in_process, fused_rec, V)
        # the slice's main path: llama-3.1-8b over int8 pools; each int8
        # entry's launches are the fused phase's (all on its int8 body)
        int8_launches, int8_bodies = int8kv_phases(dev, smi)
        for name in GQA_KERNELS:
            launches[f"{name}_int8"] = int8_launches[name]
            variants[f"{name}_int8"] = {f"engine_{phase}": b[name]
                                        for phase, b in int8_bodies.items()}
        del int8_launches
        gc.collect()
        torch.cuda.empty_cache()
        mla, mla8 = mla_phases(dev)
        for name in MLA_KERNELS:
            launches[name] = mla[name]
        launches["decode_mla_attention_int8"] = mla8["decode_mla_attention"]
        del mla, mla8
        gc.collect()
        torch.cuda.empty_cache()
        found = gemma_phases(dev, smi)
        gc.collect()
        torch.cuda.empty_cache()
        # this slice's paths: qwen2.5-7b (G 7), phi-3 (D 96, window 2047,
        # bf16 and int8) and the other families; the head-shape entries'
        # launches are their engines' fused phases'
        q_launches, q_bodies = qwen2_phases(dev, smi)
        p_launches, p8_launches, p_bodies = phi3_phases(dev, smi)
        found.update(q_bodies)
        found.update(p_bodies)
        found.update(families_phase(dev, smi))
        gc.collect()
        torch.cuda.empty_cache()
        # MoE, with nothing else on the card (qwen3-30b-a3b: 57 GiB of
        # weights); the grouped GEMM's launches are engine_qwen3moe's
        moe_launches, moe_bodies = qwen3moe_phases(dev, smi)
        found.update(moe_bodies)
        for name in MOE_KERNELS:
            launches[name] = moe_launches[name]
        gc.collect()
        torch.cuda.empty_cache()
        mla_moe_phases(dev, smi)
        for phase, b in found.items():
            for name in GQA_KERNELS:
                key = f"{name}_int8" if "int8" in phase else name
                variants[key][f"engine_{phase}"] = b[name]
        short = dict(zip(GQA_KERNELS, ("decode", "prefill", "ragged")))
        for name in GQA_KERNELS:
            for key, shape, pools, n in (
                    (f"{name}_G7", "qwen2_G7_D128", "bf16", q_launches),
                    (f"{name}_D96_window", "phi3_G1_D96", "bf16", p_launches),
                    (f"{name}_D96_int8_window", "phi3_G1_D96", "int8", p8_launches)):
                kern[key] = head[shape][pools][short[name]]
                launches[key] = n[name]
    except CheckFailed as e:
        print(f"chip_smoke: check failed: {e}", file=sys.stderr)
        return 1
    # the head-shape entries: qwen2.5-7b's G 7 and phi-3's D 96 bodies
    head_sources = {}
    for name in GQA_KERNELS:
        head_sources[f"{name}_G7"] = SOURCES[name]
        head_sources[f"{name}_D96_window"] = SOURCES[name]
        head_sources[f"{name}_D96_int8_window"] = INT8_SOURCES[f"{name}_int8"]
    sources = {**SOURCES, **INT8_SOURCES, **head_sources}
    emit({"phase": "total", "seconds": time.monotonic() - t0})
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": sources[name][0],
         "replaces": sources[name][1], "launches": launches[name],
         **{k: kern[name][k] for k in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by", "library_ms")},
         **({"variants": variants[name]} if name in variants else {})}
        for name in sources
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
