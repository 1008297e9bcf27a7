#!/usr/bin/env python3
"""Drive the PyTorch port (dynamo_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. device  - the card, its count, and `nvidia-smi` name and power limit;
  2. build   - build the CUDA kernels from ops/csrc (one nvcc per source,
               all started together);
  3. kernels - each attention kernel at the main path's shapes (Hk 8, G 3,
               D 128, PS 16, bf16) against its plain PyTorch version, with
               times from CUDA events, the library yardstick (SDPA over K/V
               gathered dense beforehand) and the roofline bound: decode,
               chunked prefill, and the ragged kernel over a 264-token
               mixed step (8 decode rows + 4 chunks), the same step with
               its last chunk dropped (tail rows must be exactly 0) and a
               verify-shaped step (K+1 = 5 rows per segment); then
               (`shapes`) all three kernels at the other shapes they take;
               then (`copy_kernels`) the three page-copy kernels at the 3B
               page shape (L 28, PS 16, Hk 8, D 128, bf16) in a 2048-page
               pool, 94 pages in random order: token- and head-major
               gather, scatter, and a 4-group layer scatter, bit for bit
               against their plain versions; then (`mla_kernels`) the two
               MLA kernels at DeepSeek-V3's shapes (H 128, d_c 512, d_rh
               64, PS 16, bf16): decode at B 8 (an empty row), prefill
               S 512 with q_len 450 over 700 prior tokens, a packed [4, 256]
               prefill with an all-padding row (exactly 0), and other page
               sizes and head counts, untimed;
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
               one shared params dict, 1024 pages each, behind a
               PrefillRouter: the same 8 requests, half pulled on the
               device (colocated instance), half host-staged in chunks of
               16 pages; the decode engine must run no prefill, imported
               pages must equal the prefill engine's byte for byte, and
               the copy kernels' launches must equal the transfer calls
               x 2 pools;
     tiers   - (`engine_tiers`) one engine with a 160-page pool, a 512-block
               host tier and 4 onboard layer groups: a 1100-token request,
               two 1500-token fillers that evict its pages to the host,
               then a request sharing its first 1024 tokens, onboarded
               from the host (bytes equal to what was offloaded, stream
               equal to a cold prefill's);
  5. parity  - prefill-plus-decode inputs, then one ragged dispatch of
               decode rows and a chunk over prior context, through the
               kernel path and the plain attention path of the forward;
  6. mla     - (`engine_mla`) DeepSeek-V3's three dense layers at full
               width (get_config("deepseek-v3").with_(n_layers=3,
               n_experts=0), random bf16 weights) serve the same 8 requests
               at the card's default (fused plans on the padded fallback:
               MLA has no ragged path); each MLA kernel's launches must
               equal its forward passes x 3 and no GQA kernel may launch.
               Then (`mla_pages`) one request's latent and stub pages go
               through export/import on the device and through the wire
               with a 3-group layer-streamed import, bit for bit, and
               (`parity_mla`) prefill and two decode steps through both
               attention paths of the forward.
Then the `kernels` summary line (launches from the fused phase for the
GQA attention kernels, from engine_disagg for gather and scatter, from
engine_tiers for the layer scatter, from engine_mla for the MLA kernels),
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
import subprocess
import sys
import time
import warnings

import torch
import torch.nn.functional as F

from dynamo_tpu_torch.engine.model_runner import ModelRunner
from dynamo_tpu_torch.models.config import get_config
from dynamo_tpu_torch.models.toolkit import attn_score_scale
from dynamo_tpu_torch.ops import _build
from dynamo_tpu_torch.ops import block_copy as bc
from dynamo_tpu_torch.ops.flash_prefill import (
    prefill_paged_attention,
    prefill_paged_attention_ref,
)
from dynamo_tpu_torch.ops.mla_attention import (
    decode_mla_attention,
    decode_mla_attention_ref,
    prefill_mla_attention,
    prefill_mla_attention_ref,
)
from dynamo_tpu_torch.ops.paged_attention import (
    decode_paged_attention,
    decode_paged_attention_ref,
)
from dynamo_tpu_torch.ops.ragged_paged_attention import (
    build_ragged_metadata,
    ragged_paged_attention,
    ragged_paged_attention_ref,
)
from dynamo_tpu_torch.router.prefill_router import (
    DisaggPolicy,
    LocalPrefillClient,
    PrefillRouter,
)
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.tokens.hashing import block_hashes
from dynamo_tpu_torch.worker import (
    build_engine,
    build_runner,
    disagg_endpoint,
    parse_args,
)
from dynamo_tpu_torch.worker_common import register_prefill

# NVIDIA H100 SXM data sheet (dense): HBM3 rate and bf16 tensor-core peak
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
KERNEL_TOL = 0.03  # docs/PERF.md "Kernel parity gate" (max abs err, bf16)
# forward parity: per-row relative L2 error of the f32 logits between the
# kernel path and the plain path. Both run bf16 activations; the plain
# path also rounds scores and probabilities to bf16, a ~0.4% relative
# error per rounding that 28 layers grow to around 1%. A wrong page, mask
# or softmax moves the logits by O(1) relative.
FORWARD_REL_TOL = 0.05
ENGINE_ARGS = ["--model", "llama-3.2-3b", "--num-pages", "2048",
               "--page-size", "16", "--max-seq-len", "4096",
               "--max-batch", "8", "--chunk-size", "512"]
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
}
KERNELS = {"decode_paged_attention": decode_paged_attention,
           "prefill_paged_attention": prefill_paged_attention,
           "ragged_paged_attention": ragged_paged_attention,
           "gather_pages": bc.gather_pages,
           "scatter_pages": bc.scatter_pages,
           "scatter_pages_layers": bc.scatter_pages_layers,
           "decode_mla_attention": decode_mla_attention,
           "prefill_mla_attention": prefill_mla_attention}
COPY_KERNELS = ("gather_pages", "scatter_pages", "scatter_pages_layers")
GQA_KERNELS = ("decode_paged_attention", "prefill_paged_attention",
               "ragged_paged_attention")
MLA_KERNELS = ("decode_mla_attention", "prefill_mla_attention")
# DeepSeek-V3's first three layers (dense FFN; the later MoE layers wait for
# ROADMAP A.11) at full width
MLA_CONFIG = get_config("deepseek-v3").with_(n_layers=3, n_experts=0)


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


def bound(n_bytes: float, n_flops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / BF16_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


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


def ragged_check(args, segs, what):
    """Kernel against the plain version on the real rows; tail rows (the
    dummy segment) must be exactly 0. Returns the max abs error."""
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
    return err


def ragged_library(args, segs, md, scale):
    """SDPA yardstick inputs: the real queries [1, H, n, D] against every
    segment's visible K/V gathered dense [1, H, C, D] beforehand, under a
    segment-causal mask [n, C]."""
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
            & (col_pos[None, :] <= tok_pos[:, None]))[None, None]
    qd = q[:n].reshape(n, Hk * G, D).transpose(0, 1)[None].contiguous()
    kd, vd = heads(torch.cat(ks)), heads(torch.cat(vs))
    return lambda: F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask,
                                                  scale=scale)


def ragged_phase(gen, dev):
    """The ragged kernel at the main path's step (timed), the same step
    without its last chunk (a 16-row tail) and a verify-shaped step."""
    Hk, G, D, PS = 8, 3, 128, 16
    H, MP = Hk * G, 4096 // PS
    scale = D ** -0.5
    decode = [(1, kv - 1) for kv in RAGGED_DECODE_KV]
    cases = {
        "mixed": decode + RAGGED_CHUNKS,
        "mixed_tail": decode + RAGGED_CHUNKS[:-1],
        "verify": [(5, max(kv - 5, 0)) for kv in RAGGED_DECODE_KV]
        + RAGGED_CHUNKS[:2],
    }
    out = {}
    for name, segs in cases.items():
        args, md = ragged_inputs(gen, segs, RAGGED_T, Hk, G, D, PS, MP, dev)
        rec = {"segments": segs, "t_real": sum(n for n, _ in segs),
               "max_abs_err": ragged_check(args, segs, name),
               "ms": cuda_ms(lambda: ragged_paged_attention(*args)),
               "plain_ms": cuda_ms(lambda: ragged_paged_attention_ref(*args),
                                   iters=5)}
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
            rec["library_ms"] = cuda_ms(ragged_library(args, segs, md, scale))
        out[name] = rec
        del args
    top = {k: out["mixed"][k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms")}
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
    results["decode_paged_attention"] = {
        "max_abs_err": err,
        "ms": cuda_ms(lambda: decode_paged_attention(q, k_pool, v_pool, pt, kvl)),
        "plain_ms": cuda_ms(lambda: decode_paged_attention_ref(q, k_pool, v_pool, pt, kvl)),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
            qd, kq, vq, attn_mask=mask, scale=scale)),
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
        cases.append({
            "prior": prior, "q_len": q_len, "S": S, "max_abs_err": err,
            "ms": cuda_ms(lambda: prefill_paged_attention(*args)),
            "plain_ms": cuda_ms(lambda: prefill_paged_attention_ref(*args)),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                qd, kq, vq, attn_mask=mask, scale=scale)),
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
    the wrappers accept (head dims 64/128, GQA groups, page sizes,
    q-blocks that overrun S), small and untimed."""
    gen = torch.Generator(device="cpu").manual_seed(3)
    errs = {}
    for D, G, PS in ((128, 4, 16), (128, 1, 8), (128, 8, 32), (64, 4, 16),
                     (64, 2, 4)):
        Hk, MP = 2, 64
        NP = 3 * MP + 1

        def rnd(*shape):
            return torch.randn(*shape, generator=gen).bfloat16().to(dev)

        k_pool, v_pool = rnd(NP, PS, Hk, D), rnd(NP, PS, Hk, D)
        pt = random_pages(gen, 3, MP, NP, dev)
        q = rnd(3, Hk, G, D)
        kvl = torch.tensor([0, 37, 200], dtype=torch.int32, device=dev)
        out = decode_paged_attention(q, k_pool, v_pool, pt, kvl)
        ref = decode_paged_attention_ref(q, k_pool, v_pool, pt, kvl)
        e_dec = (out.float() - ref.float()).abs().max().item()
        check(out[0].float().abs().max().item() == 0.0,
              f"decode kv_len=0 row not 0 at D={D} G={G} PS={PS}")
        S = 48
        q = rnd(2, S, Hk, G, D)
        qs, ql = [0, 30], [40, 17]
        ints = [torch.tensor(x, dtype=torch.int32, device=dev)
                for x in (qs, ql, [qs[0] + ql[0], qs[1] + ql[1] + 3])]
        args = (q, k_pool, v_pool, pt[:2].contiguous(), *ints)
        out = prefill_paged_attention(*args)
        ref = prefill_paged_attention_ref(*args)
        e_pre = (out.float() - ref.float()).abs().max().item()
        torch.cuda.synchronize()
        name = f"D{D}_G{G}_PS{PS}"
        # ragged: decode rows, chunks over prior context, a 11-row tail
        segs = [(1, 36), (1, 0), (21, 13), (9, 0), (5, 100)]
        args, _ = ragged_inputs(gen, segs, 48, Hk, G, D, PS, MP, dev)
        e_rag = ragged_check(args, segs, name)
        errs[name] = {"decode": e_dec, "prefill": e_pre, "ragged": e_rag}
        check(max(e_dec, e_pre) <= KERNEL_TOL,
              f"kernel parity at {name}: decode {e_dec}, prefill {e_pre}")
    emit({"phase": "shapes", "tol": KERNEL_TOL, "max_abs_err": errs})


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

    def rnd(*shape):
        return torch.randn(*shape, generator=gen).bfloat16().to(dev)

    # decode: B 8, kv_len up to 4096, one empty row
    kv_list = MLA_DECODE_KV
    B, MP = len(kv_list), 4096 // PS
    NP = B * MP + 1
    lat = rnd(NP, PS, 1, Dl)
    q = rnd(B, H, Dl)
    pt = random_pages(gen, B, MP, NP, dev)
    kvl = torch.tensor(kv_list, dtype=torch.int32, device=dev)
    args = (q, lat, pt, kvl)
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
        "shape": {"B": B, "H": H, "dc": dc, "dr": dr, "PS": PS, "kv_lens": kv_list},
    }
    del lat, dense, args

    # prefill: S 512, q_len 450 over 700 prior tokens (padding rows after)
    S, prior, q_len = 512, 700, 450
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
        "max_abs_err": err,
        "ms": cuda_ms(lambda: prefill_mla_attention(*args, dc=dc, scale=scale)),
        "plain_ms": cuda_ms(lambda: prefill_mla_attention_ref(*args, dc=dc, scale=scale),
                            iters=5),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": cuda_ms(lib_fn), "library": lib_name,
        "shape": {"S": S, "q_len": q_len, "prior": prior, "H": H, "dc": dc,
                  "dr": dr, "PS": PS},
    }
    del lat, dense, args, q_heads

    # a packed [4, 256] prefill batch (the padded fallback's shape) with an
    # all-padding row, then other page sizes and head counts
    cases = {}
    for name, (PSx, Hx, segs) in {
            "packed": (PS, H, MLA_PACKED),
            "PS8_H16": (8, 16, [(200, 37), (1, 0), (0, 0)]),
            "PS32_H32": (32, 32, [(64, 900), (33, 5)])}.items():
        Bx, Sx = len(segs), 256 if name == "packed" else 200
        MPx = max(-(-(n + p) // PSx) for n, p in segs) + 1
        NPx = Bx * MPx + 1
        lat = rnd(NPx, PSx, 1, Dl)
        ptx = random_pages(gen, Bx, MPx, NPx, dev)
        qs, ql, kvx = ([p for _, p in segs], [n for n, _ in segs],
                       [n + p for n, p in segs])
        ints = [torch.tensor(x, dtype=torch.int32, device=dev) for x in (qs, ql, kvx)]
        pargs = (rnd(Bx, Sx, Hx, Dl), lat, ptx, *ints)
        got = prefill_mla_attention(*pargs, dc=dc, scale=scale)
        dargs = (rnd(Bx, Hx, Dl), lat, ptx, ints[2])
        got_d = decode_mla_attention(*dargs, dc=dc, scale=scale)
        torch.cuda.synchronize()
        want = prefill_mla_attention_ref(*pargs, dc=dc, scale=scale)
        want_d = decode_mla_attention_ref(*dargs, dc=dc, scale=scale)
        pad_zero = all(got[b, n:].float().abs().max().item() == 0.0
                       for b, (n, _) in enumerate(segs) if n < Sx)
        check(pad_zero, f"MLA prefill padding rows are not 0 ({name})")
        e_p = max((got[b, :n].float() - want[b, :n].float()).abs().max().item()
                  for b, (n, _) in enumerate(segs) if n > 0)
        e_d = (got_d.float() - want_d.float()).abs().max().item()
        check(max(e_p, e_d) <= KERNEL_TOL,
              f"MLA kernels at {name}: prefill {e_p}, decode {e_d}")
        cases[name] = {"segments": segs, "S": Sx, "PS": PSx, "H": Hx,
                       "prefill_max_abs_err": e_p, "decode_max_abs_err": e_d}
        del lat, pargs, dargs
    results["prefill_mla_attention"]["cases"] = cases
    torch.cuda.empty_cache()
    emit({"phase": "mla_kernels", "tol": KERNEL_TOL, **results})
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


def workload(vocab_size: int, seed: int):
    """8 requests from a seed: prompts of 17 to 1500 tokens (the long ones
    run chunked prefill over prior context, chunk 512), mostly greedy, two
    sampled (temperature 0.8, top_p 0.9, seeded); the last request shares
    a 256-token prefix with the one before it. Returns (first 7, last)."""
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


def serve(engine, seed: int, spec: bool = False):
    """Serve workload(seed) (spec_workload with spec) to completion, at
    most 900 s."""
    make = spec_workload if spec else workload
    reqs, late = make(engine.runner.config.vocab_size, seed)
    prompts = [r["token_ids"] for r in reqs + [late]]
    return prompts, asyncio.run(asyncio.wait_for(
        _serve(engine, reqs, len(reqs) - 1, late), 900))


def check_launches(phase: str, launches, stats, L: int, mla: bool = False) -> None:
    """Each kernel launched once per layer of each forward pass of its
    kind, and nowhere else (an MLA model launches no GQA kernel and the
    other way round)."""
    prefill = stats["prefill_chunks"] + stats["padded_prefill_dispatches"]
    ragged = stats["ragged_mixed_dispatches"] + stats["ragged_verify_dispatches"]
    if mla:
        want = {"prefill_mla_attention": prefill,
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
    for name in COPY_KERNELS:  # no transfer and no host tier here
        check(launches[name] == 0, f"{phase}: {name} launched {launches[name]}")


def engine_phase(runner, phase: str, fused: bool = None, spec: bool = False,
                 build_s: float = None):
    """Serve the workload on a fresh engine over `runner`, with every
    launch count and runner.stats set to 0 just before and read just
    after. fused=None keeps the engine's default (fused on a card)."""
    args = ENGINE_ARGS + (["--spec-ngram", "--spec-k", "4"] if spec else [])
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
    for fn in KERNELS.values():
        fn.launches = 0
    runner.reset_stats()
    t0 = time.monotonic()
    try:
        prompts, results = serve(engine, seed=1, spec=spec)
    finally:
        engine.stop()
    torch.cuda.synchronize()  # a fault during the run surfaces here
    wall = time.monotonic() - t0
    launches = {name: fn.launches for name, fn in KERNELS.items()}
    stats = dict(runner.stats)
    for i, (toks, finish, _) in enumerate(results):
        check(finish in ("length", "stop"), f"{phase}: r{i} finished {finish!r}")
        check(finish != "length" or len(toks) == N_OUT,
              f"{phase}: r{i} emitted {len(toks)} tokens, wanted {N_OUT}")
        check(all(0 <= t < V for t in toks),
              f"{phase}: r{i} emitted a token out of range")
    check(stats["prefill_chunks"] > 0 and stats["decode_steps"] > 0,
          f"{phase}: engine ran no prefill or no decode: {stats}")
    check_launches(phase, launches, stats, L, mla=runner.config.is_mla)
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
        "stats": stats, "launches": launches,
        "reused_prefix_tokens": reused,
        "ttft_s_min": ttft[0], "ttft_s_median": ttft[len(ttft) // 2],
        "ttft_s_max": ttft[-1],
        "decode_tok_s_per_request_median": decode_rates[len(decode_rates) // 2],
        "output_tok_s_overall": n_tokens / wall, "wall_s": wall,
        "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    if build_s is not None:
        rec["build_s"] = build_s
    if spec:
        rec["spec_stats"] = dict(engine.spec_stats)
        rec["acceptance_rate"] = (engine.spec_stats["accepted"]
                                  / max(1, engine.spec_stats["drafted"]))
    return rec, launches, results


def engine_phases(dev):
    """The fused (main path), unfused and spec phases on one runner."""
    t0 = time.monotonic()
    runner, _ = build_runner(parse_args(ENGINE_ARGS))
    torch.cuda.synchronize()
    build_s = time.monotonic() - t0

    rec, launches, fused = engine_phase(runner, "fused", build_s=build_s)
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
    return runner, launches


DISAGG_ARGS = ["--model", "llama-3.2-3b", "--num-pages", "1024",
               "--page-size", "16", "--max-seq-len", "4096", "--max-batch", "8",
               "--chunk-size", "512"]
DISAGG_CHUNK_PAGES = 16
PAGE_SIZE = 16


def _reset(*runners):
    for fn in KERNELS.values():
        fn.launches = 0
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


def disagg_phase(params):
    """The slice's main path: PrefillRouter → prefill engine (park) → KV
    pull (device for the colocated instance, host-staged chunks of 16
    pages for the other) → decode engine (admit with KV, decode)."""
    p_args = parse_args(DISAGG_ARGS + ["--disagg-role", "prefill"])
    d_args = parse_args(DISAGG_ARGS + ["--disagg-role", "decode",
                                       "--disagg-chunk-pages",
                                       str(DISAGG_CHUNK_PAGES)])
    prefill = build_engine(p_args, runner=build_runner(p_args, params=params)[0])
    decode = build_engine(d_args, runner=build_runner(d_args, params=params)[0])
    iid_dev = disagg_endpoint(prefill, p_args)  # colocated: device pull
    iid_host = register_prefill(prefill, colocated=False)  # host-staged pull
    adapter = disagg_endpoint(decode, d_args)
    router = PrefillRouter(adapter, DisaggPolicy(min_prefill_tokens=16))
    router.activate(LocalPrefillClient([iid_dev, iid_host]))
    paths = {}
    fetch = adapter._fetch

    async def fetch_by_path(src):
        paths[src["request_id"]] = "device" if src["instance_id"] == iid_dev else "host"
        return await fetch(src)

    adapter._fetch = fetch_by_path
    imports = _spy_calls(decode.runner, ("import_pages_device", "import_pages"))
    V, L = prefill.runner.config.vocab_size, prefill.runner.config.n_layers
    reqs, late = workload(V, seed=1)
    prompts = [r["token_ids"] for r in reqs + [late]]

    async def serve():
        shared = asyncio.Event()
        tasks = [asyncio.create_task(_collect_timed(
            router, r, f"r{i}", shared if i == len(reqs) - 1 else None))
            for i, r in enumerate(reqs)]
        await shared.wait()  # the late request shares r6's 256-token prefix
        tasks.append(asyncio.create_task(_collect_timed(router, late, f"r{len(reqs)}")))
        return await asyncio.gather(*tasks)

    torch.cuda.synchronize()
    _reset(prefill.runner, decode.runner)
    t0 = time.monotonic()
    try:
        results = asyncio.run(asyncio.wait_for(serve(), 300))
    finally:
        prefill.stop()
        decode.stop()
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
        rows = [(n, r["phases"]["kv_fetch_s"], r["phases"]["kv_import_s"])
                for n, r, p in zip(n_pages, results, path_of) if p == path]
        pages = sum(n for n, _, _ in rows)
        secs = sum(f + i for _, f, i in rows)
        transfer[path] = {
            "requests": len(rows), "pages": pages,
            "bytes": pages * page_bytes,
            "ms_per_request": [(f + i) * 1e3 for _, f, i in rows],
            "fetch_ms": [f * 1e3 for _, f, _ in rows],
            "import_ms": [i * 1e3 for _, _, i in rows],
            "prompt_pages": [n for n, _, _ in rows],
            "gb_per_s": pages * page_bytes / secs / 1e9,
        }
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
    return launches


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


def parity_phase(runner, dev, phase: str = "parity", ragged: bool = True):
    """Three sequences prefilled in one chunk (S = 320, padding rows),
    two decode steps of the first two (the third a padding row), then
    (`ragged`) one ragged dispatch: both decode rows and a 77-token chunk
    of the third over its 90 prior tokens (T 88, a 9-row tail). Through
    forward(attn_impl="kernel") and forward(attn_impl="ref") on their own
    pools; decode inputs are the kernel path's greedy tokens, fed to both."""
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.models.toolkit import make_kv_pool

    cfg, params = runner.config, runner.params
    PS, MP, NP = 16, 24, 80
    gen = torch.Generator(device="cpu").manual_seed(2)
    lens = [300, 180, 90]
    S = 320
    tok = torch.randint(0, cfg.vocab_size, (3, S), generator=gen)
    pos = torch.full((3, S), -1, dtype=torch.int32)
    for b, n in enumerate(lens):
        pos[b, :n] = torch.arange(n)
    pages = torch.randperm(NP, generator=gen)[: 3 * MP].view(3, MP).to(torch.int32)
    tok, pos, pages = tok.to(dev), pos.to(dev), pages.to(dev)
    pools = {impl: make_kv_pool(cfg, NP + 1, PS, runner.dtype, dev)
             for impl in ("kernel", "ref")}
    steps = [(tok, pos, torch.tensor(lens, dtype=torch.int32, device=dev),
              torch.tensor([n - 1 for n in lens], device=dev))]
    rel, agree, worst_abs = [], [], 0.0

    def compare(logits):
        nonlocal worst_abs
        a, b = logits["kernel"], logits["ref"]
        check(torch.isfinite(a).all().item(), "kernel-path logits not finite")
        rel.append(((a - b).norm(dim=-1) / b.norm(dim=-1)).max().item())
        worst_abs = max(worst_abs, (a - b).abs().max().item())
        agree.extend((a.argmax(-1) == b.argmax(-1)).tolist())
        return a.argmax(-1).to(torch.int32)

    for t in range(3):
        tk, ps, kvl, last = steps[-1]
        nxt = compare({
            impl: llama.forward(cfg, params, tk, ps, *pools[impl], pages,
                                kvl, last, attn_impl=impl)[:, -1]
            for impl in ("kernel", "ref")})
        p1 = torch.tensor([[lens[0] + t], [lens[1] + t], [-1]],
                          dtype=torch.int32, device=dev)
        steps.append((nxt[:, None], p1,
                      torch.where(p1[:, 0] < 0, 0, p1[:, 0] + 1).to(torch.int32),
                      None))
    steps_run = ["prefill", "decode", "decode"]
    if ragged:
        ragged_parity_step(cfg, params, pools, nxt, lens, pages, MP, gen, dev,
                           compare)
        steps_run.append("ragged")
    worst = max(rel)
    emit({"phase": phase, "model": cfg.name, "steps": steps_run,
          "rel_l2_err_per_step": rel, "max_abs_err": worst_abs,
          "tol_rel_l2": FORWARD_REL_TOL,
          "greedy_agreement": sum(agree) / len(agree)})
    check(worst <= FORWARD_REL_TOL,
          f"{phase}: kernel vs plain forward: relative L2 error {worst} > "
          f"{FORWARD_REL_TOL}")


def ragged_parity_step(cfg, params, pools, nxt, lens, pages, MP, gen, dev,
                       compare):
    """The ragged dispatch of parity_phase: the decode rows' next tokens at
    lens + 2, and the third sequence's 77-token chunk."""
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
    compare({impl: llama.forward(cfg, params, flat.to(dev)[None], positions,
                                 *pools[impl], last_index=gather.to(dev),
                                 attn_impl=impl, ragged=ragged)[0, :3]
             for impl in ("kernel", "ref")})


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
    # ptxas -v per kernel instantiation: entry name, registers, spills
    ptxas = {stem: [ln.split(":", 1)[-1].strip() for ln in log.splitlines()
                    if "Compiling entry" in ln or "registers" in ln
                    or "spill" in ln]
             for stem, log in _build.build_log.items()}
    emit({"phase": "build", "seconds": time.monotonic() - t0, "ptxas": ptxas})

    try:
        kern = kernel_phase(dev)
        shapes_phase(dev)
        kern.update(copy_kernel_phase(dev))
        kern.update(mla_kernel_phase(dev))
        runner, launches = engine_phases(dev)
        # each copy kernel's launches from the phase that runs it
        disagg = disagg_phase(runner.params)
        launches["gather_pages"] = disagg["gather_pages"]
        launches["scatter_pages"] = disagg["scatter_pages"]
        launches["scatter_pages_layers"] = tiers_phase(runner.params)[
            "scatter_pages_layers"]
        parity_phase(runner, dev)
        del runner, disagg
        gc.collect()
        torch.cuda.empty_cache()
        mla = mla_phases(dev)
        for name in MLA_KERNELS:
            launches[name] = mla[name]
    except CheckFailed as e:
        print(f"chip_smoke: check failed: {e}", file=sys.stderr)
        return 1
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name][0],
         "replaces": SOURCES[name][1], "launches": launches[name],
         **{k: kern[name][k] for k in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by", "library_ms")}}
        for name in SOURCES
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
