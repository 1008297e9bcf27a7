"""Worker construction for the PyTorch port: parse args, build the runner
and the engine.

Port of dynamo_tpu/worker.py `parse_args`, `build_runner` and
`build_engine`, with the reference's names and the flags this slice uses.
Serving the engine over the request plane (the reference worker's main)
is not ported yet; callers drive `engine.generate` directly, and
`disagg_endpoint` gives what a `--disagg-role` worker offers in process.
"""

from __future__ import annotations

import argparse

from dynamo_tpu_torch.engine.engine import InferenceEngine
from dynamo_tpu_torch.engine.model_runner import ModelRunner
from dynamo_tpu_torch.models.config import ModelConfig, get_config
from dynamo_tpu_torch.worker_common import DisaggDecodeAdapter, register_prefill


def parse_args(argv=None):
    p = argparse.ArgumentParser("dynamo_tpu_torch.worker")
    p.add_argument("--model", default="tiny", help="model config preset name")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "PyTorch attention path)")
    # KV cache
    p.add_argument("--num-pages", type=int, default=512)
    p.add_argument("--page-size", type=int, default=16)
    p.add_argument("--max-seq-len", type=int, default=4096)
    p.add_argument("--kv-quantize", choices=["int8"], default=None,
                   help="int8 KV cache: int8 codes with one f32 scale per "
                        "cached (token, head) vector (~half the bytes); pages "
                        "cross the transfer boundary dequantized")
    # batching
    p.add_argument("--max-batch", type=int, default=64)
    p.add_argument("--chunk-size", type=int, default=512)
    p.add_argument("--mixed-prefill-tokens", type=int, default=256,
                   help="per-iteration prefill token POOL when co-scheduled "
                        "with decode: fair-shared across up to "
                        "--mixed-prefill-seqs packed chunks from distinct "
                        "sequences (0 = strict prefill-first)")
    p.add_argument("--mixed-prefill-seqs", type=int, default=8,
                   help="max distinct prefills packed per iteration")
    p.add_argument("--mixed-min-chunk", type=int, default=16,
                   help="fair-share floor: each packed sequence is offered "
                        "at least this many prefill tokens per iteration")
    # speculative decoding
    p.add_argument("--spec-ngram", action="store_true",
                   help="draft-model-free speculation: propose the next K "
                        "tokens by prompt/history n-gram lookup and verify "
                        "them as ragged rows of the mixed dispatch")
    p.add_argument("--spec-k", type=int, default=4,
                   help="n-gram draft length K (verify rows are K+1 tokens)")
    p.add_argument("--spec-max-tokens", type=int, default=0,
                   help="per-iteration cap on drafted tokens admitted to "
                        "the verify dispatch (0 = the leftover mixed "
                        "prefill token budget)")
    # KVBM tiers
    p.add_argument("--host-kv-blocks", type=int, default=0,
                   help="G2 host-DRAM KV tier capacity in blocks (0 = off)")
    p.add_argument("--onboard-layer-groups", type=int, default=1,
                   help="stream G2 onboarding in this many contiguous layer "
                        "groups (1 = whole-sequence import)")
    # disaggregation
    p.add_argument("--disagg-role", choices=["prefill", "decode"], default=None,
                   help="disaggregated role (default: aggregated)")
    p.add_argument("--disagg-chunk-pages", type=int, default=16,
                   help="decode role: P->D KV pull chunk size in pages "
                        "(0 = single message)")
    return p.parse_args(argv)


def build_runner(args, params=None) -> tuple[ModelRunner, ModelConfig]:
    """Construct the ModelRunner (bf16 random weights, seed 0, until
    checkpoint loading is ported) and its model config from CLI args.
    `params` shares another runner's weights (two engines on one card)."""
    config = get_config(args.model)
    runner = ModelRunner(
        config,
        num_pages=args.num_pages,
        page_size=args.page_size,
        max_pages_per_seq=-(-args.max_seq_len // args.page_size),
        params=params,
        device=args.device,
        kv_quantize=args.kv_quantize,
    )
    return runner, config


def build_engine(args, runner=None) -> InferenceEngine:
    if runner is None:
        runner, _ = build_runner(args)
    return InferenceEngine(
        runner,
        max_batch=args.max_batch,
        chunk_size=args.chunk_size,
        mixed_prefill_tokens=args.mixed_prefill_tokens,
        mixed_prefill_seqs=args.mixed_prefill_seqs,
        mixed_min_chunk=args.mixed_min_chunk,
        spec_ngram=args.spec_ngram,
        spec_k=args.spec_k,
        spec_max_tokens=args.spec_max_tokens,
        host_kv_blocks=args.host_kv_blocks,
        onboard_layer_groups=args.onboard_layer_groups,
    )


def disagg_endpoint(engine, args):
    """What a worker of `--disagg-role` serves in process until the
    request plane is ported: a prefill worker registers its engine as a
    colocated prefill instance and returns the instance id; a decode worker
    returns the DisaggDecodeAdapter over its engine (pull chunks of
    `--disagg-chunk-pages`); an aggregated worker, the engine itself."""
    if args.disagg_role == "prefill":
        return register_prefill(engine)
    if args.disagg_role == "decode":
        return DisaggDecodeAdapter(engine, chunk_pages=args.disagg_chunk_pages)
    return engine
