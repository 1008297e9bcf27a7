"""The port's worker: parse args, build the runner and the engine, and
serve it.

Port of dynamo_tpu/worker.py `parse_args`, `build_runner`, `build_engine`,
`async_main` and `main`, with the reference's names and flags:

    python -m dynamo_tpu_torch.worker --model llama-3.2-3b \
        --discovery-backend file --discovery-root DIR

registers an instance in discovery, serves `generate`, `kv_fetch` and
`kv_state` over the request plane (TCP unless `--request-plane inproc`),
publishes KV events and forward-pass metrics on the event plane, prints
"worker serving <model> at <ns/component/endpoint>", and on SIGTERM or
SIGINT unregisters, drains in-flight requests and exits 0. The engine
runs on CUDA unless `--device cpu`. `--draft-model PRESET --spec-gamma N`
decodes by draft-model speculation. Checkpoint loading (and with it
`--draft-checkpoint`), the engine
sidecar, multi-host groups, vision, the status server and the shadow
failover are not ported yet (weights are random, from seed 0).
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import signal

from dynamo_tpu_torch.engine.engine import InferenceEngine
from dynamo_tpu_torch.engine.model_runner import ModelRunner
from dynamo_tpu_torch.frontend.protocols import ModelCard
from dynamo_tpu_torch.models.config import ModelConfig, get_config
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.worker_common import serve_worker

log = logging.getLogger("dynamo_tpu_torch.worker")


def parse_args(argv=None):
    p = argparse.ArgumentParser("dynamo_tpu_torch.worker")
    p.add_argument("--model", default="tiny", help="model config preset name")
    p.add_argument("--model-name", default=None,
                   help="served model name (default: config name)")
    p.add_argument("--tokenizer", default="byte",
                   help="'byte' or path to tokenizer.json (published in the "
                        "model card; the worker itself takes token ids)")
    p.add_argument("--namespace", default="dyn")
    p.add_argument("--component", default="tpu-worker")
    p.add_argument("--endpoint", default="generate")
    p.add_argument("--discovery-backend", default=None,
                   help="mem | file (default: DYN_DISCOVERY_BACKEND or mem)")
    p.add_argument("--discovery-root", default=None,
                   help="file discovery: the shared directory of records")
    p.add_argument("--request-plane", default=None, choices=[None, "tcp", "inproc"],
                   help="request plane (default: DYN_REQUEST_PLANE or tcp)")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "PyTorch attention path)")
    # KV cache
    p.add_argument("--num-pages", type=int, default=512)
    p.add_argument("--page-size", type=int, default=16)
    p.add_argument("--max-seq-len", type=int, default=4096)
    p.add_argument("--quantize", choices=["int8", "fp8"], default=None,
                   help="weight-only quantization: int8 or e4m3 codes with "
                        "one f32 scale a weight column (the embedding's a "
                        "row), about half the bf16 bytes; the products run "
                        "on the weight-only GEMM kernels")
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
    p.add_argument("--draft-model", default=None,
                   help="draft model config preset (enables speculative "
                        "decoding: the draft proposes, the model verifies)")
    p.add_argument("--spec-gamma", type=int, default=4,
                   help="draft tokens proposed per target verify pass")
    p.add_argument("--spec-draft-model", default=None, metavar="PRESET",
                   help="alias for --draft-model")
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


def build_runner(args, params=None, draft_params=None) -> tuple[ModelRunner, ModelConfig]:
    """Construct the ModelRunner (bf16 random weights, seed 0, until
    checkpoint loading is ported; a draft model's from seed 1) and its
    model config from CLI args. `params` shares another runner's weights
    (two engines on one card), `draft_params` a draft tree (the model's
    own params make a self-draft). A model whose params and pools exceed
    the card's free memory raises MemoryError before anything is drawn
    (DeepSeek-V3 at full depth; qwen3-30b-a3b, 61 GB of weights, needs the
    card to itself)."""
    config = get_config(args.model)
    draft = args.draft_model or args.spec_draft_model
    runner = ModelRunner(
        config,
        num_pages=args.num_pages,
        page_size=args.page_size,
        max_pages_per_seq=-(-args.max_seq_len // args.page_size),
        params=params,
        device=args.device,
        kv_quantize=args.kv_quantize,
        quantize=args.quantize,
        draft_config=get_config(draft) if draft else None,
        draft_params=draft_params,
        spec_gamma=args.spec_gamma,
    )
    return runner, config


def build_engine(args, runner=None, **engine_kw) -> InferenceEngine:
    """The engine of the CLI args over `runner` (built from them when
    None); `engine_kw` sets InferenceEngine arguments no flag carries
    (decode_steps, spec_branches, spec_device_draft)."""
    if runner is None:
        runner, _ = build_runner(args)
    kw = dict(
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
        tokenizer_spec=args.tokenizer,
    )
    kw.update(engine_kw)
    return InferenceEngine(runner, **kw)


def model_card(args, config: ModelConfig) -> ModelCard:
    """The card the worker publishes in its instance metadata."""
    return ModelCard(name=args.model_name or config.name, tokenizer=args.tokenizer,
                     context_length=args.max_seq_len, kv_block_size=args.page_size)


async def serve_args(runtime, engine, args, **kw):
    """serve_worker with the worker flags: namespace, component,
    endpoint, disaggregated role and pull chunk size."""
    return await serve_worker(
        runtime, engine, model_card(args, engine.runner.config),
        namespace=args.namespace, component=args.component, endpoint=args.endpoint,
        disagg_role=args.disagg_role, disagg_chunk_pages=args.disagg_chunk_pages, **kw)


async def async_main(args) -> None:
    kw = {}
    if args.discovery_root:
        kw["root"] = args.discovery_root
    runtime = DistributedRuntime(discovery_backend=args.discovery_backend,
                                 request_plane=args.request_plane, **kw)
    # weight draw and pool allocation: off the loop
    engine = await asyncio.to_thread(build_engine, args)
    worker = await serve_args(runtime, engine, args)
    path = f"{args.namespace}/{args.component}/{args.endpoint}"
    print(f"worker serving {worker.instance.metadata['model_card']['name']} at "
          f"{path} ({worker.instance.address})", flush=True)
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, stop.set)
    try:
        await stop.wait()
        print("draining...", flush=True)
    finally:
        # unregister first (clients stop picking this instance), let the
        # in-flight requests finish, then stop the engine
        await runtime.shutdown()
        await worker.stop()


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    asyncio.run(async_main(parse_args(argv)))


if __name__ == "__main__":
    main()
