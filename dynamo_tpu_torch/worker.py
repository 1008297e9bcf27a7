"""The port's worker: parse args, build the runner and the engine, and
serve it.

Port of dynamo_tpu/worker.py `parse_args`, `build_runner`, `build_engine`,
`async_main` and `main`, with the reference's names and flags:

    python -m dynamo_tpu_torch.worker --model llama-3.2-3b \
        --discovery-backend file --discovery-root DIR

registers an instance in discovery, serves `generate`, `kv_fetch`,
`kv_state`, `kv_host_fetch` and `kv_prefetch` over the request plane (TCP
unless `--request-plane inproc`),
publishes KV events and forward-pass metrics on the event plane, prints
"worker serving <model> at <ns/component/endpoint>", and on SIGTERM or
SIGINT unregisters, drains in-flight requests and exits 0. The engine
runs on CUDA unless `--device cpu`. `--draft-model PRESET --spec-gamma N`
decodes by draft-model speculation. The KV tiers: `--host-kv-blocks N`
(G2), `--disk-kv-blocks M [--disk-kv-root DIR]` (G3), `--obj-kv-root DIR`
(G4), `--kv-tier-quantize` (the int8 tier codec) and `--prefetch` (router
hints promote blocks ahead of the request). Multi-LoRA: `--lora NAME` (random
factors from a seed) or `--lora NAME=<peft_dir>` (a HuggingFace PEFT
checkpoint), repeatable, each adapter published in the model card as a
servable model; `--lora-rank` the random adapters' rank, `--lora-slots`
free slots for the `rl` endpoint's runtime `load_adapter`
(worker_common). Weights: `--checkpoint DIR` serves an HF safetensors
directory (its config.json gives the config; `--lora NAME=PEFT_DIR` is
checked against it) and `--draft-checkpoint DIR` a draft model's; without
them the weights are random, from seed 0 (a draft's from seed 1). Fast
restart, in the reference's order: `--shm-weights NAME` attaches a stage
a peer or an earlier run published in /dev/shm (engine/shm_weights.py)
when its fingerprint matches, else `--orbax-cache DIR` loads a params
snapshot (the port's own format, engine/weights.py `save_snapshot`), else
the checkpoint is read cold; then the stage is published and the
snapshot written if they were missing, and the log says which tier the
weights came from ("fast restart: attached ...", "fast restart: loading
params snapshot ..."). The rl endpoint's `update_weights` reloads a
snapshot in place, and then unlinks the stage and refreshes the snapshot
directory. Observability: `--status-port P` serves /live, /health,
/metrics, /debug/timeline (the flight recorder, `--recorder-size`, 0 =
off), /debug/traces (with DYN_TRACE_RING set), /debug/sanitizer
(`--sanitize`) and /debug/engine (the runner's counters); the anomaly
trigger (`--anomaly-k`, `--anomaly-dump-dir`, `--anomaly-dump-last-n`,
`--anomaly-profile-ms`) dumps the ring and opens a torch.profiler window;
`--profiler-port P` serves GET /profile?ms=N (a torch.profiler window of
N ms, CPU + CUDA, written as a Chrome trace; the answer is its path);
`--digest-period` publishes fleet digests (0 = off). The hub fetch (a
--checkpoint that is not a local directory), the engine sidecar,
multi-host groups, vision and the shadow failover are not ported yet.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import os
import shutil
import signal
import tempfile
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from dynamo_tpu_torch import resolve_device
from dynamo_tpu_torch.engine import shm_weights
from dynamo_tpu_torch.engine import weights
from dynamo_tpu_torch.engine.engine import InferenceEngine
from dynamo_tpu_torch.engine.model_runner import ModelRunner
from dynamo_tpu_torch.frontend.http import Response, json_response
from dynamo_tpu_torch.frontend.protocols import ModelCard
from dynamo_tpu_torch.models import lora as lora_mod
from dynamo_tpu_torch.models.config import ModelConfig, get_config
from dynamo_tpu_torch.ops import _build
from dynamo_tpu_torch.parallel.group import (
    FollowerWatch,
    MirroredRunner,
    shutdown_followers,
    spawn_followers,
    tp_check_fits,
)
from dynamo_tpu_torch.parallel.mesh import MeshConfig, check_tp, check_tp_flags
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.flight_recorder import to_chrome_trace
from dynamo_tpu_torch.runtime.logging_util import configure_logging
from dynamo_tpu_torch.runtime.status import StatusServer
from dynamo_tpu_torch.worker_common import serve_worker

log = logging.getLogger("dynamo_tpu_torch.worker")

# how long a worker that lost a tensor-parallel rank waits for its
# in-flight requests before it exits with an error
TP_DRAIN_S = 30.0


def parse_args(argv=None):
    p = argparse.ArgumentParser("dynamo_tpu_torch.worker")
    p.add_argument("--model", default="tiny", help="model config preset name")
    p.add_argument("--checkpoint", default=None,
                   help="HF safetensors checkpoint dir (config derived from its "
                        "config.json)")
    p.add_argument("--shm-weights", default=None, metavar="NAME",
                   help="host shared-memory weight staging: attach the staged "
                        "tree if a host peer published it, else load and "
                        "publish it for peers and restarts")
    p.add_argument("--orbax-cache", default=None,
                   help="params snapshot dir: load it if present, else write it "
                        "after the build (fast worker restarts; the port's own "
                        "snapshot format, not orbax's)")
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
    p.add_argument("--draft-checkpoint", default=None,
                   help="HF safetensors dir for draft weights")
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
    # multi-LoRA
    p.add_argument("--lora", action="append", default=[],
                   help="serve a LoRA adapter: NAME=<peft_dir> (HF PEFT "
                        "safetensors) or bare NAME (random factors, dev). "
                        "Repeatable; each name becomes a servable model.")
    p.add_argument("--lora-rank", type=int, default=8,
                   help="rank of the random dev adapters (the stacked tree "
                        "takes the largest rank of all)")
    p.add_argument("--lora-slots", type=int, default=0,
                   help="EXTRA free adapter slots beyond --lora specs, for "
                        "runtime registration via the rl load_adapter op")
    # KVBM tiers
    p.add_argument("--host-kv-blocks", type=int, default=0,
                   help="G2 host-DRAM KV tier capacity in blocks (0 = off)")
    p.add_argument("--disk-kv-blocks", type=int, default=0,
                   help="G3 disk KV tier capacity in blocks (needs G2 on)")
    p.add_argument("--disk-kv-root", default=None,
                   help="G3 tier directory (default: a temp dir)")
    p.add_argument("--obj-kv-root", default=None,
                   help="G4 object-store root (shared mount; enables the "
                        "terminal KV tier)")
    p.add_argument("--kv-tier-quantize", action="store_true",
                   help="store demoted G2/G3/G4 blocks as int8 + per-"
                        "(token, head) scales (~1.9x blocks per byte at "
                        "D=128); G1 device hits stay full precision")
    p.add_argument("--onboard-layer-groups", type=int, default=1,
                   help="stream tier onboarding in this many layer-group "
                        "slabs so prefill starts after the first slab "
                        "lands (1 = whole-sequence import)")
    p.add_argument("--prefetch", action="store_true",
                   help="router-hinted predictive KV promotion (needs "
                        "--host-kv-blocks > 0); advertises kv_prefetch so "
                        "routers send tier-promotion hints ahead of dispatch")
    p.add_argument("--prefetch-max-inflight", type=int, default=4,
                   help="max concurrent G3->G2 disk reads per worker")
    p.add_argument("--prefetch-bandwidth-mbps", type=float, default=0.0,
                   help="promotion bandwidth budget in MB/s (0 = unlimited)")
    p.add_argument("--prefetch-hint-ttl-s", type=float, default=10.0,
                   help="drop a hint whose request never arrives after this")
    p.add_argument("--prefetch-pin-ttl-s", type=float, default=5.0,
                   help="how long promoted blocks stay pinned against eviction")
    # disaggregation
    p.add_argument("--disagg-role", choices=["prefill", "decode"], default=None,
                   help="disaggregated role (default: aggregated)")
    p.add_argument("--disagg-chunk-pages", type=int, default=16,
                   help="decode role: P->D KV pull chunk size in pages "
                        "(0 = single message)")
    # observability
    p.add_argument("--profiler-port", type=int, default=0,
                   help="serve GET /profile?ms=N on this port: a torch.profiler "
                        "window written as a Chrome trace (0 = off); pair with "
                        "DYN_ENABLE_JAX_TRACE=1 for the engine's ranges outside "
                        "windows")
    p.add_argument("--status-port", type=int, default=0,
                   help="serve /live /health /metrics /debug/* on this port (0 = off)")
    p.add_argument("--digest-period", type=float, default=2.0,
                   help="fleet digest publish period in seconds (0 = off)")
    p.add_argument("--recorder-size", type=int, default=4096,
                   help="flight-recorder ring capacity in iterations (0 = off)")
    p.add_argument("--anomaly-k", type=float, default=4.0,
                   help="iteration wall time > EWMA*k fires the anomaly trigger "
                        "(dump + optional profile window)")
    p.add_argument("--anomaly-dump-dir", default=None,
                   help="directory for anomaly ring dumps (unset = no dumps)")
    p.add_argument("--anomaly-dump-last-n", type=int, default=256,
                   help="ring records written per anomaly dump")
    p.add_argument("--anomaly-profile-ms", type=int, default=0,
                   help="torch.profiler window on anomaly, in ms (0 = off; "
                        "traces land under the dump dir)")
    p.add_argument("--sanitize", action="store_true",
                   help="arm the runtime sanitizer: the sync guard around "
                        "steady-state dispatches, the shape tripwire, the "
                        "lock-order recorder and the pool audit (DYN_SAN=1 is "
                        "the env equivalent)")
    # parallelism (mesh axes data x model x expert): one process a rank,
    # rank 0 serves, ranks 1..N-1 are spawned followers on cuda:(rank %% cards)
    p.add_argument("--tensor-parallel", type=int, default=1,
                   help="ranks the model is cut over (KV heads or MLA heads, "
                        "FFN and expert width, embedding and head)")
    p.add_argument("--data-parallel", type=int, default=1,
                   help="replicas over a data axis: each data index mirrors its "
                        "tensor and expert peers (the reference's runner splits "
                        "no batch over it)")
    p.add_argument("--expert-parallel", type=int, default=1,
                   help="ranks a MoE model's routed experts are cut over; tokens "
                        "reach their experts by an all-to-all dispatch")
    return p.parse_args(argv)


def mesh_config(args) -> MeshConfig:
    """The mesh of the parallelism flags; raises for what is not served:
    an axis below 1, and on a mesh of more than one rank each flag of
    parallel/mesh.py TP_REFUSED, naming the item that ports it."""
    mesh = MeshConfig(data=getattr(args, "data_parallel", 1),
                      model=getattr(args, "tensor_parallel", 1),
                      expert=getattr(args, "expert_parallel", 1))
    for flag, n in (("--data-parallel", mesh.data), ("--tensor-parallel", mesh.model),
                    ("--expert-parallel", mesh.expert)):
        if n < 1:
            raise ValueError(f"{flag} {n}: at least 1")
    mesh.check_supported()
    check_tp_flags(args, mesh)
    return mesh


def _lora_kwargs(args, config: ModelConfig) -> dict:
    """The runner's LoRA arguments from the --lora specs, each loaded up
    front into `args._lora_factors` [(name, factors)] for registration:
    a repeated name is an error (it would keep the first checkpoint's
    weights), the stacked tree's rank is the largest of them (and
    --lora-rank), each smaller adapter zero-padded up to it (the padding
    adds nothing to x @ A @ B), and its targets are the union of what the
    adapters adapt. --lora-slots adds free slots for runtime loads."""
    extra = int(getattr(args, "lora_slots", 0) or 0)
    if not args.lora:
        args._lora_factors = []
        if extra > 0:
            # runtime loads only: free slots, nothing registered at boot
            return {"lora_slots": extra, "lora_rank": args.lora_rank}
        return {}
    names = [s.partition("=")[0] for s in args.lora]
    dupes = {n for n in names if names.count(n) > 1}
    if dupes:
        raise SystemExit(f"duplicate --lora adapter names: {sorted(dupes)}")
    loaded = []
    targets = set()
    for i, spec in enumerate(args.lora):
        name, _, path = spec.partition("=")
        if path:
            factors = lora_mod.load_peft_adapter(path, config)
        else:
            factors = lora_mod.random_adapter(config, rank=args.lora_rank, seed=100 + i)
        targets.update(k[:-2] for k in factors)
        loaded.append((name, factors))
    rank = max([args.lora_rank] + [f[k].shape[-1] for _, f in loaded for k in f
                                   if k.endswith("_a")])
    for _, factors in loaded:
        for k, arr in list(factors.items()):
            factors[k] = pad_rank(k, arr, rank)
    args._lora_factors = loaded
    return {"lora_slots": len(loaded) + extra, "lora_rank": rank,
            "lora_targets": tuple(sorted(targets))}


def pad_rank(name: str, arr: np.ndarray, rank: int) -> np.ndarray:
    """One factor ({t}_a [L, in, r] or {t}_b [L, r, out]) zero-padded to
    `rank`; a higher rank than the tree's raises (it cannot fit its
    slots, and truncating would change the adapter)."""
    axis = -1 if name.endswith("_a") else -2
    r = arr.shape[axis]
    if r > rank:
        raise ValueError(f"adapter rank {r} exceeds the worker's --lora-rank {rank}")
    if r == rank:
        return arr
    pad = [(0, 0)] * arr.ndim
    pad[axis] = (0, rank - r)
    return np.pad(arr, pad)


def _warm_params(args, config: ModelConfig, device: torch.device
                 ) -> tuple[Optional[Dict[str, Any]], Optional[str]]:
    """The params from the first tier that has them, as the reference's
    build_runner takes them: the shm stage when its fingerprint matches,
    else the params snapshot (a mismatch exits), else the checkpoint cold;
    (None, None) without any. Under --quantize each is quantized a row
    range at a time as it is read. The tiers below the one read are
    written as it is read, from its unquantized values: the stage (after
    a snapshot or a cold load) and the snapshot when it is absent.
    Returns (params, tier)."""
    meta = weights.weights_fingerprint(config)
    q = args.quantize
    snap_sinks = []
    if args.orbax_cache and not _snapshot_present(args):
        snap_sinks.append(weights.SnapshotWriter(args.orbax_cache, config))
    if args.shm_weights:
        stage = shm_weights.attach(args.shm_weights)
        if stage is not None:
            try:
                if stage.meta == meta:
                    log.info("fast restart: attached %d staged arrays (%.1f MB shm) as %r",
                             stage.n_arrays, stage.nbytes / 1e6, args.shm_weights)
                    t0 = time.monotonic()
                    params = _filled(lambda s: stage.tensors(device, q, s), snap_sinks)
                    log.info("copied the stage to %s in %.2fs", device,
                             time.monotonic() - t0)
                    return params, "shm"
                log.warning("shm stage %r fingerprint %s does not match model config "
                            "%s; loading cold (the publish will replace the stale "
                            "stage)", args.shm_weights, stage.meta, meta)
            finally:
                stage.close()
    stage_sinks = []
    if args.shm_weights:
        if shm_weights.available():
            stage_sinks.append(shm_weights.StageWriter(args.shm_weights, meta))
        else:
            log.warning("%s missing: shm weight staging disabled", shm_weights.SHM_DIR)
    if args.orbax_cache and not snap_sinks:
        log.info("fast restart: loading params snapshot %s", args.orbax_cache)
        t0 = time.monotonic()
        try:
            params = _filled(lambda s: weights.load_snapshot(
                args.orbax_cache, config, device, quantize=q, sinks=s), stage_sinks)
        except ValueError as e:
            raise SystemExit(f"snapshot {args.orbax_cache} does not match model config "
                             f"{config.name} ({e}); delete the snapshot to rebuild it")
        log.info("loaded the params snapshot in %.2fs", time.monotonic() - t0)
        return params, "snapshot"
    if args.checkpoint:
        log.info("loading HF checkpoint %s cold", args.checkpoint)
        args._load_stats = {}
        return (_filled(lambda s: weights.load_hf_checkpoint(
            args.checkpoint, config, device, stats=args._load_stats, quantize=q, sinks=s),
            stage_sinks + snap_sinks), "checkpoint")
    return None, None


def _filled(load, sinks):
    """`load(sinks)`'s params with every sink committed after it (the
    snapshot's "wrote" line logged), or every sink aborted when it
    raises."""
    for sink in sinks:
        if isinstance(sink, weights.SnapshotWriter):
            log.info("writing params snapshot to %s", sink.path)
    try:
        params = load(sinks)
        for sink in sinks:
            sink.commit()
    except BaseException:
        for sink in sinks:
            sink.abort()
        raise
    for sink in sinks:
        if isinstance(sink, weights.SnapshotWriter):
            log.info("wrote the params snapshot in %.2fs", sink.seconds)
    return params


def _snapshot_present(args) -> bool:
    d = args.orbax_cache
    return bool(d and os.path.isdir(d) and os.listdir(d))


def _local_checkpoint(path: str) -> str:
    if not os.path.isdir(path):
        raise FileNotFoundError(
            f"checkpoint {path!r} is not a local directory; fetching one from the "
            "hub (engine/hub.py) is not ported: it needs the network")
    return path


def build_runner(args, params=None, draft_params=None) -> tuple[ModelRunner, ModelConfig]:
    """Construct the ModelRunner and its model config from CLI args. The
    config comes from --checkpoint's config.json, else the --model preset;
    the weights from `params` (another runner's: two engines on one
    card), else the warm tiers or the checkpoint (`_warm_params`; the
    stage is published and the snapshot written when missing), else
    random from seed 0. A draft
    model's config and weights come from --draft-checkpoint, else its
    preset with random weights from seed 1, unless `draft_params` is given
    (the model's own params make a self-draft). Weights and pools that
    exceed the card's free memory raise MemoryError before anything is
    read or drawn. The --lora adapters are registered in order, slots 1
    on. `args._weights_source` says where the weights came from.

    A mesh of N > 1 ranks (--tensor-parallel x --expert-parallel x
    --data-parallel): the kernels are built here first (on a card), then
    ranks 1..N-1 spawned, and the runner is a parallel/group.py
    MirroredRunner over every rank's slice; each rank draws its slice from
    seed 0 or reads it from --checkpoint. Every card's free memory is
    checked against the bytes of all its ranks before any rank draws."""
    device = resolve_device(args.device)
    mesh = mesh_config(args)
    if args.checkpoint:
        config = weights.config_from_hf(_local_checkpoint(args.checkpoint),
                                        name=args.model_name or args.model)
    else:
        config = get_config(args.model)
    draft = args.draft_model or args.spec_draft_model
    draft_config = None
    if args.draft_checkpoint:
        draft_config = weights.config_from_hf(_local_checkpoint(args.draft_checkpoint),
                                              name=draft or "draft")
    elif draft:
        draft_config = get_config(draft)
    if mesh.n_devices > 1:
        return _build_tp_runner(args, config, device, mesh, params), config
    lora_kw = _lora_kwargs(args, config)
    args._weights_source = "shared" if params is not None else "random"
    if params is None:
        if device.type == "cuda" and (args.checkpoint or args.shm_weights or args.orbax_cache):
            # the params (their codes and scales under --quantize) beside
            # the pools
            need = weights.serving_bytes(config, args.num_pages, args.page_size,
                                         kv_quantize=args.kv_quantize,
                                         quantize=args.quantize,
                                         draft_config=draft_config,
                                         draft_params=draft_params)
            weights.check_fits(config.name, need, torch.cuda.mem_get_info(device)[0])
        params, tier = _warm_params(args, config, device)
        if tier is not None:
            args._weights_source = tier
    if draft_params is None and args.draft_checkpoint:
        draft_params = weights.load_hf_checkpoint(args.draft_checkpoint, draft_config, device)
    runner = ModelRunner(
        config,
        num_pages=args.num_pages,
        page_size=args.page_size,
        max_pages_per_seq=-(-args.max_seq_len // args.page_size),
        params=params,
        device=device,
        kv_quantize=args.kv_quantize,
        quantize=args.quantize,
        draft_config=draft_config,
        draft_params=draft_params,
        spec_gamma=args.spec_gamma,
        **lora_kw,
    )
    for name, factors in args._lora_factors:
        runner.register_adapter(name, factors)
    return runner, config


def _refresh_snapshot(src: str, cache_dir: str) -> None:
    """Replace the snapshot directory `cache_dir` by a copy of `src`,
    renamed into place (a restart never sees half a directory)."""
    if os.path.realpath(src) == os.path.realpath(cache_dir):
        return
    parent = os.path.dirname(os.path.abspath(cache_dir)) or "."
    tmp = tempfile.mkdtemp(prefix=".snapshot_swap_", dir=parent)
    try:
        new = os.path.join(tmp, "new")
        shutil.copytree(src, new)
        if os.path.exists(cache_dir):
            os.rename(cache_dir, os.path.join(tmp, "old"))
        os.rename(new, cache_dir)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _invalidate_warm_tiers(engine: InferenceEngine, args) -> None:
    """After an rl weight update the warm tiers hold the superseded
    weights, and a restart would serve them: each update unlinks the shm
    stage and replaces the snapshot directory by the new snapshot."""
    inner = engine.update_weights
    stage, cache_dir = args.shm_weights, args.orbax_cache

    async def update_and_invalidate(path: str) -> int:
        version = await inner(path)
        if stage:
            shm_weights.unlink(stage)
        if cache_dir:
            try:
                await asyncio.to_thread(_refresh_snapshot, path, cache_dir)
            except Exception:
                log.exception("snapshot refresh from %s failed: a restart would "
                              "load the superseded snapshot", path)
        log.info("warm tiers refreshed after weight update v%d", version)
        return version

    engine.update_weights = update_and_invalidate


def _build_tp_runner(args, config: ModelConfig, device: torch.device,
                     mesh: MeshConfig, params=None) -> MirroredRunner:
    """build_runner's parallel branch: config checked on the mesh, kernels
    built once (the followers load what this process built), followers
    spawned, every rank's runner built from the same arguments."""
    check_tp(config, mesh)
    kw = dict(config=config, num_pages=args.num_pages, page_size=args.page_size,
              max_pages_per_seq=-(-args.max_seq_len // args.page_size),
              device=device, kv_quantize=args.kv_quantize)
    if device.type == "cuda":
        tp_check_fits(mesh, device, dict(kw, params=params))
        _build.load()
    group, procs = spawn_followers(mesh.n_devices, device, mesh=mesh)
    log.info("%s: transport %s, followers pids %s", mesh.describe(),
             group.transport, [p.pid for p in procs])
    print(f"{mesh.describe()}: {mesh.n_devices} ranks, transport {group.transport}, "
          f"devices {[str(d) for d in group.devices]}, follower pids "
          f"{[p.pid for p in procs]}", flush=True)
    if params is not None:
        kw["params"] = params
        args._weights_source = "shared"
    elif args.checkpoint:
        kw["checkpoint_dir"] = _local_checkpoint(args.checkpoint)
        args._weights_source = "checkpoint"
    else:
        args._weights_source = "random"
    try:
        return MirroredRunner(group, procs, **kw)
    except BaseException:
        shutdown_followers(group, procs)
        raise


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
        disk_kv_blocks=args.disk_kv_blocks,
        disk_kv_root=args.disk_kv_root,
        obj_kv_root=args.obj_kv_root,
        kv_tier_quantize=args.kv_tier_quantize,
        onboard_layer_groups=args.onboard_layer_groups,
        prefetch=args.prefetch,
        prefetch_max_inflight=args.prefetch_max_inflight,
        prefetch_bandwidth_mbps=args.prefetch_bandwidth_mbps,
        prefetch_hint_ttl_s=args.prefetch_hint_ttl_s,
        prefetch_pin_ttl_s=args.prefetch_pin_ttl_s,
        tokenizer_spec=args.tokenizer,
        recorder_size=args.recorder_size,
        anomaly_k=args.anomaly_k,
        anomaly_dump_dir=args.anomaly_dump_dir,
        anomaly_dump_last_n=args.anomaly_dump_last_n,
        anomaly_profile_ms=args.anomaly_profile_ms,
        sanitize=True if args.sanitize else None,
    )
    kw.update(engine_kw)
    engine = InferenceEngine(runner, **kw)
    if args.shm_weights or args.orbax_cache:
        _invalidate_warm_tiers(engine, args)
    return engine


def model_card(args, config: ModelConfig, adapters=None) -> ModelCard:
    """The card the worker publishes in its instance metadata; its
    `adapters` (the LoRA names served as models) default to the --lora
    names."""
    if adapters is None:
        adapters = [s.partition("=")[0] for s in args.lora]
    return ModelCard(name=args.model_name or config.name, tokenizer=args.tokenizer,
                     context_length=args.max_seq_len, kv_block_size=args.page_size,
                     adapters=list(adapters),
                     runtime_config={"mesh": list(mesh_config(args).shape),
                                     "num_pages": args.num_pages,
                                     "max_batch": args.max_batch})


async def serve_args(runtime, engine, args, **kw):
    """serve_worker with the worker flags: namespace, component,
    endpoint, disaggregated role and pull chunk size."""
    return await serve_worker(
        runtime, engine, model_card(args, engine.runner.config,
                                    getattr(engine.runner, "adapter_names", None)),
        namespace=args.namespace, component=args.component, endpoint=args.endpoint,
        disagg_role=args.disagg_role, disagg_chunk_pages=args.disagg_chunk_pages,
        digest_period_s=args.digest_period, **kw)


def engine_debug(engine, instance_id: Optional[int] = None,
                 digest_pub=None) -> Dict[str, Any]:
    """GET /debug/engine: the serving instance, the runner's counters, the
    dispatched iterations, the recorder's and profiler's counters (what
    /debug/timeline's records add up to) and every hook's failures."""
    rec = engine.recorder
    failures = {f"recorder_{k}": n for k, n in rec.failures.items()}
    failures["profile_window"] = engine.profiler.failed
    if digest_pub is not None:
        failures["digest_publish"] = digest_pub.publish_failures
        failures["digest_probe"] = digest_pub.builder.probe_failures
    return {"instance": instance_id, "stats": dict(engine.runner.stats),
            "iterations": engine.iterations,
            "families": engine.runner.compile_stats(),
            "recorder": rec.stats(),
            "profiles": {"opened": engine.profiler.opened,
                         "written": engine.profiler.written,
                         "anomaly": rec.profiles_written},
            "digest": None if digest_pub is None else {
                "published": digest_pub.published, "period_s": digest_pub.period_s},
            "hook_failures": failures}


async def start_status(runtime, engine, port: int) -> StatusServer:
    """The worker's status server: health, metrics, the flight recorder's
    timeline, the sanitizer's report and the engine's counters."""
    status = StatusServer(runtime, port=port)
    status.add_check("engine", lambda: engine._thread is not None)
    rec = engine.recorder
    if rec.enabled:
        status.add_timeline(lambda last_n=None: to_chrome_trace(rec.snapshot(last_n)))
    if engine.sanitizer is not None:
        status.add_debug("sanitizer", lambda _q: engine.sanitizer.report())
    status.add_debug("engine", lambda _q: engine_debug(engine))
    await status.start()
    return status


async def start_profiler(runtime, engine, port: int, out_dir: str) -> StatusServer:
    """GET /profile?ms=N on `port`: a torch.profiler window of N ms (CPU +
    CUDA activity) opened and closed by the engine's step thread, written
    as a Chrome trace under `out_dir`; the answer names its path."""
    server = StatusServer(runtime, port=port)

    async def profile(query) -> Response:
        try:
            ms = int(query.get("ms", 1000))
        except ValueError:
            return json_response({"error": "ms must be an integer"}, status=400)
        fut = engine.profiler.request(ms, out_dir)
        path = await asyncio.wrap_future(fut)
        return json_response({"trace": path, "ms": ms})

    server.add_route("/profile", profile)
    await server.start()
    return server


async def async_main(args) -> None:
    kw = {}
    if args.discovery_root:
        kw["root"] = args.discovery_root
    runtime = DistributedRuntime(discovery_backend=args.discovery_backend,
                                 request_plane=args.request_plane, **kw)
    # weight draw and pool allocation: off the loop
    engine = await asyncio.to_thread(build_engine, args)
    loop = asyncio.get_running_loop()
    stop = asyncio.Event()
    runner = engine.runner
    tp = isinstance(runner, MirroredRunner)
    lost: list = []
    watch = None
    if tp:
        def follower_died(rank: int, code) -> None:
            log.error("parallel rank %d died (exit code %s): stopping the "
                      "worker", rank, code)
            lost.append((rank, code))
            loop.call_soon_threadsafe(stop.set)

        watch = FollowerWatch(runner._procs, follower_died)
        watch.start()
    servers = []
    if args.status_port:
        status = await start_status(runtime, engine, args.status_port)
        servers.append(status)
        print(f"status server at port {status.port}", flush=True)
    if args.profiler_port:
        out_dir = os.path.join(args.anomaly_dump_dir or tempfile.gettempdir(),
                               "profiles")
        prof = await start_profiler(runtime, engine, args.profiler_port, out_dir)
        servers.append(prof)
        print(f"profiler at port {prof.port}", flush=True)
    worker = await serve_args(runtime, engine, args)
    if args.status_port:
        iid = worker.instance.instance_id
        servers[0].add_debug("engine", lambda _q: engine_debug(engine, iid,
                                                               worker.digest_pub))
    path = f"{args.namespace}/{args.component}/{args.endpoint}"
    print(f"worker serving {worker.instance.metadata['model_card']['name']} at "
          f"{path} ({worker.instance.address})", flush=True)
    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, stop.set)
    try:
        await stop.wait()
        print("draining...", flush=True)
    finally:
        # unregister first (clients stop picking this instance), let the
        # in-flight requests finish, then stop the engine; a lost rank's
        # in-flight requests fail within the group's timeout, which bounds
        # the drain
        await runtime.shutdown()
        try:
            await asyncio.wait_for(worker.stop(), TP_DRAIN_S if lost else None)
        except asyncio.TimeoutError:
            log.error("drain still running %.0fs after a lost rank", TP_DRAIN_S)
        for server in servers:
            await server.stop()
        if tp:
            watch.stop()
            codes = shutdown_followers(runner.group, runner._procs)
            log.info("parallel followers exited: %s", codes)
    if lost:
        raise SystemExit(f"parallel rank(s) died (rank, exit code): {lost}")


def main(argv=None) -> None:
    configure_logging()
    asyncio.run(async_main(parse_args(argv)))


if __name__ == "__main__":
    main()
