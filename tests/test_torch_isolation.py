"""The port stands alone: dynamo_tpu_torch (the frontend's main, its
tool-call parser, the guided decoding copies, the observability modules
the planner's hardware sweep and the tensor-parallel ranks, rank 0's and
its spawned followers', included), chip_smoke.py, scripts/torch_profile.py,
scripts/mla_prefill_variants.py,
scripts/int8_body_variants.py, scripts/engine_ab.py,
scripts/quant_gemm_variants.py, scripts/extras_profile.py,
scripts/tier_staging_bench.py, scripts/tier_ttft_pairs.py,
scripts/lora_delta_bench.py and scripts/tp_transport_probe.py import
neither JAX nor anything of the
dynamo_tpu package, nor ml_dtypes, msgpack, zmq, aiohttp, jinja2,
tokenizers, prometheus_client, boto3, safetensors, orbax or transformers
(the machine with the card has none of them; checkpoints, PEFT adapters
and params snapshots are read and written by engine/st_io.py; the shm
weight stage's index and the request plane's frames are packed by
runtime/codec.py instead of msgpack, and the event plane is TCP instead
of ZMQ); loading a checkpoint, writing and reading a snapshot and a shm
stage load none of them either. Note the prefix: `dynamo_tpu_torch`
starts with `dynamo_tpu`.
"""

import ast
import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import dynamo_tpu_torch
from dynamo_tpu_torch.ops import _build
from dynamo_tpu_torch.ops import flash_prefill as fp
from dynamo_tpu_torch.ops import paged_attention as pa
from dynamo_tpu_torch.ops import ragged_paged_attention as rag

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "dynamo_tpu_torch"


FORBIDDEN = ("jax", "jaxlib", "dynamo_tpu", "ml_dtypes", "msgpack", "zmq",
             "aiohttp", "jinja2", "tokenizers", "prometheus_client", "boto3",
             "safetensors", "orbax", "transformers")


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def _modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(dynamo_tpu_torch.__path__,
                                              "dynamo_tpu_torch.")
    )


def test_every_module_imports_without_jax_or_dynamo_tpu():
    mods = ["dynamo_tpu_torch"] + _modules()
    for m in ("engine.engine", "engine.ngram_draft",
              "ops.ragged_paged_attention", "ops.block_copy",
              "kvbm.host_pool", "worker_common", "router.prefill_router",
              "ops.mla_attention", "models.mla", "ops.paged_attention",
              "ops.flash_prefill", "models.llama", "models.toolkit",
              "engine.weights", "worker", "models.quant", "models.moe",
              "ops.moe_dispatch", "runtime.codec", "runtime.tasks",
              "runtime.engine", "runtime.component", "runtime.discovery",
              "runtime.request_plane", "runtime.event_plane",
              "runtime.metrics", "runtime.distributed", "frontend.protocols",
              "router.protocols", "router.publisher", "runtime.pipeline",
              "router.radix_tree", "native.block_index", "router.sequences",
              "router.scheduling", "router.queue", "router.indexer",
              "router.kv_router", "frontend.tokenizer", "frontend.preprocessor",
              "frontend.backend", "frontend.migration", "frontend.request_trace",
              "frontend.service", "frontend.http", "frontend.__main__",
              "frontend.tool_calls", "guided", "guided.regex_dfa",
              "guided.json_schema", "guided.structural", "guided.token_mask",
              "guided.device_table", "ops.tier_codec", "kvbm.quant", "kvbm.disk_pool",
              "kvbm.object_store", "kvbm.prefetch", "models.lora", "engine.st_io",
              "engine.shm_weights", "runtime.tracing", "runtime.logging_util",
              "runtime.annotations", "runtime.flight_recorder", "runtime.sanitizer",
              "runtime.status", "runtime.fleet_observer", "planner",
              "planner.hw_profile", "parallel", "parallel.mesh", "parallel.group"):
        assert f"dynamo_tpu_torch.{m}" in mods
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    bad = [m for m in loaded if _forbidden(m)]
    assert not bad, bad


def test_checkpoints_snapshots_and_stages_load_nothing_forbidden(tmp_path):
    """A tiny checkpoint written by the port's own writer, loaded, written
    and read back as a params snapshot, staged in shm and attached, in a
    fresh interpreter: no forbidden module is loaded on the way."""
    code = (
        "import json, os, sys\n"
        "from pathlib import Path\n"
        "import torch\n"
        "from dynamo_tpu_torch.engine import shm_weights, st_io, weights\n"
        "from dynamo_tpu_torch.models import llama\n"
        "from dynamo_tpu_torch.models.config import get_config\n"
        "d = Path(sys.argv[1])\n"
        "cfg = get_config('tiny')\n"
        "p = llama.init_params(cfg, 0, torch.bfloat16, 'cpu')\n"
        "st_io.save_file(weights.hf_state_dict(p, cfg), d / 'model.safetensors')\n"
        "(d / 'config.json').write_text(json.dumps({'vocab_size': 512, 'hidden_size': 64,"
        " 'num_hidden_layers': 2, 'num_attention_heads': 4, 'num_key_value_heads': 2,"
        " 'intermediate_size': 128}))\n"
        "got = weights.load_hf_checkpoint(str(d), weights.config_from_hf(str(d)), 'cpu')\n"
        "weights.save_snapshot(got, str(d / 'snap'), cfg)\n"
        "weights.load_snapshot(str(d / 'snap'), cfg, 'cpu')\n"
        "name = f'iso{os.getpid()}'\n"
        "try:\n"
        "    shm_weights.publish(name, got)\n"
        "    shm_weights.attach(name).tensors('cpu')\n"
        "finally:\n"
        "    shm_weights.unlink(name)\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    bad = [m for m in loaded if _forbidden(m)]
    assert not bad, bad


def test_tensor_parallel_ranks_load_nothing_forbidden():
    """A TP 2 runner on the CPU (its follower spawned), a prefill and a
    decode through it, in a fresh interpreter: no forbidden module is
    loaded by rank 0 or by the follower."""
    code = (
        "import json, sys\n"
        "import torch\n"
        "from dynamo_tpu_torch.models.config import get_config\n"
        "from dynamo_tpu_torch.parallel import group as g\n"
        "if __name__ == '__main__':\n"
        "    grp, procs = g.spawn_followers(2, 'cpu')\n"
        "    r = g.MirroredRunner(grp, procs, config=get_config('tiny'), num_pages=16,\n"
        "                         device='cpu', dtype=torch.float32)\n"
        "    r.prefill([1, 2, 3], 0, [0], 0)\n"
        "    samp = {'temperature': [0.0], 'top_k': [0], 'top_p': [1.0], 'seeds': [0]}\n"
        "    r.decode_multi(2, [4], [3], [[0]], samp, 0)\n"
        "    grp.send_call('__modules__')\n"
        "    mods = grp.gather_objects(sorted(sys.modules))\n"
        "    r.close()\n"
        "    assert g.shutdown_followers(grp, procs) == [0]\n"
        "    print(json.dumps(sorted(set(mods[0]) | set(mods[1]))))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "dynamo_tpu_torch.parallel.group" in loaded
    bad = [m for m in loaded if _forbidden(m)]
    assert not bad, bad


def test_no_source_file_imports_jax_or_dynamo_tpu():
    files = sorted(PKG.rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "scripts" / "torch_profile.py",
        ROOT / "scripts" / "mla_prefill_variants.py",
        ROOT / "scripts" / "int8_body_variants.py", ROOT / "scripts" / "engine_ab.py",
        ROOT / "scripts" / "quant_gemm_variants.py", ROOT / "scripts" / "extras_profile.py",
        ROOT / "scripts" / "tier_staging_bench.py", ROOT / "scripts" / "tier_ttft_pairs.py",
        ROOT / "scripts" / "lora_delta_bench.py", ROOT / "scripts" / "tp_transport_probe.py"]
    assert len(files) > 10
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            bad = [n for n in names if _forbidden(n)]
            assert not bad, f"{path.relative_to(ROOT)}:{node.lineno} imports {bad}"


def test_frontend_main_help_loads_nothing_forbidden():
    """`python -m dynamo_tpu_torch.frontend --help` prints its flags, and
    the frontend's main loads no forbidden module on the way."""
    out = subprocess.run([sys.executable, "-m", "dynamo_tpu_torch.frontend", "--help"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    for flag in ("--http-host", "--http-port", "--router-mode", "--migration-limit",
                 "--disagg-min-prefill-tokens", "--busy-threshold", "--router-busy-blocks",
                 "--router-queue-depth", "--router-queue-timeout", "--router-temperature",
                 "--kv-overlap-score-weight", "--no-kv-events", "--discovery-backend",
                 "--discovery-root"):
        assert flag in out.stdout
    code = (
        "import json, sys, runpy\n"
        "sys.argv = ['x', '--help']\n"
        "try:\n"
        "    runpy.run_module('dynamo_tpu_torch.frontend', run_name='__main__')\n"
        "except SystemExit:\n"
        "    pass\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "dynamo_tpu_torch.frontend.http" in loaded
    assert not [m for m in loaded if _forbidden(m)]


def test_forbidden_prefix_rule():
    assert _forbidden("dynamo_tpu") and _forbidden("dynamo_tpu.engine")
    assert _forbidden("jax.numpy") and _forbidden("ml_dtypes")
    assert all(_forbidden(m) for m in ("msgpack", "zmq.asyncio", "aiohttp.web",
                                        "jinja2", "tokenizers", "prometheus_client",
                                        "boto3"))
    assert not _forbidden("dynamo_tpu_torch") and not _forbidden("dynamo_tpu_torch.ops")


def _gqa_call(op, D, device):
    """One Gemma-2-shaped call (window 7, soft cap 50, G 2) of `op` on
    zeros of head dim D on `device`."""
    bf = dict(dtype=torch.bfloat16, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    kp = torch.zeros(9, 4, 2, D, **bf)
    kw = dict(scale=0.0625, softcap=50.0)
    if op == "decode":
        return pa.decode_paged_attention(
            torch.zeros(2, 2, 2, D, **bf), kp, kp.clone(),
            torch.zeros(2, 4, **i32), torch.full((2,), 9, **i32), 7, **kw)
    if op == "prefill":
        ints = [torch.full((1,), n, **i32) for n in (3, 8, 11)]
        return fp.prefill_paged_attention(
            torch.zeros(1, 8, 2, 2, D, **bf), kp, kp.clone(),
            torch.zeros(1, 4, **i32), *ints, 7, **kw)
    md = rag.build_ragged_metadata([1, 5], [9, 0], [10, 5], [[1, 2, 3], [4, 5]],
                                   8, max_pages=4)
    ops = [torch.from_numpy(md[k]).to(device)
           for k in ("seg_page_table", "seg_kv_lens", "meta")]
    return rag.ragged_paged_attention(torch.zeros(8, 2, 2, D, **bf), kp,
                                      kp.clone(), *ops, 7, **kw)


@pytest.mark.parametrize("op", ["decode", "prefill", "ragged"])
def test_window_d256_wrappers_raise_unless_on_the_cpu(op, monkeypatch):
    """A windowed, soft-capped D 256 call on tensors that are not on the
    CPU (the meta device, on a machine without the CUDA toolkit) raises:
    it never computes the plain version instead, and counts no launch.
    On CPU tensors it runs the plain version. D 96 reaches the build as
    D 256 does; D 80 has no kernel."""
    fn = {"decode": pa.decode_paged_attention,
          "prefill": fp.prefill_paged_attention,
          "ragged": rag.ragged_paged_attention}[op]
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    monkeypatch.setattr(_build, "_libs", {})
    before = fn.launches
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _gqa_call(op, 256, "meta")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _gqa_call(op, 96, "meta")
    with pytest.raises(ValueError, match="no .* kernel for"):
        _gqa_call(op, 80, "meta")
    out = _gqa_call(op, 256, "cpu")
    assert out.device.type == "cpu" and torch.isfinite(out.float()).all()
    assert fn.launches == before
