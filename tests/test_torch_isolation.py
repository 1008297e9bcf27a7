"""The port stands alone: dynamo_tpu_torch, chip_smoke.py,
scripts/torch_profile.py, scripts/mla_prefill_variants.py,
scripts/int8_body_variants.py and scripts/engine_ab.py import neither JAX nor anything of the
dynamo_tpu package, nor ml_dtypes, msgpack, zmq, aiohttp, jinja2,
tokenizers or prometheus_client (the machine with the card has none of
them; the request plane frames with runtime/codec.py instead of msgpack,
and the event plane is TCP instead of ZMQ). Note the prefix:
`dynamo_tpu_torch` starts with `dynamo_tpu`.
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
             "aiohttp", "jinja2", "tokenizers", "prometheus_client")


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
              "router.protocols", "router.publisher"):
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


def test_no_source_file_imports_jax_or_dynamo_tpu():
    files = sorted(PKG.rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "scripts" / "torch_profile.py",
        ROOT / "scripts" / "mla_prefill_variants.py",
        ROOT / "scripts" / "int8_body_variants.py", ROOT / "scripts" / "engine_ab.py"]
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


def test_forbidden_prefix_rule():
    assert _forbidden("dynamo_tpu") and _forbidden("dynamo_tpu.engine")
    assert _forbidden("jax.numpy") and _forbidden("ml_dtypes")
    assert all(_forbidden(m) for m in ("msgpack", "zmq.asyncio", "aiohttp.web",
                                        "jinja2", "tokenizers", "prometheus_client"))
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
