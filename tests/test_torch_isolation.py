"""The port stands alone: dynamo_tpu_torch, chip_smoke.py,
scripts/torch_profile.py and scripts/mla_prefill_variants.py import
neither JAX nor anything of the
dynamo_tpu package, nor ml_dtypes (the machine with the card has none of
them). Note the prefix: `dynamo_tpu_torch` starts with `dynamo_tpu`.
"""

import ast
import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import dynamo_tpu_torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "dynamo_tpu_torch"


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "dynamo_tpu", "ml_dtypes")


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
              "ops.mla_attention", "models.mla"):
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
        ROOT / "scripts" / "mla_prefill_variants.py"]
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
    assert not _forbidden("dynamo_tpu_torch") and not _forbidden("dynamo_tpu_torch.ops")
