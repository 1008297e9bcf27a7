"""Tensor parallelism with ranks as processes, on the CPU: the engine at TP
2 against the JAX package and the TP 1 engine, the refusals and the
layout check across ranks (the forward pass: tests/test_torch_tp_forward.py;
the KV wire and the worker: tests/test_torch_tp_served.py).

One follower (rank 1) is spawned for the module and serves every runner
the tests build through parallel/group.py MirroredRunner (rank 0 is this
process); gloo carries the collectives. The JAX side runs as its own tests
run it, with `MeshConfig(model=2)` on the host CPU devices of
tests/conftest.py. Params are the JAX init trees at f32, carried across
with params_from_numpy; each rank cuts its own slices.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.engine import InferenceEngine as JaxEngine
from dynamo_tpu.engine.model_runner import ModelRunner as JaxRunner
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.config import get_config as jax_get_config
from dynamo_tpu.parallel.mesh import MeshConfig as JaxMesh
from dynamo_tpu.runtime.context import Context as JaxContext
from dynamo_tpu_torch.engine.engine import InferenceEngine
from dynamo_tpu_torch.engine.model_runner import BucketOverflowError, ModelRunner
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.frontend.tokenizer import ByteTokenizer
from dynamo_tpu_torch.models.config import get_config
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.sanitizer import Sanitizer
from dynamo_tpu_torch.parallel.group import (
    MirroredRunner,
    shutdown_followers,
    spawn_followers,
)

pytestmark = pytest.mark.skipif(len(jax.devices()) < 2, reason="needs 2 CPU devices")

PS = 4
GEOMETRY = dict(num_pages=96, page_size=PS, max_pages_per_seq=16,
                decode_buckets=(1, 2, 4, 8), prefill_buckets=(8, 16, 32))
ENGINE = dict(max_batch=6, chunk_size=8, mixed_prefill_tokens=8,
              mixed_prefill_seqs=4, mixed_min_chunk=2)
_rng = np.random.default_rng(7)
PROMPTS = [_rng.integers(1, 500, size=n).tolist() for n in (6, 4, 9, 5, 13)]


@pytest.fixture(scope="module")
def group():
    g, procs = spawn_followers(2, "cpu")
    yield g, procs
    assert shutdown_followers(g, procs) == [0]


def _jtree(jcfg, seed):
    return jax.device_get(jllama.init_params(jcfg, jax.random.PRNGKey(seed), jnp.float32))


def _tp_runner(group, cfg, jp, **kw):
    g, procs = group
    return MirroredRunner(g, procs, config=cfg, device="cpu", dtype=torch.float32,
                          params=params_from_numpy(jp, cfg, "cpu", torch.float32),
                          **dict(GEOMETRY, **kw))


def _runner(cfg, jp, **kw):
    return ModelRunner(cfg, device="cpu", dtype=torch.float32,
                       params=params_from_numpy(jp, cfg, "cpu", torch.float32),
                       **dict(GEOMETRY, **kw))


# -- the engine --------------------------------------------------------------------


class _Stepped:
    """Stands in for the engine's step thread: the test steps the engine."""

    def join(self, timeout=None):
        pass


async def _serve(engine, reqs, ctx_cls):
    """The first request alone, the rest right after it, so chunks pack
    beside a live decode row; each finish is `length`."""
    engine._thread = _Stepped()

    async def one(req):
        toks, left = [], int(req["sampling"].get("n", 1))  # a finish a choice
        async for item in engine.generate(req, ctx_cls()):
            assert item.get("finish_reason") != "error", item
            toks.append((item.get("index", 0), item["token_ids"]))
            if item["finish_reason"]:
                assert item["finish_reason"] == "length"
                left -= 1
                if not left:
                    break
        return toks

    async def settle():
        for _ in range(4):
            await asyncio.sleep(0)

    try:
        tasks = [asyncio.ensure_future(one(reqs[0]))]
        await settle()
        engine._loop_once()
        tasks += [asyncio.ensure_future(one(r)) for r in reqs[1:]]
        while not all(t.done() for t in tasks):
            await settle()
            engine._loop_once()
        return [t.result() for t in tasks]
    finally:
        engine.stop()


def _reqs(max_tokens=6, **samp):
    return [{"token_ids": list(p), "sampling": {"temperature": 0.0, **samp},
             "stop": {"max_tokens": max_tokens, "stop_ids": []}} for p in PROMPTS]


@pytest.mark.parametrize("fused,kvq", [("1", None), ("0", None), ("1", "int8"),
                                       ("0", "int8")],
                         ids=["fused", "unfused", "fused-int8", "unfused-int8"])
async def test_engine_streams_match_jax_tp2(group, monkeypatch, fused, kvq):
    monkeypatch.setenv("DYN_FUSED_MIXED", fused)
    monkeypatch.setenv("DYN_RAGGED_MIXED", "1")
    jcfg, cfg = jax_get_config("tiny"), get_config("tiny")
    jp = _jtree(jcfg, 3)
    jrun = JaxRunner(jcfg, JaxMesh(model=2), params=jp, dtype=jnp.float32,
                     kv_quantize=kvq, **GEOMETRY)
    jres = await _serve(JaxEngine(jrun, **ENGINE), _reqs(), JaxContext)
    trun = _tp_runner(group, cfg, jp, kv_quantize=kvq)
    try:
        teng = InferenceEngine(trun, **ENGINE)
        assert teng.fused_mixed == (fused == "1")
        tres = await _serve(teng, _reqs(), Context)
        assert tres == jres
        reps = trun.rank_reports()
        assert len({r["digest"] for r in reps}) == 1 and reps[0]["outputs"] > 0
        assert reps[0]["stats"] == reps[1]["stats"]
        assert (reps[1]["stats"]["ragged_mixed_dispatches"] > 0) == (fused == "1")
    finally:
        trun.close()


@pytest.mark.parametrize("name", ["tiny-mla", "tiny-mla-moe"])
async def test_mla_engine_streams_match_jax_tp2(group, monkeypatch, name):
    """MLA (fused plans on the padded fallback: MLA has no ragged step) and
    MLA with MoE layers at TP 2: greedy streams equal to the JAX engine's
    at MeshConfig(model=2), the ranks' counters and digests equal."""
    monkeypatch.setenv("DYN_FUSED_MIXED", "1")
    jcfg, cfg = jax_get_config(name), get_config(name)
    jp = _jtree(jcfg, 12)
    jrun = JaxRunner(jcfg, JaxMesh(model=2), params=jp, dtype=jnp.float32, **GEOMETRY)
    jres = await _serve(JaxEngine(jrun, **ENGINE), _reqs(), JaxContext)
    trun = _tp_runner(group, cfg, jp)
    try:
        tres = await _serve(InferenceEngine(trun, **ENGINE), _reqs(), Context)
        assert tres == jres
        reps = trun.rank_reports()
        assert len({r["digest"] for r in reps}) == 1 and reps[0]["outputs"] > 0
        assert reps[0]["stats"] == reps[1]["stats"]
        assert reps[1]["stats"]["padded_prefill_dispatches"] > 0
        assert reps[1]["stats"]["ragged_mixed_dispatches"] == 0
    finally:
        trun.close()


async def test_ngram_spec_and_branches_match_tp1(group, monkeypatch):
    """n-gram speculation (its verify rides the ragged step) and n > 1
    branches (forked tail pages through copy_pages) at TP 2 give the TP 1
    engine's streams."""
    monkeypatch.setenv("DYN_FUSED_MIXED", "1")
    cfg = get_config("tiny")
    jp = _jtree(jax_get_config("tiny"), 4)
    motif = [7, 19, 3, 88, 41]
    reqs = [{"token_ids": motif * 4, "sampling": {"temperature": 0.0},
             "stop": {"max_tokens": 8, "stop_ids": []}},
            {"token_ids": PROMPTS[2],
             "sampling": {"temperature": 0.9, "seed": 5, "n": 2},
             "stop": {"max_tokens": 5, "stop_ids": []}}]
    want = await _serve(InferenceEngine(_runner(cfg, jp), spec_ngram=True, spec_k=3,
                                        **ENGINE), [dict(r) for r in reqs], Context)
    trun = _tp_runner(group, cfg, jp)
    try:
        got = await _serve(InferenceEngine(trun, spec_ngram=True, spec_k=3, **ENGINE),
                           [dict(r) for r in reqs], Context)
        assert got == want
        st = trun.rank_reports()[1]["stats"]
        assert st["ragged_verify_dispatches"] > 0 and st["page_copies"] > 0
    finally:
        trun.close()


def test_host_mask_between_steps_is_refused(group):
    cfg = get_config("tiny")
    trun = _tp_runner(group, cfg, _jtree(jax_get_config("tiny"), 5))
    try:
        samp = {"temperature": [0.0], "top_k": [0], "top_p": [1.0], "seeds": [0]}
        with pytest.raises(NotImplementedError, match="host.*A.14"):
            trun.decode_multi(2, [1], [0], [[0]], samp, 0, mask_fn=lambda t, p: None)
        for name in ("embed", "reload_params", "export_page_blocks", "register_adapter"):
            with pytest.raises(NotImplementedError, match="A.14"):
                getattr(trun, name)
    finally:
        trun.close()


def test_the_same_error_on_every_rank_is_raised_and_serving_goes_on(group):
    """A call whose arguments fail alike on every rank (a chunk past the
    largest prefill bucket) raises rank 0's error, and the next call is
    served on both ranks."""
    cfg = get_config("tiny")
    trun = _tp_runner(group, cfg, _jtree(jax_get_config("tiny"), 9))
    try:
        with pytest.raises(BucketOverflowError):
            trun.prefill(list(range(1, 41)), 0, list(range(10)), 0)
        assert trun.failed is None
        logits = trun.prefill([1, 2, 3], 0, [0], 0)
        assert logits.shape == (cfg.vocab_size,) and torch.isfinite(logits).all()
        assert [r["stats"]["prefill_chunks"] for r in trun.rank_reports()] == [1, 1]
    finally:
        trun.close()


def test_runner_attributes_outside_the_mirror_are_refused(group):
    """Rank 0 reads only READ_ONLY names of its own runner; any other
    runner attribute raises naming the item, and a name no runner has is
    an AttributeError, as on any object."""
    cfg = get_config("tiny")
    trun = _tp_runner(group, cfg, _jtree(jax_get_config("tiny"), 9))
    try:
        assert trun.config is cfg and trun.kv_page_shape[2] == cfg.n_kv_heads
        assert getattr(trun, "no_such_attribute", None) is None
        for name in ("draft_step", "ensure_draft_ring", "k_pool", "params", "_ragged_step"):
            with pytest.raises(NotImplementedError, match="A.14"):
                getattr(trun, name)
    finally:
        trun.close()


def test_sanitizer_checks_every_rank_layout(group):
    cfg = get_config("tiny-qwen2")
    trun = _tp_runner(group, cfg, _jtree(jax_get_config("tiny-qwen2"), 6),
                      kv_quantize="int8")
    try:
        rows = list(trun.layout_table())
        wq = next(p for n, _, p in rows if n == "params/layers/wq")
        assert wq[2:] == ((2, 64, 32), 0, -1)  # rank 0's out columns
        s = next(p for n, _, p in rows if n == "k_pool/s")
        assert s[2][-1] == 1 and s[4] == 3
        san = Sanitizer(strict=False, transfer_guard=False)
        assert san.check_layouts(trun) == 2 * len(rows)
        assert not san.violations
        trun.runner.params["layers"]["wo"] = torch.zeros(2, 64, 64)  # a whole leaf
        san.check_layouts(trun)
        assert [v for v in san.violations if "declared" in v["message"]]
    finally:
        trun.close()


async def test_guided_device_tables_match_tp1(group, monkeypatch):
    """Guided rows on the device DFA tables (the tables pickled to the
    follower with the call) at TP 2 give the TP 1 engine's streams and
    finishes, fused."""
    monkeypatch.setenv("DYN_FUSED_MIXED", "1")
    cfg = get_config("tiny")
    jp = _jtree(jax_get_config("tiny"), 8)

    def req(prompt, pattern):
        return {"token_ids": prompt, "sampling": {"temperature": 0.0},
                "stop": {"max_tokens": 12, "stop_ids": [ByteTokenizer.EOS]},
                "guided": {"kind": "regex", "pattern": pattern}}

    reqs = [req([10, 11, 12], r"[ab]{6,12}"), req([30, 31, 32], r"(yes|no) sir!"),
            req([7, 8], "(red|green|blue)")]

    async def run(runner):
        engine = InferenceEngine(runner, **ENGINE)
        engine._thread = _Stepped()

        async def one(r):
            out = []
            async for item in engine.generate(r, Context()):
                out.append((item["token_ids"], item.get("finish_reason")))
                if item.get("finish_reason"):
                    break
            return out

        tasks = []
        try:
            for r in reqs:
                # the guided compile runs in an executor: wait for each
                # request's add, so every run sees the same plans
                n = engine._inbox.qsize()
                tasks.append(asyncio.ensure_future(one(r)))
                for _ in range(1000):
                    await asyncio.sleep(0.01)
                    if engine._inbox.qsize() > n:
                        break
            while not all(t.done() for t in tasks):
                for _ in range(4):
                    await asyncio.sleep(0)
                engine._loop_once()
            return [t.result() for t in tasks]
        finally:
            engine.stop()

    want = await run(_runner(cfg, jp))
    trun = _tp_runner(group, cfg, jp)
    try:
        got = await run(trun)
        assert got == want
        assert all(out[-1][1] in ("stop", "length") for out in got)
        assert any(out[-1][1] == "stop" for out in got)  # a DFA ran to accept
        st = trun.rank_reports()[1]["stats"]
        assert st["guided_device_dispatches"] > 0 and st["guided_host_dispatches"] == 0
    finally:
        trun.close()
