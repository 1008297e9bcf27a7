"""The port's guided decoding against the JAX package.

- The copied modules (dynamo_tpu_torch/guided) give the reference's
  outputs exactly over the patterns and schemas of tests/test_guided.py:
  byte DFA tables, `schema_to_regex` strings, structural DFAs, tool-call
  regexes, token lifter rows (the byte tokenizer at two vocabularies) and
  device tables, single and combined (`assert_array_equal`).
- Engine guided streams (regex, JSON schema, choice, structural, a mixed
  guided and free batch) equal the JAX engine's token for token, greedy,
  fused (the ragged step and the device tables) and unfused; every
  finished output is accepted by its DFA.
- The device-table plan and the host `mask_fn` fallback (the budget cut
  to 4 cells) give byte-identical sampled streams, and the runner counts
  which one each dispatch took.
- A disaggregated decode replays the prefill's first token through its
  DFA copy (`guided_advanced`): the stream equals aggregated serving's.
- A `spec_ngram` batch mixing guided and free rows: guided rows never
  draft and ride the verify step under their mask, free rows draft; the
  streams equal the JAX engine's.
"""

import asyncio
import uuid

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dynamo_tpu_torch.guided.device_table as tdt
from dynamo_tpu.engine.engine import InferenceEngine as JaxEngine
from dynamo_tpu.engine.model_runner import ModelRunner as JaxRunner
from dynamo_tpu.frontend.tokenizer import ByteTokenizer as JaxByteTokenizer
from dynamo_tpu.guided import device_table as jdt
from dynamo_tpu.guided import json_schema as jjs
from dynamo_tpu.guided import regex_dfa as jre
from dynamo_tpu.guided import structural as jst
from dynamo_tpu.guided.token_mask import TokenLifter as JaxLifter
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.config import get_config as jax_get_config
from dynamo_tpu.runtime.context import Context as JaxContext
from dynamo_tpu_torch.engine.engine import InferenceEngine
from dynamo_tpu_torch.engine.model_runner import ModelRunner
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.frontend.protocols import ModelCard
from dynamo_tpu_torch.frontend.tokenizer import ByteTokenizer
from dynamo_tpu_torch.guided import json_schema as tjs
from dynamo_tpu_torch.guided import regex_dfa as tre
from dynamo_tpu_torch.guided import structural as tst
from dynamo_tpu_torch.guided.token_mask import TokenLifter
from dynamo_tpu_torch.models.config import get_config
from dynamo_tpu_torch.router.prefill_router import DisaggPolicy, PrefillRouter
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.discovery import MemDiscovery
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.request_plane import reset_inproc
from dynamo_tpu_torch.worker_common import serve_worker

# the patterns and schemas of tests/test_guided.py
PATTERNS = [r"-?(0|[1-9][0-9]*)", r"a{2,3}b?", r"(foo|ba[rz])+", r"[^x-z]n",
            r"\d+\.\d+", r"héllo", r"^(yes|no)$", r"abc(de)?", r"[ab]{1,4}",
            r"(yes|no) sir!", r"[ab]{3}", r"[ab]{6,12}", r"(on|off)"]
SCHEMAS = [
    {"type": "object", "properties": {"name": {"type": "string"},
                                      "age": {"type": "integer"},
                                      "tag": {"type": "string"}},
     "required": ["name", "age"], "additionalProperties": False},
    {"type": "object", "properties": {"kind": {"enum": ["a", "b"]},
                                      "v": {"anyOf": [{"type": "integer"},
                                                      {"type": "null"}]},
                                      "r": {"$ref": "#/$defs/pos"}},
     "required": ["kind", "v", "r"], "$defs": {"pos": {"type": "boolean"}}},
    {"type": "array", "items": {"type": "integer"}, "minItems": 1, "maxItems": 3},
    {"type": "string", "minLength": 2, "maxLength": 3},
    {"type": "string", "pattern": "^[A-Z]{2}$"},
    {"type": "object", "properties": {"flag": {"type": "boolean"},
                                      "n": {"type": "integer"}},
     "required": ["flag", "n"], "additionalProperties": False},
]
STRUCTURAL = {
    "triggers": ["<fn>"],
    "structures": [{"begin": "<fn>", "end": "</fn>", "schema": {
        "type": "object", "properties": {"x": {"type": "integer"}},
        "required": ["x"], "additionalProperties": False}}],
}
TOOLS = [{"type": "function", "function": {"name": "get_weather", "parameters": {
    "type": "object", "properties": {"city": {"type": "string"}},
    "required": ["city"]}}},
         {"type": "function", "function": {"name": "add", "parameters": {
             "type": "object", "properties": {"a": {"type": "integer"},
                                              "b": {"type": "integer"}}}}}]


def _same_dfa(got, want):
    np.testing.assert_array_equal(got.trans, want.trans)
    np.testing.assert_array_equal(got.accept, want.accept)
    assert got.start == want.start


@pytest.mark.parametrize("pattern", PATTERNS)
def test_regex_dfa_tables_equal(pattern):
    _same_dfa(tre.compile_regex(pattern), jre.compile_regex(pattern))
    assert tre.escape(pattern) == jre.escape(pattern)


@pytest.mark.parametrize("i", range(len(SCHEMAS)))
def test_schema_regex_and_dfa_equal(i):
    got, want = tjs.schema_to_regex(SCHEMAS[i]), jjs.schema_to_regex(SCHEMAS[i])
    assert got == want
    _same_dfa(tre.compile_regex(got), jre.compile_regex(want))


def test_generic_json_structural_and_tool_regexes_equal():
    assert tjs.GENERIC_JSON == jjs.GENERIC_JSON
    _same_dfa(tre.compile_regex(tjs.GENERIC_JSON), jre.compile_regex(jjs.GENERIC_JSON))
    _same_dfa(tst.compile_structural(STRUCTURAL), jst.compile_structural(STRUCTURAL))
    assert tjs.tool_call_regex(TOOLS) == jjs.tool_call_regex(TOOLS)
    assert (tjs.tool_call_regex(TOOLS, name="add")
            == jjs.tool_call_regex(TOOLS, name="add"))
    with pytest.raises(tjs.SchemaError):
        tjs.schema_to_regex({"$defs": {"n": {"type": "object", "properties": {
            "next": {"$ref": "#/$defs/n"}}, "required": ["next"]}},
            "$ref": "#/$defs/n"})


@pytest.mark.parametrize("vocab", [300, 512])
@pytest.mark.parametrize("pattern", [r"(yes|no) sir!", r"[ab]{6,12}", "héllo"])
def test_lifter_rows_and_device_tables_equal(vocab, pattern):
    lifter = TokenLifter.for_tokenizer(ByteTokenizer(), vocab)
    jlifter = JaxLifter.for_tokenizer(JaxByteTokenizer(), vocab)
    np.testing.assert_array_equal(lifter.tok_mat, jlifter.tok_mat)
    np.testing.assert_array_equal(lifter.tok_len, jlifter.tok_len)
    m = lifter.lift(tre.compile_regex(pattern))
    jm = jlifter.lift(jre.compile_regex(pattern))
    for s in range(m.dfa.trans.shape[0]):
        np.testing.assert_array_equal(m.allowed(s), jm.allowed(s))
        np.testing.assert_array_equal(m._row(s), jm._row(s))
    tab, jtab = tdt.build_device_table(m), jdt.build_device_table(jm)
    np.testing.assert_array_equal(tab.trans, jtab.trans)
    np.testing.assert_array_equal(tab.mask, jtab.mask)
    assert (tab.start, tab.eos_id) == (jtab.start, jtab.eos_id)
    assert tdt.build_device_table(m, max_elems=4) is None
    other = lifter.lift(tre.compile_regex("[ab]{3}"))
    jother = jlifter.lift(jre.compile_regex("[ab]{3}"))
    got = tdt.combine_tables([tab, tdt.build_device_table(other)])
    want = jdt.combine_tables([jtab, jdt.build_device_table(jother)])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# -- engine streams ---------------------------------------------------------

GEOMETRY = dict(num_pages=96, page_size=4, max_pages_per_seq=24,
                decode_buckets=(1, 2, 4, 8), prefill_buckets=(8, 16))
ENGINE = dict(max_batch=6, chunk_size=8, mixed_prefill_tokens=8,
              mixed_prefill_seqs=4, mixed_min_chunk=2)
EOS = ByteTokenizer.EOS


@pytest.fixture(scope="module")
def jparams():
    return jax.device_get(jllama.init_params(
        jax_get_config("tiny"), jax.random.PRNGKey(5), jnp.float32))


def _req(prompt, guided, max_tokens=24, temperature=0.0, seed=7):
    return {"token_ids": list(prompt),
            "sampling": {"temperature": temperature, "seed": seed},
            "stop": {"max_tokens": max_tokens, "stop_ids": [EOS]},
            "guided": guided}


def _regex(p):
    return {"kind": "regex", "pattern": p}


def _workload(temperature=0.0):
    schema = tjs.schema_to_regex(SCHEMAS[5])
    return [
        _req([10, 11, 12], _regex(r"[ab]{6,12}"), temperature=temperature),
        _req([20, 21], None, max_tokens=9, temperature=temperature),
        _req([3, 4, 5], _regex(schema), max_tokens=40, temperature=temperature),
        _req([30, 31, 32], _regex(r"(yes|no) sir!"), temperature=temperature),
        _req([7, 8], _regex("(red|green|blue)"), temperature=temperature),
        _req([40, 41, 42], {"kind": "structural", "triggers": ["<f>"], "structures": [
            {"begin": "<f>", "pattern": "(on|off)", "end": "</f>"}]},
            max_tokens=16, temperature=temperature),
    ]


class _Stepped:
    def join(self, timeout=None):
        pass


async def _serve(engine, reqs, ctx_cls):
    """Stepped by the test: the first request decodes alone, the rest
    arrive after one step, so their chunks pack beside it."""
    engine._thread = _Stepped()

    async def one(req):
        toks, finish = [], None
        async for item in engine.generate(req, ctx_cls()):
            assert item.get("finish_reason") != "error", item
            toks.extend(item["token_ids"])
            finish = item["finish_reason"] or finish
        return toks, finish

    async def settle():
        for _ in range(4):
            await asyncio.sleep(0)

    try:
        async def submit(req):
            # the guided compile runs in an executor: wait for the
            # request's "add" (at most 10 s), so requests queue in order
            # and every run sees the same plans
            n = engine._inbox.qsize()
            tasks.append(asyncio.ensure_future(one(req)))
            for _ in range(1000):
                await asyncio.sleep(0.01)
                if engine._inbox.qsize() > n:
                    return

        tasks = []
        await submit(reqs[0])
        engine._loop_once()
        for r in reqs[1:]:
            await submit(r)
        while not all(t.done() for t in tasks):
            await settle()
            engine._loop_once()
        return [t.result() for t in tasks]
    finally:
        engine.stop()


def _port_engine(jparams, **kw):
    cfg = get_config("tiny")
    runner = ModelRunner(cfg, device="cpu", dtype=torch.float32,
                         params=params_from_numpy(jparams, cfg, "cpu", torch.float32),
                         **GEOMETRY)
    return InferenceEngine(runner, **dict(ENGINE, **kw))


def _jax_engine(jparams, **kw):
    jrun = JaxRunner(jax_get_config("tiny"), params=jparams, dtype=jnp.float32,
                     **GEOMETRY)
    return JaxEngine(jrun, **dict(ENGINE, **kw))


def _accepted(req, toks, finish):
    """A finished guided output is in its DFA's language (a `stop` ended
    on EOS in an accepting state), or a prefix of it when max_tokens cut
    it."""
    g = req["guided"]
    if g is None:
        return True
    dfa = (tre.compile_regex(g["pattern"]) if g["kind"] == "regex"
           else tst.compile_structural(g))
    s = dfa.start
    for t in toks:
        if t >= 256:
            return False
        s = int(dfa.trans[s, t])
        if s < 0:
            return False
    return bool(dfa.accept[s]) if finish == "stop" else True


@pytest.mark.parametrize("fused", ["1", "0"])
async def test_guided_streams_match_jax(jparams, monkeypatch, fused):
    monkeypatch.setenv("DYN_FUSED_MIXED", fused)
    reqs = _workload()
    want = await _serve(_jax_engine(jparams), reqs, JaxContext)
    teng = _port_engine(jparams)
    got = await _serve(teng, reqs, Context)
    assert got == want
    for r, (toks, finish) in zip(reqs, got):
        assert _accepted(r, toks, finish), (r["guided"], toks, finish)
    assert got[3][1] == "stop" and bytes(got[3][0]) in (b"yes sir!", b"no sir!")
    st = teng.runner.stats
    if fused == "1":
        assert st["ragged_mixed_dispatches"] > 0 and st["padded_prefill_dispatches"] == 0
    # every schema fits the budget at this vocabulary: no host mask build
    assert st["guided_device_dispatches"] > 0
    assert st["guided_host_dispatches"] == st["guided_host_masks"] == 0


async def test_device_tables_equal_host_fallback(jparams, monkeypatch):
    monkeypatch.setenv("DYN_FUSED_MIXED", "1")
    reqs = _workload(temperature=1.0)
    dev_eng = _port_engine(jparams)
    dev = await _serve(dev_eng, reqs, Context)
    monkeypatch.setattr(tdt, "DEVICE_TABLE_MAX_ELEMS", 4)
    host_eng = _port_engine(jparams)
    host = await _serve(host_eng, reqs, Context)
    assert host == dev
    for r, (toks, finish) in zip(reqs, host):
        assert _accepted(r, toks, finish)
    d, h = dev_eng.runner.stats, host_eng.runner.stats
    assert d["guided_device_dispatches"] > 0 and d["guided_host_masks"] == 0
    assert h["guided_device_dispatches"] == 0
    assert h["guided_host_dispatches"] > 0 and h["guided_host_masks"] > 0


async def test_spec_batch_mixes_guided_and_free_rows(monkeypatch):
    monkeypatch.setenv("DYN_FUSED_MIXED", "1")
    # tests/test_torch_spec.py's params and looping prompts: drafts match
    params = jax.device_get(jllama.init_params(
        jax_get_config("tiny"), jax.random.PRNGKey(4), jnp.float32))
    motif = np.random.default_rng(11).integers(1, 500, size=5).tolist()
    reqs = [_req(motif * 3, None, max_tokens=14),
            _req([60, 61], _regex(r"[ab]{6,12}")),
            _req(motif[:3] * 4 + [9], None, max_tokens=14),
            _req([70, 71, 72], _regex("(red|green|blue)!"))]
    want = await _serve(_jax_engine(params, spec_ngram=True), reqs, JaxContext)
    teng = _port_engine(params, spec_ngram=True)
    got = await _serve(teng, reqs, Context)
    assert got == want
    for r, (toks, finish) in zip(reqs, got):
        assert _accepted(r, toks, finish)
    assert teng.spec_stats["drafted"] > 0  # the free rows drafted
    assert teng.runner.stats["ragged_verify_dispatches"] > 0


# -- disaggregated decode: guided_advanced ----------------------------------

def _runtime(realm):
    return DistributedRuntime(discovery=MemDiscovery(realm=realm),
                              event_transport="inproc", request_plane="inproc")


async def test_disagg_decode_replays_guided_advance(jparams):
    card = ModelCard(name="tiny", context_length=96, kv_block_size=4)
    req = _req(list(range(30, 50)), _regex(r"(yes|no) sir, (red|green|blue)!"),
               max_tokens=30)
    agg = _port_engine(jparams)
    try:
        want = await _serve(agg, [req], Context)
        jwant = await _serve(_jax_engine(jparams), [req], JaxContext)
        assert want == jwant
        prefill, decode = _port_engine(jparams), _port_engine(jparams)
        seen = []
        orig = decode.generate

        async def spy(request, context):
            seen.append(request.get("guided_advanced"))
            async for item in orig(request, context):
                yield item

        decode.generate = spy
        realm = uuid.uuid4().hex
        await serve_worker(_runtime(realm), prefill, card, component="prefill",
                           disagg_role="prefill")
        await serve_worker(_runtime(realm), decode, card, component="decode",
                           disagg_role="decode")
        front = _runtime(realm)
        down, pool = front.client("dyn/decode/generate"), front.client("dyn/prefill/generate")
        await down.wait_ready()
        await pool.wait_ready()
        router = PrefillRouter(down, DisaggPolicy(min_prefill_tokens=8))
        router.activate(pool, "dyn/prefill/kv_fetch")
        toks, finish = [], None
        async for item in router.generate(req, Context()):
            toks.extend(item["token_ids"])
            finish = item.get("finish_reason") or finish
        prefill.stop()
        decode.stop()
    finally:
        MemDiscovery.reset()
        reset_inproc()
    assert (toks, finish) == want[0]
    assert seen == [1]
    assert decode.runner.stats["prefill_chunks"] == 0
