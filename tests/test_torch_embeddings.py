"""The port's embedding forward and the engine's embedding requests against
the JAX package.

- `llama.encode` equals the reference's `encode` on the same tokens and
  lengths (ragged rows, padding masked) at atol 1e-5: tiny, tiny-qwen2,
  tiny-qwen3 and tiny-moe in f32, and tiny over an int8 tree the
  reference quantized, carried across by params_from_numpy.
- The engine batches embedding requests that arrive together into one
  `embed` pass, and the batched vectors equal the one-at-a-time ones and
  the JAX engine's; each vector has norm 1.
- MLA, mixed dense/MoE and Gemma-family configs are refused with the
  reference's messages.
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
from dynamo_tpu.models import quant as jquant
from dynamo_tpu.models.config import get_config as jax_get_config
from dynamo_tpu.runtime.context import Context as JaxContext
from dynamo_tpu_torch.engine.engine import InferenceEngine
from dynamo_tpu_torch.engine.model_runner import ModelRunner
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.models.config import get_config
from dynamo_tpu_torch.runtime.context import Context

GEOMETRY = dict(num_pages=32, page_size=4, max_pages_per_seq=16,
                decode_buckets=(1, 2, 4, 8), prefill_buckets=(8, 16, 32))


def _tokens(seed, lengths, S=16, vocab=500):
    rng = np.random.default_rng(seed)
    toks = np.zeros((len(lengths), S), np.int32)
    for i, n in enumerate(lengths):
        toks[i, :n] = rng.integers(1, vocab, n)
    return toks, np.asarray(lengths, np.int32)


def _trees(name, quantize=None):
    jp = jax.device_get(jllama.init_params(jax_get_config(name), jax.random.PRNGKey(6),
                                           jnp.float32))
    if quantize:
        jp = jax.device_get(jquant.quantize_params(jp, mode=quantize))
    return jp, params_from_numpy(jp, get_config(name), "cpu", torch.float32)


@pytest.mark.parametrize("name,quantize", [("tiny", None), ("tiny-qwen2", None),
                                           ("tiny-qwen3", None), ("tiny-moe", None),
                                           ("tiny", "int8")])
def test_encode_matches_jax(name, quantize):
    jp, tp = _trees(name, quantize)
    toks, lens = _tokens(1, [16, 5, 1, 11])
    want = np.asarray(jllama.encode(jax_get_config(name), jp, jnp.asarray(toks),
                                    jnp.asarray(lens)))
    got = llama.encode(get_config(name), tp, torch.from_numpy(toks),
                       torch.from_numpy(lens)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("name", ["tiny-mla", "tiny-mla-moe", "tiny-gemma2"])
def test_encode_refusals_match_jax(name):
    toks, lens = _tokens(2, [3])
    jp = jax.device_get(jllama.init_params(jax_get_config(name), jax.random.PRNGKey(0),
                                           jnp.float32))
    with pytest.raises(ValueError) as want:
        jllama.encode(jax_get_config(name), jp, jnp.asarray(toks), jnp.asarray(lens))
    tp = params_from_numpy(jp, get_config(name), "cpu", torch.float32)
    with pytest.raises(ValueError) as got:
        llama.encode(get_config(name), tp, torch.from_numpy(toks), torch.from_numpy(lens))
    assert str(got.value) == str(want.value)


async def _embed(engine, token_ids, ctx_cls=Context):
    items = [item async for item in engine.generate(
        {"token_ids": token_ids, "annotations": {"kind": "embedding"}}, ctx_cls())]
    assert len(items) == 1 and items[0]["finish_reason"] == "stop", items
    return np.asarray(items[0]["embedding"])


async def test_engine_batches_embeddings(monkeypatch):
    jp, tp = _trees("tiny")
    cfg = get_config("tiny")
    eng = InferenceEngine(ModelRunner(cfg, device="cpu", dtype=torch.float32,
                                      params=tp, **GEOMETRY), max_batch=8)
    jeng = JaxEngine(JaxRunner(jax_get_config("tiny"), params=jp, dtype=jnp.float32,
                               **GEOMETRY), max_batch=8)
    calls = []
    orig = eng.runner.embed

    def spy(lists):
        calls.append(len(lists))
        return orig(lists)

    monkeypatch.setattr(eng.runner, "embed", spy)
    inputs = [list(range(3, 3 + n)) for n in (7, 2, 13)]
    try:
        # three at once: queued together before the step thread starts
        eng._thread = object()  # not started: the requests queue first
        tasks = [asyncio.ensure_future(_embed(eng, t)) for t in inputs]
        for _ in range(10):
            await asyncio.sleep(0)
        eng._thread = None
        eng.start()
        batched = await asyncio.gather(*tasks)
        alone = [await _embed(eng, t) for t in inputs]
        ref = [await _embed(jeng, t, JaxContext) for t in inputs]
    finally:
        eng.stop()
        jeng.stop()
    assert calls == [3, 1, 1, 1]
    for b, a, r in zip(batched, alone, ref):
        assert b.shape == (cfg.dim,)
        np.testing.assert_allclose(b, a, atol=1e-6)
        np.testing.assert_allclose(b, r, atol=1e-5)
        np.testing.assert_allclose(np.linalg.norm(b), 1.0, atol=1e-5)
