"""The port's KV wire format and transfer methods against the JAX package.

A JAX ModelRunner and the port's runner hold the same tiny params
(params_from_numpy). KV pages prefilled on one side and exported
(`export_pages`, wire layout v2) import into the other side's pool bit for
bit, in f32 and in bf16, and the two packages' payloads carry identical
metadata and bytes. The layer-streamed import gives the same pool for
every group count, and a payload of another layout version, page geometry
or element type is refused with KvWireLayoutMismatch.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import model_runner as jmr
from dynamo_tpu.engine.model_runner import ModelRunner as JaxRunner
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.config import get_config as jax_get_config
from dynamo_tpu_torch.engine import model_runner as tmr
from dynamo_tpu_torch.engine.model_runner import ModelRunner
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.models.config import get_config

GEOMETRY = dict(num_pages=32, page_size=4, max_pages_per_seq=16,
                decode_buckets=(1, 2, 4), prefill_buckets=(8, 16, 32))
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
PROMPT = list(np.random.default_rng(0).integers(1, 500, size=14))
SRC, DST = [3, 7, 1, 9], [5, 0, 2, 8]  # 14 tokens = 4 pages of 4


@pytest.fixture(scope="module")
def jparams():
    """The JAX init tree in each element type, as numpy."""
    return {name: jax.device_get(jllama.init_params(
        jax_get_config("tiny"), jax.random.PRNGKey(0), jdt))
        for name, (jdt, _) in DTYPES.items()}


def _runners(jparams, name):
    jdt, tdt = DTYPES[name]
    jparams = jparams[name]
    jrun = JaxRunner(jax_get_config("tiny"), params=jparams, dtype=jdt, **GEOMETRY)
    cfg = get_config("tiny")
    trun = ModelRunner(cfg, device="cpu", dtype=tdt,
                       params=params_from_numpy(jparams, cfg, "cpu", tdt),
                       **GEOMETRY)
    return jrun, trun


def _jax_pages(pool, pages):
    return np.asarray(jax.device_get(pool))[:, pages].astype(np.float32)


def _port_pages(pool, pages):
    return pool[:, pages].float().numpy()


def _meta(payload):
    return {k: v for k, v in payload.items() if k not in ("k", "v")}


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_jax_export_imports_into_port(jparams, name):
    jrun, trun = _runners(jparams, name)
    jrun.prefill([int(t) for t in PROMPT], 0, SRC, 0)
    payload = jrun.export_pages(SRC)
    assert payload["dtype"] == name and payload["layout"] == 2
    trun.import_pages(DST, 0, payload)
    # and the last two pages again, from payload offset 2, elsewhere
    trun.import_pages([20, 21], 2, payload)
    for jpool, tpool in ((jrun.k_pool, trun.k_pool), (jrun.v_pool, trun.v_pool)):
        want = _jax_pages(jpool, SRC)
        assert np.abs(want).sum() > 0, "the prefill must have written KV"
        np.testing.assert_array_equal(_port_pages(tpool, DST), want)
        np.testing.assert_array_equal(_port_pages(tpool, [20, 21]), want[:, 2:])
    assert trun.stats["kv_pages_imported"] == 6


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_port_export_imports_into_jax(jparams, name):
    jrun, trun = _runners(jparams, name)
    trun.prefill([int(t) for t in PROMPT], 0, SRC, 0)
    payload = trun.export_pages(SRC)
    assert trun.stats["kv_pages_exported"] == 4
    jrun.import_pages(DST, 0, payload)
    for jpool, tpool in ((jrun.k_pool, trun.k_pool), (jrun.v_pool, trun.v_pool)):
        want = _port_pages(tpool, SRC)
        assert np.abs(want).sum() > 0
        np.testing.assert_array_equal(_jax_pages(jpool, DST), want)
    # the JAX runner's export of what it imported: the same payload, byte
    # for byte, metadata included
    back = jrun.export_pages(DST)
    assert _meta(back) == _meta(payload)
    assert back["k"] == payload["k"] and back["v"] == payload["v"]


def test_payload_metadata_matches_jax():
    rng = np.random.default_rng(1)
    k = rng.standard_normal((2, 3, 4, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 3, 4, 2, 8)).astype(np.float32)
    jp = jmr.kv_arrays_to_payload(k, v)
    tp = tmr.kv_arrays_to_payload(torch.from_numpy(k), torch.from_numpy(v))
    assert tp == jp
    tk, tv = tmr.kv_payload_to_arrays(jp, (2, 4, 2, 8), "float32")
    np.testing.assert_array_equal(tk.numpy(), k)
    np.testing.assert_array_equal(tv.numpy(), v)
    for L in range(1, 9):
        for g in range(0, 10):
            assert tmr.layer_group_bounds(L, g) == jmr.layer_group_bounds(L, g)


@pytest.mark.parametrize("groups", [2, 7])
def test_layer_groups_give_identical_pools(groups):
    """A 5-layer runner: whole-sequence import vs 2 and 5 (7 clamps to L)
    layer groups land the same bytes."""
    cfg = dataclasses.replace(get_config("tiny"), n_layers=5)
    run = ModelRunner(cfg, device="cpu", dtype=torch.float32, **GEOMETRY)
    L, PS, Hk, D = run.kv_page_shape
    rng = np.random.default_rng(11)
    k = torch.from_numpy(rng.standard_normal((L, 3, PS, Hk, D)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((L, 3, PS, Hk, D)).astype(np.float32))
    payload = tmr.kv_arrays_to_payload(k, v)
    run.import_pages([1, 2, 3], 0, payload, layer_groups=1)
    assert run.stats["kv_layer_group_scatters"] == 0
    run.import_pages([4, 5, 6], 0, payload, layer_groups=groups)
    assert run.stats["kv_layer_group_scatters"] == min(groups, L)
    for pool, src in ((run.k_pool, k), (run.v_pool, v)):
        assert torch.equal(pool[:, [1, 2, 3]], src)
        assert torch.equal(pool[:, [4, 5, 6]], src)


def test_wire_mismatch_is_refused(jparams):
    _, trun = _runners(jparams, "float32")
    L, PS, Hk, D = trun.kv_page_shape
    k = torch.ones(L, 2, PS, Hk, D)
    good = tmr.kv_arrays_to_payload(k, k)
    bad_cases = [
        dict(good, layout=1),
        dict(good, shape=[L, 2, PS * 2, Hk, D // 2]),  # another page size
        dict(good, dtype="bfloat16"),  # another element type
        dict(good, dtype="torch.float32"),  # not the reference's name
    ]
    for bad in bad_cases:
        with pytest.raises(tmr.KvWireLayoutMismatch):
            trun.import_pages([1, 2], 0, bad)
    assert not trun.k_pool.any()  # nothing landed
    trun.import_pages([1, 2], 0, good)
    assert trun.k_pool[:, [1, 2]].eq(1).all()


def test_spare_page_never_crosses(jparams):
    """The pools hold one spare page (index num_pages) for padding rows'
    KV; the page geometry leaves it out and no export or import reaches it."""
    _, trun = _runners(jparams, "float32")
    assert trun.k_pool.shape[1] == GEOMETRY["num_pages"] + 1
    assert trun.kv_page_shape == (2, 4, 2, 16)
    spare = GEOMETRY["num_pages"]
    with pytest.raises(ValueError, match="outside"):
        trun.export_pages([0, spare])
    k, v = trun.export_pages_device([1])
    with pytest.raises(ValueError, match="outside"):
        trun.import_pages_device([spare], 0, k, v)


def test_device_transfer_between_runners(jparams):
    """export_pages_device / import_pages_device with an offset: the
    colocated P→D path, bit for bit."""
    _, p = _runners(jparams, "float32")
    _, d = _runners(jparams, "float32")
    p.prefill([int(t) for t in PROMPT], 0, SRC, 0)
    k, v = p.export_pages_device(SRC)
    d.import_pages_device([30, 31, 0], 1, k, v)
    assert torch.equal(d.k_pool[:, [30, 31, 0]], p.k_pool[:, SRC[1:]])
    assert torch.equal(d.v_pool[:, [30, 31, 0]], p.v_pool[:, SRC[1:]])
    assert p.stats["kv_pages_exported"] == 4 and d.stats["kv_pages_imported"] == 3
