"""The port's ragged paged attention (dynamo_tpu_torch/ops/
ragged_paged_attention.py) and the ragged forward against the JAX package.

The metadata builder is a copy of the reference's and must give the same
arrays and raise the same errors. The plain attention (what the wrapper
runs on CPU tensors, and what the CUDA kernel is held against on the
card) must equal the Pallas kernel run in interpret mode, at f32 to 1e-5
(the same f32 math summed in another order). The ragged forward writes
the same KV and gives the same logits as JAX `llama.forward(...,
ragged=...)` on its plain path, at atol 1e-4 (as tests/test_torch_model.py).
The runner's ragged step samples the same tokens as its padded [N, S]
fallback on the same mixed plans, a T-bucket overflow included, and its
chunk logits agree to 1e-5: the two paths run the same f32 math, but the
CPU BLAS sums a one-row product (the ragged path's per-token attention)
in another order than a many-row one, so the last bit may differ.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.config import get_config as jax_get_config
from dynamo_tpu.ops import ragged_paged_attention as jrag
from dynamo_tpu_torch.engine.model_runner import ModelRunner
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.models.config import get_config
from dynamo_tpu_torch.models.toolkit import make_kv_pool
from dynamo_tpu_torch.ops import ragged_paged_attention as rag

TOL = dict(atol=1e-5, rtol=1e-5)

# (q_lens, q_starts, kv_lens, t_bucket): the layouts a ragged dispatch takes
LAYOUTS = {
    "decode_only": ([1, 1, 1], [11, 0, 30], [12, 1, 31], 8),
    # chunks crossing q-block boundaries, prior context, a tail
    "chunks": ([1, 1, 9, 16], [11, 0, 0, 8], [12, 1, 9, 24], 32),
    "exact_fit": ([3, 13], [0, 5], [3, 18], 16),
    # verify rows: K+1 = 5 tokens per speculating sequence, then a chunk
    "verify": ([5, 5, 1, 7], [20, 3, 9, 0], [25, 8, 10, 7], 24),
}


def _rows(rng, n, NP, MP):
    perm = rng.permutation(NP)
    return [perm[i * MP:(i + 1) * MP].astype(np.int32).tolist() for i in range(n)]


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("q_block", [4, 8])
def test_metadata_matches_jax(layout, q_block):
    q_lens, q_starts, kv_lens, tb = LAYOUTS[layout]
    rows = _rows(np.random.default_rng(0), len(q_lens), 64, 6)
    want = jrag.build_ragged_metadata(q_lens, q_starts, kv_lens, rows, tb,
                                      q_block=q_block, max_pages=8)
    got = rag.build_ragged_metadata(q_lens, q_starts, kv_lens, rows, tb,
                                    q_block=q_block, max_pages=8)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
    assert rag.ragged_seg_cap(tb) == jrag.ragged_seg_cap(tb)
    assert rag.ragged_work_cap(tb, q_block) == jrag.ragged_work_cap(tb, q_block)
    assert (rag.RAGGED_MAX_SEGS, rag.DEFAULT_Q_BLOCK) == \
        (jrag.RAGGED_MAX_SEGS, jrag.DEFAULT_Q_BLOCK)


@pytest.mark.parametrize("call", [
    # more tokens than the bucket, more segments than the cap, a bucket
    # that is no multiple of the q block
    lambda m: m.build_ragged_metadata([9, 9], [0, 0], [9, 9], [[1], [2]], 16),
    lambda m: m.build_ragged_metadata([1] * 5, [0] * 5, [1] * 5, [[1]] * 5, 8,
                                      max_segs=4),
    lambda m: m.ragged_work_cap(20, 8),
])
def test_metadata_overflow_raises_like_jax(call):
    with pytest.raises(ValueError) as want:
        call(jrag)
    with pytest.raises(ValueError) as got:
        call(rag)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_token_index_matches_metadata(layout):
    """The per-token segment and position the port derives on the device
    from `meta` agree with the builder's host arrays."""
    q_lens, q_starts, kv_lens, tb = LAYOUTS[layout]
    rows = _rows(np.random.default_rng(1), len(q_lens), 64, 6)
    md = rag.build_ragged_metadata(q_lens, q_starts, kv_lens, rows, tb,
                                   max_pages=8)
    seg, pos = rag.ragged_token_index(torch.from_numpy(md["meta"]), tb)
    n = sum(q_lens)
    real = np.repeat(np.arange(len(q_lens)), q_lens)
    np.testing.assert_array_equal(seg[:n].numpy(), real)
    np.testing.assert_array_equal(pos[:n].numpy(), md["tok_positions"][:n])
    # the tail belongs to the dummy segment, whose kv_len is 0
    assert np.all(seg[n:].numpy() == len(q_lens))
    assert np.all(md["seg_kv_lens"][seg[n:].numpy()] == 0)


def _case(layout, seed, Hk=2, G=3, D=32, NP=48, PS=8, MP=6):
    q_lens, q_starts, kv_lens, tb = LAYOUTS[layout]
    rng = np.random.default_rng(seed)
    rows = _rows(rng, len(q_lens), NP, MP)
    q = rng.standard_normal((tb, Hk, G, D)).astype(np.float32)
    kp = rng.standard_normal((NP, PS, Hk, D)).astype(np.float32)
    vp = rng.standard_normal((NP, PS, Hk, D)).astype(np.float32)
    md = rag.build_ragged_metadata(q_lens, q_starts, kv_lens, rows, tb,
                                   max_pages=MP)
    return q, kp, vp, md, sum(q_lens)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_plain_matches_jax_kernel(layout):
    q, kp, vp, md, n = _case(layout, 20)
    ops = [md[k] for k in ("seg_page_table", "seg_kv_lens", "meta")]
    want = np.asarray(jrag.ragged_paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        *map(jnp.asarray, ops), interpret=True))
    t = torch.from_numpy
    before = rag.ragged_paged_attention.launches
    got = rag.ragged_paged_attention(t(q), t(kp), t(vp), *map(t, ops)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert np.all(got[n:] == 0.0)  # tail rows: exactly 0, not NaN
    # CPU tensors run the plain version: no kernel launch is counted
    assert rag.ragged_paged_attention.launches == before


def test_plain_ignores_table_tail():
    """Entries past a segment's kv_len may point anywhere."""
    q, kp, vp, md, _ = _case("chunks", 21)
    t = torch.from_numpy
    ops = [t(md[k]) for k in ("seg_page_table", "seg_kv_lens", "meta")]
    a = rag.ragged_paged_attention_ref(t(q), t(kp), t(vp), *ops)
    pt = ops[0].clone()
    pt[:, 4:] = 0  # kv_lens <= 24 tokens = 3 pages of 8
    b = rag.ragged_paged_attention_ref(t(q), t(kp), t(vp), pt, *ops[1:])
    torch.testing.assert_close(a, b, atol=0, rtol=0)


# -- the ragged forward ----------------------------------------------------

NP, PS, MP = 24, 4, 8


def test_ragged_forward_matches_jax():
    """Two dispatches: 2 fresh prefills, then 2 decode rows (their next
    tokens) + a chunk over prior context + a fresh chunk, with a tail."""
    import jax

    jcfg = jax_get_config("tiny")
    cfg = get_config("tiny")
    jparams = jax.device_get(jllama.init_params(jcfg, jax.random.PRNGKey(0),
                                                jnp.float32))
    tparams = params_from_numpy(jparams, cfg, "cpu", torch.float32)
    jk, jv = jllama.make_kv_pool(jcfg, NP, PS, jnp.float32)
    tk, tv = make_kv_pool(cfg, NP + 1, PS, torch.float32, "cpu")
    rng = np.random.default_rng(5)
    rows = _rows(rng, 4, NP - 1, 5)
    steps = [
        # (q_lens, q_starts, segment rows, t_bucket)
        ([7, 10], [0, 0], [0, 1], 24),
        ([1, 1, 6, 9], [7, 10, 0, 0], [0, 1, 2, 3], 24),
        ([1, 1, 5], [8, 11, 6], [0, 1, 2], 16),
    ]
    t = torch.from_numpy
    for q_lens, q_starts, segs, tb in steps:
        kv_lens = [s + n for s, n in zip(q_starts, q_lens)]
        md = rag.build_ragged_metadata(
            q_lens, q_starts, kv_lens, [rows[s] for s in segs], tb,
            max_pages=MP)
        seg_cap = md["seg_page_table"].shape[0]
        gather = np.zeros(seg_cap, np.int32)
        gather[:len(q_lens)] = md["last_index"]
        tok = np.zeros((1, tb), np.int32)
        tok[0, :sum(q_lens)] = rng.integers(0, cfg.vocab_size, sum(q_lens))
        pos = md["tok_positions"][None]
        ragged = [md[k] for k in ("seg_page_table", "seg_kv_lens", "meta")]
        jl, jk, jv = jllama.forward(
            jcfg, jparams, jnp.asarray(tok), jnp.asarray(pos), jk, jv,
            jnp.asarray(md["tok_page_table"]), jnp.asarray(md["tok_kv_lens"]),
            jnp.asarray(gather), attn_impl="jnp",
            ragged=tuple(map(jnp.asarray, ragged)))
        for impl in ("kernel", "ref"):
            pools = (tk, tv) if impl == "kernel" else (tk.clone(), tv.clone())
            tl = llama.forward(cfg, tparams, t(tok), t(pos), *pools,
                               last_index=t(gather), attn_impl=impl,
                               ragged=tuple(map(t, ragged)))
            n = len(q_lens)
            assert tl.shape == (1, seg_cap, cfg.vocab_size)
            np.testing.assert_allclose(tl[0, :n].numpy(), np.asarray(jl)[0, :n],
                                       atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(tk[:, :NP].numpy(), np.asarray(jk),
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(tv[:, :NP].numpy(), np.asarray(jv),
                                   atol=1e-5, rtol=1e-5)


# -- the runner: ragged step against the padded fallback --------------------


def _mk_runner(monkeypatch, ragged):
    monkeypatch.setenv("DYN_RAGGED_MIXED", "1" if ragged else "0")
    return ModelRunner(
        get_config("tiny"), num_pages=96, page_size=4, max_pages_per_seq=16,
        decode_buckets=(1, 2, 4), prefill_buckets=(8, 16),
        dtype=torch.float32, device="cpu")


def _run_mixed_plan(r):
    """One prefill round, then a packed mixed iteration (2 decode rows +
    2 chunks) and a single-chunk mixed iteration, all pages disjoint
    (tests/test_ragged_mixed.py `_run_mixed_plan`)."""
    pts = [list(range(i * 4, (i + 1) * 4)) for i in range(4)]
    prompts = [[4, 2, 4, 2, 7, 5], [9, 8, 7, 1]]
    feed = [int(torch.argmax(r.prefill(p, 0, pts[i], 0)))
            for i, p in enumerate(prompts)]
    sampling = {"temperature": [0.0, 0.0], "top_k": [0, 0],
                "top_p": [1.0, 1.0], "seeds": [11, 22]}
    chunks = [
        {"tokens": [1, 2, 3, 4, 5, 6, 7], "start": 0, "table": pts[2],
         "prior": 0},
        {"tokens": [3, 1, 4], "start": 0, "table": pts[3], "prior": 0},
    ]
    toks, chunk_logits = r.decode_multi_with_prefills(
        3, feed, [len(p) for p in prompts], pts[:2], sampling, 0, chunks)
    toks = np.asarray(toks)[:2]
    toks2, lg2 = r.decode_multi_with_prefill(
        2, [int(toks[0, -1]), int(toks[1, -1])],
        [len(prompts[0]) + 3, len(prompts[1]) + 3], pts[:2], sampling, 3,
        [5, 6, 7, 8], 3, pts[3], 3)
    assert chunk_logits.shape == (2, r.config.vocab_size)
    return (toks, chunk_logits.numpy(), np.asarray(toks2)[:2], lg2.numpy())


def _assert_same_plan_results(want, got):
    for a, b in zip(want, got):
        if a.dtype == np.float32:  # chunk logits
            np.testing.assert_allclose(b, a, **TOL)
        else:  # sampled tokens
            np.testing.assert_array_equal(b, a)


def test_runner_ragged_matches_padded(monkeypatch):
    padded_runner = _mk_runner(monkeypatch, ragged=False)
    padded = _run_mixed_plan(padded_runner)
    r = _mk_runner(monkeypatch, ragged=True)
    ragged = _run_mixed_plan(r)
    _assert_same_plan_results(padded, ragged)
    assert r.stats["ragged_mixed_dispatches"] == 2
    assert r.stats["padded_prefill_dispatches"] == 0
    assert padded_runner.stats["padded_prefill_dispatches"] == 2
    # each fused plan ran its decode tail in the decode loop: 2 + 1 steps
    assert r.stats["decode_steps"] == padded_runner.stats["decode_steps"] - 2


def test_runner_t_bucket_overflow_falls_back(monkeypatch, caplog):
    """A plan past every T bucket takes the padded fallback (one logged
    warning) and gives the same bytes; a plan that fits stays ragged."""
    padded = _run_mixed_plan(_mk_runner(monkeypatch, ragged=False))
    r = _mk_runner(monkeypatch, ragged=True)
    r.ragged_buckets = (8,)  # 2 decode rows + 10 chunk tokens won't fit
    with caplog.at_level("WARNING"):
        out = _run_mixed_plan(r)
    _assert_same_plan_results(padded, out)
    assert r.stats["padded_prefill_dispatches"] == 1
    assert r.stats["ragged_mixed_dispatches"] == 1
    assert sum("padded fallback" in m for m in caplog.messages) == 1


def test_verify_rows_sample_each_position(monkeypatch):
    """verify_spec on the ragged step: a row's K+1 samples are the greedy
    continuation at each verify position, i.e. what plain decode feeding
    the draft would sample; a chunk rides the same dispatch."""
    r = _mk_runner(monkeypatch, ragged=True)
    pts = [list(range(i * 4, (i + 1) * 4)) for i in range(3)]
    prompt = [4, 2, 4, 2, 7, 5]
    first = int(torch.argmax(r.prefill(prompt, 0, pts[0], 0)))
    greedy = {"temperature": [0.0], "top_k": [0], "top_p": [1.0], "seeds": [3]}
    draft = [9, 9, 1]
    chunk = {"tokens": [1, 2, 3], "start": 0, "table": pts[1], "prior": 0}
    rows, chunk_logits = r.verify_spec([first], [len(prompt)], pts[:1],
                                       [draft], greedy, 1, chunks=[chunk])
    assert r.stats["ragged_verify_dispatches"] == 1
    assert chunk_logits.shape == (1, r.config.vocab_size)
    # the same tokens fed one by one through the decode path
    r2 = _mk_runner(monkeypatch, ragged=True)
    r2.prefill(prompt, 0, pts[0], 0)
    fed = [first] + draft
    want = [int(r2.decode([t], [len(prompt) + j], pts[:1], greedy, 1 + j)[0])
            for j, t in enumerate(fed)]
    assert rows[0].tolist() == want
    want_chunk = r2.prefill(chunk["tokens"], 0, pts[1], 0)
    np.testing.assert_allclose(chunk_logits[0].numpy(), want_chunk.numpy(),
                               atol=1e-5, rtol=1e-5)
