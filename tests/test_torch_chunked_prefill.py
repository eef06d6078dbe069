"""Chunked prefill and chunked admission, against the port's monolithic
prefill and the JAX package's ``prefill_chunked``.

tiny-llama in float32 on the CPU, one numpy weight set carried into both
packages, the knobs of tests/test_chunked_prefill.py (P=64, w=8, W=32,
r=16, delta=3, a 128-token bucket, chunks of 32): per method, the chunked
prefill's last-token logits, per-layer lengths, cache (int8 codes and
scales included) and Quest's page metadata are identical to the port's
monolithic prefill's (chunk attention runs the prefill kernel's plain
version on the chunk's rows, which depend only on their own query and the
keys before them), and equal the JAX package's chunked prefill's within
2e-5 (the JAX test's tolerance; the two packages' float32 products sum in
different orders; int8 codes at most one step apart, at rounding ties),
for a ragged batch and per kv head with int8.  Decoding continues with
identical tokens.  ``prefill_scores_only``'s plain version equals
the JAX package's.  Chunked admission in the ServingEngine gives the
monolithic engine's tokens; a sliding window is refused.
"""


import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from scope_tpu.config import CompressionConfig as JComp
from scope_tpu.config import EngineConfig as JEngine
from scope_tpu.models import llama as jllama
from scope_tpu.models.chunked_prefill import prefill_chunked as jchunked
from scope_tpu.models.registry import TINY_LLAMA
from scope_tpu.ops.attention import prefill_scores_only as jscores

from scope_tpu_torch import CompressionConfig, EngineConfig
from scope_tpu_torch.engine.serving import ServingEngine
from scope_tpu_torch.models import llama as tllama
from scope_tpu_torch.models.chunked_prefill import (ChunkedPrefiller,
                                                    prefill_chunked)
from scope_tpu_torch.models.convert import params_from_jax
from scope_tpu_torch.models.registry import get_spec
from scope_tpu_torch.ops.attention import prefill_scores_only

JSPEC = TINY_LLAMA.replace(num_layers=2)
TSPEC = get_spec("tiny-llama").replace(num_layers=2)
ATOL = 2e-5


@pytest.fixture(scope="module")
def weights():
    jp = jllama.init_params(JSPEC, jax.random.key(0), jnp.float32)
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                               device="cpu", dtype=torch.float32)


def configs(method, metric="fixed", per_qhead=True, **engine):
    kw = dict(method=method, decoding_metric=metric, max_capacity_prompt=64,
              window_size=32 if method == "streamingllm" else 8,
              decoding_window_size=32, decoding_recent_size=16, delta=3,
              chunk_size=16, evict_per_qhead=per_qhead,
              headwise_max_budget=64, headwise_min_budget=16,
              headwise_gamma=0.5)
    ekw = dict(max_prompt_len=128, max_new_tokens=64, dtype="float32",
               **engine)
    return JComp(**kw), JEngine(**ekw), CompressionConfig(**kw), \
        EngineConfig(**ekw)


def inputs(true_lens, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, 512, (len(true_lens), 128))
    for b, t in enumerate(true_lens):
        toks[b, t:] = 0
    return toks.astype(np.int32), np.asarray(true_lens, np.int32)


def as_np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_identical(ref, got):
    """Every field of the two caches, and the logits, bit for bit."""
    (lr, cr, _), (lg, cg, _) = ref, got
    assert torch.equal(lg, lr)
    for name in ("k", "v", "length", "pvalid", "prompt_len", "k_scale",
                 "v_scale", "k_off", "v_off", "page_min", "page_max"):
        a, b = getattr(cr, name), getattr(cg, name)
        assert (a is None) == (b is None), name
        assert a is None or torch.equal(a, b), name


def assert_same(ref, got, int_codes=False):
    """Logits within ATOL; lengths and pvalid equal; live K/V slots within
    ATOL (int8: codes at most one apart, few of them); Quest pages too."""
    (lr, cr, _), (lg, cg, _) = ref, got
    np.testing.assert_allclose(as_np(lg), as_np(lr), atol=ATOL, rtol=1e-5)
    np.testing.assert_array_equal(as_np(cg.length), as_np(cr.length))
    # The JAX package keeps some methods' pvalid as [L, B, 1].
    pv = as_np(cg.pvalid)
    np.testing.assert_array_equal(pv, np.broadcast_to(as_np(cr.pvalid),
                                                      pv.shape))
    lens = as_np(cr.length)
    names = ["k", "v"] + (["page_min", "page_max"]
                          if cr.page_min is not None else [])
    for name in names:
        a = as_np(getattr(cr, name)).astype(np.float32)
        b = as_np(getattr(cg, name)).astype(np.float32)
        for l in range(lens.shape[0]):
            for r in range(lens.shape[1]):
                n = lens[l, r] if name in ("k", "v") else a.shape[3]
                x, y = a[l, r, :, :n], b[l, r, :, :n]
                if int_codes:
                    assert np.abs(x - y).max() <= 1
                    assert (x != y).mean() < 0.01
                else:
                    np.testing.assert_allclose(y, x, atol=ATOL, rtol=1e-5)


# (method, per_qhead, batch true lengths, kv dtype)
CASES = [("fullkv", True, [100], "bfloat16"),
         ("h2o", True, [100], "bfloat16"),
         ("snapkv", True, [100], "bfloat16"),
         ("pyramidkv", True, [100], "bfloat16"),
         ("streamingllm", True, [100], "bfloat16"),
         ("headwise", True, [100], "bfloat16"),
         ("quest", True, [100], "bfloat16"),
         ("h2o", True, [100, 37, 64], "bfloat16"),
         ("h2o", False, [100, 80], "int8")]


@pytest.mark.parametrize("method,per_qhead,lens,kv", CASES)
def test_chunked_matches_monolithic_and_jax(weights, method, per_qhead, lens,
                                            kv):
    jp, tp = weights
    jc, je, tc, te = configs(method, per_qhead=per_qhead, kv_dtype=kv)
    toks, tl = inputs(lens)
    tt, ttl = torch.from_numpy(toks), torch.from_numpy(tl)
    mono = tllama.prefill(TSPEC, tc, te, tp, tt, ttl)
    got = ChunkedPrefiller(TSPEC, tc, te, chunk_size=32)(tp, tt, ttl)
    assert_identical(mono, got)
    ref = jchunked(JSPEC, jc, je, jp, jnp.asarray(toks), jnp.asarray(tl),
                   chunk_size=32)
    assert_same(ref, got, int_codes=kv == "int8")
    if kv == "int8":
        np.testing.assert_allclose(got[1].k_scale.numpy(),
                                   np.asarray(ref[1].k_scale), rtol=1e-5,
                                   atol=2e-6)
    if method == "quest":
        assert got[1].page_min is not None


@pytest.mark.parametrize("method", ["h2o", "quest"])
def test_chunked_decode_continues_identically(weights, method):
    """Decoding from the chunked cache gives the monolithic cache's tokens
    and lengths, step by step."""
    _, tp = weights
    _, _, tc, te = configs(method, metric="jump")
    toks, tl = inputs([100])
    tt, ttl = torch.from_numpy(toks), torch.from_numpy(tl)
    runs = []
    for lc in (tllama.prefill(TSPEC, tc, te, tp, tt, ttl),
               prefill_chunked(TSPEC, tc, te, tp, tt, ttl, chunk_size=32)):
        logits, cache, state = lc
        tok = logits.argmax(-1).to(torch.int32)
        seq, lens = [int(tok[0])], [cache.length.tolist()]
        for s in range(30):
            logits, cache, state = tllama.decode_step(
                TSPEC, tc, te, tp, tok, ttl + s, cache, state)
            tok = logits.argmax(-1).to(torch.int32)
            seq.append(int(tok[0]))
            lens.append(cache.length.tolist())
        runs.append((seq, lens))
    assert runs[0] == runs[1]


def test_prefill_scores_only_plain_matches_jax():
    """The blocked plain version against the JAX package's on ragged rows
    and a q_block that does not divide S at first."""
    rng = np.random.default_rng(4)
    q = rng.normal(size=(2, 3, 96, 16)).astype(np.float32)
    k = rng.normal(size=(2, 3, 96, 16)).astype(np.float32)
    tl = np.array([96, 41], np.int32)
    ref = jscores(jnp.asarray(q), jnp.asarray(k), jnp.asarray(tl),
                  window_size=8, need_colsum_all=True,
                  need_colsum_window=True, q_block=64)
    got = prefill_scores_only(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(tl), window_size=8,
                              need_colsum_all=True, need_colsum_window=True,
                              q_block=64)
    for name in ("colsum_all", "colsum_window"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("method,metric,chunks", [
    ("h2o", "jump", ()), ("quest", "jump", (4, 2)),
    ("pyramidkv", "jump", ())])
def test_serving_chunked_admission_matches_monolithic(weights, method,
                                                      metric, chunks):
    """One admission chunk per engine step, interleaved with decode: the
    tokens of the engine that prefills each admission at once (host mode,
    hot chunks for quest; pyramidkv on the device-cond path)."""
    _, tp = weights
    _, _, tc, te = configs(method, metric=metric, per_qhead=False,
                           decode_chunk_sizes=chunks)
    rng = np.random.default_rng(7)
    ps = [rng.integers(1, 512, n).astype(np.int32)
          for n in (100, 77, 120, 90)]
    out = []
    for chunk in (None, 32):
        eng = ServingEngine(TSPEC, tc, te, tp, max_slots=2,
                            prefill_chunk=chunk, device="cpu")
        ids = [eng.submit(p, 16) for p in ps]
        res = eng.run()
        out.append([res[i] for i in ids])
    assert out[0] == out[1]
    assert [len(t) for t in out[1]] == [16] * 4


def test_serving_snapshot_restarts_pending_prefill(weights):
    """A snapshot taken while an admission is mid-prefill: the restored
    engine restarts that prefill and finishes with the same tokens."""
    _, tp = weights
    _, _, tc, te = configs("h2o", metric="jump")
    rng = np.random.default_rng(9)
    ps = [rng.integers(1, 512, n).astype(np.int32) for n in (100, 120, 90)]
    eng = ServingEngine(TSPEC, tc, te, tp, max_slots=2, prefill_chunk=32,
                        device="cpu")
    ids = [eng.submit(p, 12) for p in ps]
    want = eng.run()
    eng = ServingEngine(TSPEC, tc, te, tp, max_slots=2, prefill_chunk=32,
                        device="cpu")
    ids2 = [eng.submit(p, 12) for p in ps]
    eng.step()
    eng.step()
    assert eng._pending_prefills and "st" in eng._pending_prefills[0]
    snap = eng.snapshot()
    fresh = ServingEngine(TSPEC, tc, te, tp, max_slots=2, prefill_chunk=32,
                          device="cpu")
    fresh.restore(snap)
    res = fresh.run()
    assert [res[i] for i in ids2] == [want[i] for i in ids]


def test_sliding_window_refused():
    spec = get_spec("tiny-mistral").replace(num_layers=2)
    _, _, tc, te = configs("fullkv")
    assert spec.sliding_window is not None
    with pytest.raises(NotImplementedError, match="item 13"):
        ChunkedPrefiller(spec, tc, te)
