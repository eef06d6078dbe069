"""The port's sampling heads, the counterparts of tests/test_sampling.py.

The port draws from CPU ``torch.Generator``s keyed by (seed, position),
which cannot reproduce the JAX package's threefry draws, so sampled rows
are held to properties (support, determinism, independence from the slot,
the distribution's order); greedy rows are exact, against the JAX package
where a model runs.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from scope_tpu.config import CompressionConfig as JComp
from scope_tpu.config import EngineConfig as JEngine
from scope_tpu.engine.generate import generate_scan
from scope_tpu.models import llama as jllama
from scope_tpu.models.registry import TINY_LLAMA

from scope_tpu_torch import CompressionConfig, EngineConfig
from scope_tpu_torch.engine import serving
from scope_tpu_torch.engine.generate import (sample_logits,
                                             sample_logits_rowwise)
from scope_tpu_torch.models.convert import params_from_jax
from scope_tpu_torch.models.registry import get_spec


def make_logits():
    # Vocabulary of 8: token 0 dominant, then 1, 2, ... descending.
    return torch.tensor([[8.0, 6.0, 5.0, 2.0, 1.0, 0.0, -1.0, -2.0]])


def gen(i):
    return torch.Generator().manual_seed(i)


def test_greedy():
    assert int(sample_logits(make_logits())[0]) == 0


def test_temperature_sampling_distribution():
    counts = np.zeros(8)
    for i in range(200):
        counts[int(sample_logits(make_logits(), gen(i),
                                 temperature=1.0)[0])] += 1
    assert counts[0] > counts[1] > counts[3]
    assert counts.sum() == 200


def test_top_k_restricts_support():
    for i in range(100):
        assert int(sample_logits(make_logits(), gen(i), temperature=5.0,
                                 top_k=2)[0]) in (0, 1)


def test_top_p_restricts_support():
    # With top_p below the top token's mass only it survives.
    logits = torch.tensor([[10.0, 0.0, 0.0, 0.0]])
    for i in range(50):
        assert int(sample_logits(logits, gen(i), temperature=1.0,
                                 top_p=0.9)[0]) == 0


def test_top_p_keeps_at_least_one():
    logits = torch.tensor([[1.0, 1.0, 1.0, 1.0]])
    assert 0 <= int(sample_logits(logits, gen(3), temperature=1.0,
                                  top_p=0.01)[0]) < 4


def test_sample_logits_is_deterministic_per_generator():
    a = [int(sample_logits(make_logits(), gen(7), temperature=2.0)[0])
         for _ in range(5)]
    assert len(set(a)) == 1


# ---------------------- row-wise (per-slot) sampling ------------------------

def rowwise(logits, seeds, counters, t, k, p, **kw):
    B = logits.shape[0]
    return sample_logits_rowwise(
        logits, np.broadcast_to(seeds, B), np.broadcast_to(counters, B),
        np.broadcast_to(np.float32(t), B), np.broadcast_to(k, B),
        np.broadcast_to(np.float32(p), B), **kw)


def test_rowwise_greedy_rows_match_argmax():
    logits = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, 100)).astype(np.float32))
    toks = rowwise(logits, 0, 0, 0.0, 0, 1.0)
    assert torch.equal(toks, logits.argmax(-1).to(torch.int32))


def test_rowwise_topk1_is_greedy():
    logits = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (3, 50)).astype(np.float32))
    toks = rowwise(logits, np.arange(3), 0, 2.0, 1, 1.0)
    assert torch.equal(toks, logits.argmax(-1).to(torch.int32))


def test_rowwise_deterministic_per_seed_and_position():
    """The draw depends only on (seed, counter, logits), not on the row of
    the batch the request occupies."""
    rng = np.random.default_rng(2)
    row = rng.standard_normal(100).astype(np.float32)
    other = rng.standard_normal(100).astype(np.float32)

    def run(rows, pos):
        return rowwise(torch.from_numpy(np.stack(rows)), 7, pos, 1.0, 0,
                       0.95).numpy()

    assert run([row], 11)[0] == run([other, row, other], 11)[1]
    assert len({int(run([row], p)[0]) for p in range(30)}) > 1


def test_unrestricted_rowwise_samples_full_vocab():
    """top_k = 0 with top_p = 1 draws from the whole vocabulary: near-uniform
    logits over V = 512 land outside the top 64 most of the time; a
    restricted row (top_p < 1) stays inside them."""
    rng = np.random.default_rng(0)
    base = torch.from_numpy(rng.normal(0, 0.01, (1, 512)).astype(np.float32))
    top64 = set(torch.topk(base[0], 64).indices.tolist())
    outside = sum(int(rowwise(base, 0, c, 1.0, 0, 1.0, max_top_k=64)[0])
                  not in top64 for c in range(64))
    assert outside > 10
    for c in range(32):
        assert int(rowwise(base, 0, c, 1.0, 0, 0.999, max_top_k=64)[0]) \
            in top64


def test_rowwise_mixed_rows():
    """Greedy, restricted and unrestricted rows in one batch: each row keeps
    its own rule, and the greedy row is the argmax."""
    logits = torch.from_numpy(np.random.default_rng(4).normal(
        0, 0.01, (3, 512)).astype(np.float32))
    t = np.array([0.0, 1.0, 1.0], np.float32)
    k = np.array([0, 4, 0])
    p = np.ones(3, np.float32)
    top4 = set(torch.topk(logits[1], 4).indices.tolist())
    for c in range(20):
        out = sample_logits_rowwise(logits, np.zeros(3), np.full(3, c), t, k,
                                    p, max_top_k=64)
        assert int(out[0]) == int(logits[0].argmax())
        assert int(out[1]) in top4


# ------------------------------ serving ------------------------------------

@pytest.fixture(scope="module")
def weights():
    params = jllama.init_params(TINY_LLAMA, jax.random.key(0), jnp.float32)
    return params, params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                   device="cpu", dtype=torch.float32)


def test_serving_per_request_sampling(weights, monkeypatch):
    """Greedy and sampled requests coexist; sampled tokens are deterministic
    per seed and differ across seeds; the greedy row equals the JAX
    package's generate_scan, and steps with no sampled row never reach the
    sampler."""
    jp, tp = weights
    kw = dict(method="h2o", decoding_metric="none", max_capacity_prompt=64,
              window_size=8)
    ekw = dict(max_prompt_len=128, max_new_tokens=16, dtype="float32")
    prompt = np.random.default_rng(9).integers(1, 512, 90).astype(np.int32)
    calls = []
    orig = serving.sample_logits_rowwise

    def spy(logits, seeds, counters, t, *a, **k):
        calls.append(np.asarray(t).copy())
        return orig(logits, seeds, counters, t, *a, **k)

    monkeypatch.setattr(serving, "sample_logits_rowwise", spy)

    def serve(seeds, max_slots=2):
        eng = serving.ServingEngine(get_spec("tiny-llama"),
                                    CompressionConfig(**kw),
                                    EngineConfig(**ekw), tp,
                                    max_slots=max_slots, device="cpu")
        ids = [eng.submit(prompt, 8, temperature=0.0)] + [
            eng.submit(prompt, 8, temperature=1.0, top_k=20, seed=s)
            for s in seeds]
        res = eng.run()
        return [res[i] for i in ids]

    a, b = serve([1, 2]), serve([1, 2])
    assert a == b
    assert a[1] != a[2]
    assert all((t > 0).any() for t in calls)
    assert serve([1, 2], max_slots=3) == a          # slot-independent
    toks = np.zeros((1, 128), np.int32)
    toks[0, :len(prompt)] = prompt
    g, _ = generate_scan(TINY_LLAMA, JComp(**kw), JEngine(**ekw), jp,
                         jnp.asarray(toks),
                         jnp.array([len(prompt)], jnp.int32), 8, -1)
    np.testing.assert_array_equal(np.asarray(g[0]), np.array(a[0]))


def test_submit_grows_sampler_top_k_bound(weights):
    eng = serving.ServingEngine(
        get_spec("tiny-llama"), CompressionConfig(method="allkv"),
        EngineConfig(max_prompt_len=128, max_new_tokens=16, dtype="float32"),
        weights[1], max_slots=1, max_top_k=8, device="cpu")
    rid = eng.submit(np.random.default_rng(0).integers(1, 512, 64)
                     .astype(np.int32), 8, temperature=0.8, top_k=100, seed=3)
    assert eng.max_top_k == 128
    assert len(eng.run()[rid]) == 8
