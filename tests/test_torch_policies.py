"""The port's prefill policies against the JAX package's.

SnapKV's window scores and pooling, then ``compress_prefill`` for snapkv,
streamingllm, pyramidkv and headwise on the same numpy inputs and the same
capacity: float32 on the CPU, scores at 1e-6, kept index sets (read from
the gathered rows of distinct random keys), their order, lengths and
pvalid exact.  Scores are rounded so that many tie, which must break by
index as ``lax.top_k`` breaks them (SnapKV's maxpool plateaus).
"""

import math
from functools import partial

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from scope_tpu.compression import headwise as jhw
from scope_tpu.compression import policies as jpol
from scope_tpu.config import CompressionConfig as JComp
from scope_tpu.config import EngineConfig as JEngine
from scope_tpu.models import llama as jllama
from scope_tpu.models.registry import TINY_LLAMA
from scope_tpu.ops import attention as jattn

from scope_tpu_torch import CompressionConfig, EngineConfig
from scope_tpu_torch.compression import headwise as thw
from scope_tpu_torch.compression import policies as tpol
from scope_tpu_torch.models import llama as tllama
from scope_tpu_torch.models.convert import params_from_jax
from scope_tpu_torch.models.registry import get_spec
from scope_tpu_torch.ops import attention as tattn

from oracle import h2o_prefill_scores, prefill_keep_order

RNG = np.random.default_rng
B, HQ, HKV, S, D = 2, 4, 2, 128, 16
P = 64


def t(x):
    return torch.from_numpy(np.array(x))


def close(a, b, tol=1e-6):
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=tol,
                               atol=tol)


# ---------------------------------------------------------------------------
# SnapKV's scores
# ---------------------------------------------------------------------------

def test_window_colsum_matches_jax():
    """The last w real rows' softmax, column-summed, B=2 ragged."""
    rng = RNG(0)
    q = rng.standard_normal((B, HQ, S, D)).astype(np.float32)
    k = rng.standard_normal((B, HQ, S, D)).astype(np.float32)
    tl = np.array([100, 77], np.int32)
    got = tattn._window_colsum(t(q), t(k), t(tl), 8, 1 / math.sqrt(D))
    ref = jattn._window_colsum(q, k, jnp.asarray(tl), 8, 1 / math.sqrt(D))
    close(ref, got)
    # Every real window row's softmax sums to 1; pad keys get nothing.
    close(np.full((B, HQ), 8.0), got.sum(-1), 1e-5)
    assert (got[1, :, 77:] == 0).all()


@pytest.mark.parametrize("pooling", ["maxpool", "avgpool"])
@pytest.mark.parametrize("kernel_size", [7, 3])
def test_pool_scores_matches_jax(pooling, kernel_size):
    """Stride 1, kernel // 2 zero pads at both ends: avg_pool1d divides by
    the kernel, pads included; maxpool's pads never win."""
    rng = RNG(kernel_size)
    s = (np.round(rng.random((B, HQ, S)) * 6) / 6).astype(np.float32)
    s[:, :, 90:] = 0.0                      # an ineligible tail, as in use
    got = tattn.pool_scores(t(s), kernel_size, pooling)
    ref = jattn.pool_scores(jnp.asarray(s), kernel_size, pooling)
    assert got.shape == (B, HQ, S)
    close(ref, got)


def test_pool_scores_refuses_other_pooling():
    with pytest.raises(ValueError, match="pooling"):
        tattn.pool_scores(torch.zeros(1, 1, 8), 3, "minpool")


# ---------------------------------------------------------------------------
# compress_prefill
# ---------------------------------------------------------------------------

def _inputs(per_qhead, seed):
    """q [B, HQ, S, D]; k/v and scores with the cache's heads (HQ per query
    head, HKV per kv head, scores summed over each group as the model sums
    them)."""
    rng = RNG(seed)
    H = HQ if per_qhead else HKV
    q = rng.standard_normal((B, HQ, S, D)).astype(np.float32)
    k = rng.standard_normal((B, H, S, D)).astype(np.float32)
    v = rng.standard_normal((B, H, S, D)).astype(np.float32)
    cs_all = np.round(rng.random((B, H, S)) * 20).astype(np.float32)
    cs_win = (np.round(rng.random((B, H, S)) * 8) / 8).astype(np.float32)
    return q, k, v, cs_all, cs_win


def _compare(rj, rt, ck_count):
    """Lengths and pvalid identical; for each head, its first
    ck_count(b, h) slots hold the same keys and values in the same order."""
    np.testing.assert_array_equal(np.asarray(rj.length), rt.length.numpy())
    # The JAX package's streamingllm pvalid is [B, 1] (its positional
    # scores carry one head); the port's is [B, H] for every method.
    np.testing.assert_array_equal(
        np.broadcast_to(np.asarray(rj.pvalid), rt.pvalid.shape),
        rt.pvalid.numpy())
    kj, vj = np.asarray(rj.cache_k), np.asarray(rj.cache_v)
    for b in range(kj.shape[0]):
        for h in range(kj.shape[1]):
            n = ck_count(b, h)
            np.testing.assert_array_equal(kj[b, h, :n],
                                          rt.cache_k[b, h, :n].numpy())
            np.testing.assert_array_equal(vj[b, h, :n],
                                          rt.cache_v[b, h, :n].numpy())


# (method, extra knobs, true_len, layer, num_layers, capacity)
PREFILL_CASES = {
    "snapkv_maxpool": ("snapkv", dict(pooling="maxpool"), (100, 77), 0, 2,
                       128),
    "snapkv_avgpool": ("snapkv", dict(pooling="avgpool", kernel_size=5),
                       (100, 50), 1, 2, 128),
    "streamingllm": ("streamingllm", dict(window_size=32), (100, 77), 0, 2,
                     128),
    "pyramid_mid_l0": ("pyramidkv", {}, (100, 77), 0, 4, 160),
    "pyramid_mid_l1": ("pyramidkv", {}, (100, 50), 1, 4, 160),
    "pyramid_mid_l3": ("pyramidkv", {}, (111, 64), 3, 4, 160),
    "pyramid_deep_l0": ("pyramidkv", {}, (128, 120), 0, 4, 160),
    "pyramid_deep_l1": ("pyramidkv", dict(beta=4), (128, 112), 1, 4, 160),
    "pyramid_deep_l3": ("pyramidkv", {}, (120, 90), 3, 4, 160),
}


@pytest.mark.parametrize("per_qhead", [True, False])
@pytest.mark.parametrize("case", list(PREFILL_CASES))
def test_compress_prefill_matches_jax(case, per_qhead):
    method, knobs, tl, layer, L, cap = PREFILL_CASES[case]
    kw = dict(dict(method=method, max_capacity_prompt=P, window_size=8),
              **knobs)
    q, k, v, cs_all, cs_win = _inputs(per_qhead, seed=sum(tl) + layer)
    tl = np.array(tl, np.int32)
    rj = jpol.compress_prefill(
        JComp(**kw), layer, L, k, v, q,
        jattn.PrefillScores(colsum_all=cs_all, colsum_window=cs_win),
        jnp.asarray(tl), cap)
    rt = tpol.compress_prefill(
        CompressionConfig(**kw), layer, L, t(k), t(v), t(q),
        tattn.PrefillScores(colsum_all=t(cs_all), colsum_window=t(cs_win)),
        t(tl), cap)
    length = np.asarray(rj.length)
    _compare(rj, rt, lambda b, h: int(length[b]))
    if method == "pyramidkv" and tl[0] >= 2 * (P - 8):
        # The deep branch: layer budgets decay from 2(P - w) down.
        assert length[0] != P
    assert (rt.length.numpy() <= cap).all()


@pytest.mark.parametrize("layer", [0, 3])
def test_headwise_prefill_matches_jax(layer):
    """Per-query-head eviction, 4 layers: layers below
    HEADWISE_SKIP_LAYERS keep min(true_len, gap) per head; layer 3 keeps
    each head's coverage budget."""
    kw = dict(method="headwise", headwise_max_budget=64,
              headwise_min_budget=16, headwise_gamma=0.9)
    q, k, v, cs_all, _ = _inputs(True, seed=layer + 40)
    tl = np.array([120, 50], np.int32)
    cap = 128
    rj = jpol.compress_prefill(JComp(**kw), layer, 4, k, v, q,
                               jattn.PrefillScores(None, None),
                               jnp.asarray(tl), cap)
    rt = tpol.compress_prefill(CompressionConfig(**kw), layer, 4, t(k), t(v),
                               t(q), tattn.PrefillScores(None, None), t(tl),
                               cap)
    pv = np.asarray(rj.pvalid)
    _compare(rj, rt, lambda b, h: int(pv[b, h]))
    assert (rt.length.numpy() == 64).all()
    if layer < thw.HEADWISE_SKIP_LAYERS:
        assert (pv == np.minimum(tl, 64)[:, None]).all()
    else:
        assert ((pv >= 16) & (pv <= np.minimum(tl, 64)[:, None])).all()
        assert len(np.unique(pv)) > 1


def test_headwise_per_kv_head_averages_each_group():
    """Per-kv-head eviction (which the JAX package's headwise cannot run:
    its last-query product needs as many key heads as query heads): each
    kv head budgets and ranks the mean of its query heads' last-row
    softmax.  Held against a numpy oracle."""
    comp = CompressionConfig(method="headwise", headwise_max_budget=64,
                             headwise_min_budget=16, headwise_gamma=0.9)
    q, k, v, _, _ = _inputs(False, seed=7)
    tl = np.array([120, 50], np.int32)
    src, pvalid = thw.headwise_prefill_map(comp, t(q), t(k), t(tl), 128, 3)
    G = HQ // HKV
    for b in range(B):
        n = tl[b]
        logits = np.einsum("hgd,hkd->hgk",
                           q[b, :, n - 1].reshape(HKV, G, D).astype(np.float64),
                           k[b, :, :n]) / math.sqrt(D)
        p = np.exp(logits - logits.max(-1, keepdims=True))
        probs = (p / p.sum(-1, keepdims=True)).mean(1)           # [HKV, n]
        for h in range(HKV):
            srt = np.sort(probs[h])[::-1]
            budget = int(np.sum(np.cumsum(srt) <= 0.9) + 1)
            budget = min(max(budget, 16), 64, n)
            assert int(pvalid[b, h]) == budget
            order = np.argsort(-probs[h], kind="stable")[:budget]
            np.testing.assert_array_equal(src[b, h, :budget].numpy(), order)


def test_coverage_budget_matches_jax():
    rng = RNG(3)
    x = rng.random((2, 5, 48)).astype(np.float32)
    x = x / x.sum(-1, keepdims=True)
    for gamma in (0.5, 0.9, 0.95):
        np.testing.assert_array_equal(
            np.asarray(jhw.coverage_budget(jnp.asarray(x), gamma)),
            thw.coverage_budget(t(x), gamma).numpy())
    assert thw.HEADWISE_SKIP_LAYERS == jhw.HEADWISE_SKIP_LAYERS


def test_headwise_model_prefill_matches_jax():
    """tiny-llama with 4 layers (with 2, no layer would be compressed):
    pvalid per layer and head, lengths and the first token identical, the
    skip layers at min(true_len, gap)."""
    jspec = TINY_LLAMA.replace(num_layers=4, name="tiny-4l")
    tspec = get_spec("tiny-llama").replace(num_layers=4, name="tiny-4l")
    kw = dict(method="headwise", decoding_metric="none",
              headwise_max_budget=64, headwise_min_budget=16,
              headwise_gamma=0.5)
    ekw = dict(max_prompt_len=128, max_new_tokens=16, dtype="float32")
    jp = jllama.init_params(jspec, jax.random.key(2), jnp.float32)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu", dtype=torch.float32)
    toks = RNG(1).integers(0, 512, (2, 128)).astype(np.int32)
    tl = np.array([120, 100], np.int32)
    lj, cj, _ = jax.jit(partial(jllama.prefill, jspec, JComp(**kw),
                                JEngine(**ekw)))(jp, jnp.asarray(toks),
                                                 jnp.asarray(tl))
    lt, ct, _ = tllama.prefill(tspec, CompressionConfig(**kw),
                               EngineConfig(**ekw), tp, t(toks), t(tl))
    np.testing.assert_array_equal(np.asarray(cj.pvalid), ct.pvalid.numpy())
    np.testing.assert_array_equal(np.asarray(cj.length), ct.length.numpy())
    assert ct.prefill_gap == 64
    pv = ct.pvalid.numpy()
    assert (pv[:thw.HEADWISE_SKIP_LAYERS] == 64).all()
    assert (pv[3] < 64).any()
    np.testing.assert_array_equal(np.asarray(lj).argmax(-1),
                                  lt.argmax(-1).numpy())


# ---------------------------------------------------------------------------
# padding invariance (tests/test_policy_oracle.py's case)
# ---------------------------------------------------------------------------

def test_padding_invariance():
    """H2O through the port's prefill attention and compress_prefill on a
    prompt of 100 real tokens right-padded to 128 keeps exactly what the
    numpy oracle keeps from the 100 tokens alone."""
    rng = RNG(5)
    q, k, v = (rng.standard_normal((1, 4, S, D)).astype(np.float32)
               for _ in range(3))
    true, w = 100, 8
    comp = CompressionConfig(method="h2o", max_capacity_prompt=P,
                             window_size=w)
    tl = torch.tensor([true], dtype=torch.int32)
    _, scores = tattn.prefill_attention(t(q), t(k), t(v), tl, window_size=w,
                                        need_colsum_all=True)
    res = tpol.compress_prefill(comp, 0, 2, t(k), t(v), t(q), scores, tl, 96)
    sc = h2o_prefill_scores(q[0, :, :true], k[0, :, :true], w)
    keep = prefill_keep_order(sc, P - w, true, w)
    assert int(res.length[0]) == P
    for h in range(4):
        np.testing.assert_allclose(res.cache_k[0, h, :P].numpy(),
                                   k[0, h][keep[h]], rtol=1e-5, atol=1e-5)
