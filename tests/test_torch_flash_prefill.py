"""The port's prefill kernels against the JAX package's Pallas kernels.

On the CPU the port's ``flash_prefill`` / ``colsum_scores`` wrappers run
their plain PyTorch versions; the JAX side runs the Pallas kernels in
interpret mode, called directly.  Same numpy inputs, float32.  Tolerances
are those of tests/test_pallas_kernels.py: 2e-4, and 1e-3 with logits
scaled by 8 (the online softmax sums in another order).

The CUDA kernels themselves run only on a card:
tests/test_torch_cuda_kernels.py holds them against these plain versions.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax import lax
import torch

from scope_tpu.ops.pallas import flash_prefill as pallas
from scope_tpu_torch.compression.policies import topk_indices
from scope_tpu_torch.ops import flash_prefill as port

W = 8


def make(B, H, S, D, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, H, S, D)) * scale).astype(np.float32)
    k = (rng.standard_normal((B, H, S, D)) * scale).astype(np.float32)
    v = rng.standard_normal((B, H, S, D)).astype(np.float32)
    return q, k, v


def run_both(q, k, v, tl, *, need_scores=True, sliding_window=None):
    tl = np.asarray(tl, np.int32)
    jq, jk, jv, jtl = map(jnp.asarray, (q, k, v, tl))
    out_j, m2_j, l2_j = pallas.flash_prefill(
        jq, jk, jv, jtl, window_size=W, need_scores=need_scores,
        sliding_window=sliding_window, interpret=True)
    tq, tk, tv, ttl = map(torch.from_numpy, (q, k, v, tl))
    out_t, m2_t, l2_t = port.flash_prefill(
        tq, tk, tv, ttl, window_size=W, need_scores=need_scores,
        sliding_window=sliding_window)
    res = {"out": (out_j, out_t), "m2": (m2_j, m2_t), "l2": (l2_j, l2_t)}
    if need_scores:
        cs_j = pallas.colsum_scores(jq, jk, jtl, m2_j, l2_j, window_size=W,
                                    interpret=True)
        cs_t = port.colsum_scores(tq, tk, ttl, m2_t, l2_t, window_size=W)
        res["colsum"] = (cs_j, cs_t)
    return {name: (np.asarray(a), b.numpy()) for name, (a, b) in res.items()}


def assert_rows_close(res, tl, tol):
    """out/m2/l2 at real rows, colsum at every key."""
    for b, n in enumerate(tl):
        for name in ("out", "m2", "l2"):
            a, t = res[name]
            np.testing.assert_allclose(t[b, :, :n], a[b, :, :n], rtol=tol,
                                       atol=tol, err_msg=f"{name} row {b}")
    if "colsum" in res:
        a, t = res["colsum"]
        np.testing.assert_allclose(t, a, rtol=tol, atol=tol)


def topk_agreement(res, tl, frac=0.5):
    """Kept-set agreement: the share of the top ``frac`` of keys in
    [0, true_len - w) that both sides keep, worst over (row, head)."""
    a, t = res["colsum"]
    agree = []
    for b, n in enumerate(tl):
        region = n - W
        kk = max(1, int(region * frac))
        ka = np.asarray(lax.top_k(jnp.asarray(a[b, :, :region]), kk)[1])
        kt = topk_indices(torch.from_numpy(t[b, :, :region]), kk).numpy()
        for h in range(ka.shape[0]):
            agree.append(len(np.intersect1d(ka[h], kt[h])) / kk)
    return min(agree)


CASES = {
    # name: (B, H, S, D, true_len, sliding_window)
    "b2_ragged": (2, 4, 256, 64, (256, 200), None),
    "d128": (1, 4, 256, 128, (230,), None),
    "s384": (2, 2, 384, 64, (384, 301), None),
    "window64": (1, 4, 256, 64, (256,), 64),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_pallas_interpret(case):
    B, H, S, D, tl, window = CASES[case]
    q, k, v = make(B, H, S, D, seed=len(case))
    res = run_both(q, k, v, tl, sliding_window=window)
    assert_rows_close(res, tl, 2e-4)
    assert topk_agreement(res, tl) > 0.995


def test_plain_matches_pallas_without_scores():
    q, k, v = make(2, 4, 256, 64, seed=5)
    tl = (256, 177)
    res = run_both(q, k, v, tl, need_scores=False)
    assert_rows_close(res, tl, 2e-4)
    _, m2 = res["m2"]
    _, l2 = res["l2"]
    assert (m2 == 0).all() and (l2 == 1).all()


def test_plain_matches_pallas_large_logits():
    """Logits scaled by 8: the softmaxes must stay stable and finite."""
    q, k, v = make(1, 4, 256, 64, seed=2, scale=8.0)
    tl = (256,)
    res = run_both(q, k, v, tl)
    assert np.isfinite(res["out"][1]).all()
    assert_rows_close(res, tl, 1e-3)
    assert topk_agreement(res, tl) > 0.995


def test_colsum_topk_matches_pallas():
    """The eviction decision itself: top-64 of [0, true_len - w)."""
    q, k, v = make(1, 4, 256, 64, seed=3)
    tl = (200,)
    res = run_both(q, k, v, tl)
    assert topk_agreement(res, tl, frac=64 / (200 - W)) > 0.995


def test_cpu_wrapper_counts_no_launch():
    """On the CPU the wrappers run the plain versions: no kernel launch."""
    before = (port.flash_prefill.launches, port.colsum_scores.launches)
    q, k, v = (torch.from_numpy(x) for x in make(1, 2, 128, 64))
    tl = torch.tensor([100], dtype=torch.int32)
    out, m2, l2 = port.flash_prefill(q, k, v, tl, window_size=W,
                                     need_scores=True)
    port.colsum_scores(q, k, tl, m2, l2, window_size=W)
    assert (port.flash_prefill.launches,
            port.colsum_scores.launches) == before


def test_kernel_rejects_unsupported_head_dim():
    q = torch.zeros((1, 1, 64, 32))
    tl = torch.tensor([64], dtype=torch.int32)
    with pytest.raises(ValueError, match="head_dim"):
        port._check_inputs("flash_prefill", tl, q, q, q)
