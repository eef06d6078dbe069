"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA card and skip without one: a CUDA kernel has no
CPU mode, and the plain versions are held against the JAX package's Pallas
kernels in tests/test_torch_flash_prefill.py.  The file imports no JAX, so
it runs on a machine with only PyTorch:

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q
"""

import numpy as np
import pytest
import torch

from scope_tpu_torch.ops import flash_prefill as port

W = 8
CASES = {
    # name: (B, H, S, D, true_len, sliding_window)
    "b2_ragged": (2, 4, 256, 64, (256, 200), None),
    "d128": (1, 4, 256, 128, (230,), None),
    "s384": (2, 2, 384, 64, (384, 301), None),
    "s1000": (1, 4, 1000, 64, (1000,), None),
    "window64": (1, 4, 256, 64, (256,), 64),
    # true_len at a 64-row tile edge and one either side, so the w x w tail
    # straddles a tile.
    "tile_edge": (3, 4, 512, 64, (256, 255, 257), None),
    # q-tiles wholly past true_len (rows 320..1023).
    "pad_tiles": (1, 4, 1024, 64, (300,), None),
    "d128_ragged": (2, 4, 384, 128, (384, 201), None),
}


def make(B, H, S, D, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy((rng.standard_normal((B, H, S, D)) * sc
                              ).astype(np.float32))
            for sc in (scale, scale, 1.0)]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU "
                    "mode (their plain versions are tested on the CPU in "
                    "test_torch_flash_prefill.py)")


def _run(case, dtype, scale=1.0, need_scores=True):
    B, H, S, D, tl, window = CASES[case]
    dt = getattr(torch, dtype)
    q, k, v = (x.cuda().to(dt) for x in make(B, H, S, D, seed=len(case),
                                               scale=scale))
    ttl = torch.tensor(tl, dtype=torch.int32, device="cuda")
    launches = (port.flash_prefill.launches, port.colsum_scores.launches)
    out, m2, l2 = port.flash_prefill(q, k, v, ttl, window_size=W,
                                     need_scores=need_scores,
                                     sliding_window=window)
    cs = (port.colsum_scores(q, k, ttl, m2, l2, window_size=W)
          if need_scores else None)
    assert port.flash_prefill.launches == launches[0] + 1
    assert port.colsum_scores.launches == launches[1] + int(need_scores)
    # The plain versions in float32 on the same (rounded) inputs.
    qf, kf, vf = q.float(), k.float(), v.float()
    ro, rm2, rl2 = port.flash_prefill_reference(
        qf, kf, vf, ttl, window_size=W, need_scores=need_scores,
        sliding_window=window)
    rcs = (port.colsum_scores_reference(qf, kf, ttl, rm2, rl2, window_size=W)
           if need_scores else None)
    torch.cuda.synchronize()
    return tl, (out, m2, l2, cs), (ro, rm2, rl2, rcs)


def _assert_close(tl, got, ref, tol, out_rel=None):
    """out_rel: the most out's norm-wise relative error may be in a real
    row (default tol)."""
    out, m2, l2, cs = got
    ro, rm2, rl2, rcs = ref
    for b, n in enumerate(tl):
        torch.testing.assert_close(out[b, :, :n].float(), ro[b, :, :n],
                                   rtol=tol, atol=tol)
        d = (out[b, :, :n].float() - ro[b, :, :n]).norm(dim=-1)
        assert (d <= (out_rel or tol) * ro[b, :, :n].norm(dim=-1)).all()
        torch.testing.assert_close(m2[b, :, :n], rm2[b, :, :n], rtol=1e-4,
                                   atol=1e-4)
        torch.testing.assert_close(l2[b, :, :n], rl2[b, :, :n], rtol=1e-3,
                                   atol=1e-3)
    if cs is not None:
        torch.testing.assert_close(cs, rcs, rtol=1e-3, atol=1e-3)


# float32: the sums differ only in order.  bf16: the kernel rounds each
# tile's probabilities (relative to the running max) to bf16 before PV,
# the plain version rounds those relative to the final max.
TOL = {"float32": 2e-4, "bfloat16": 2e-2}
# bf16 out, norm-wise per row: rounding gives a few 2^-9 (chip_smoke's
# OUT_REL); a dropped or mis-masked key tile gives far more.
OUT_REL = {"float32": 2e-4, "bfloat16": 1e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dtype", sorted(TOL))
def test_kernels_match_plain_on_card(case, dtype):
    _need_card()
    tl, got, ref = _run(case, dtype)
    _assert_close(tl, got, ref, TOL[dtype], OUT_REL[dtype])


@pytest.mark.cuda
def test_kernels_large_logits_on_card():
    _need_card()
    tl, got, ref = _run("b2_ragged", "float32", scale=8.0)
    assert torch.isfinite(got[0]).all()
    _assert_close(tl, got, ref, 1e-3)


@pytest.mark.cuda
def test_flash_without_scores_on_card():
    _need_card()
    tl, got, ref = _run("b2_ragged", "bfloat16", need_scores=False)
    _assert_close(tl, got, ref, TOL["bfloat16"], OUT_REL["bfloat16"])
    assert (got[1] == 0).all() and (got[2] == 1).all()


@pytest.mark.cuda
def test_colsum_is_deterministic_on_card():
    """No atomics: two runs give bit-identical column sums."""
    _need_card()
    _, got, _ = _run("s1000", "bfloat16")
    B, H, S, D, tl, _ = CASES["s1000"]
    q, k, _ = (x.cuda().to(torch.bfloat16)
               for x in make(B, H, S, D, seed=len("s1000")))
    ttl = torch.tensor(tl, dtype=torch.int32, device="cuda")
    again = port.colsum_scores(q, k, ttl, got[1], got[2], window_size=W)
    assert torch.equal(again, got[3])


@pytest.mark.cuda
@pytest.mark.parametrize("need_scores", [True, False])
def test_bf16_pad_rows_read_zero_on_card(need_scores):
    """bf16 route: every row at or past true_len reads out = 0, m2 = 0,
    l2 = 1, finite (pad K/V can reach the cache)."""
    _need_card()
    tl, got, _ = _run("pad_tiles", "bfloat16", need_scores=need_scores)
    out, m2, l2, _ = got
    for b, n in enumerate(tl):
        assert torch.isfinite(out[b].float()).all()
        assert (out[b, :, n:] == 0).all()
        assert (m2[b, :, n:] == 0).all() and (l2[b, :, n:] == 1).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(TOL))
def test_flash_is_deterministic_on_card(dtype):
    """Two runs on the same inputs give bit-identical out, m2 and l2."""
    _need_card()
    B, H, S, D, tl, _ = CASES["s1000"]
    q, k, v = (x.cuda().to(getattr(torch, dtype))
               for x in make(B, H, S, D, seed=len("s1000")))
    ttl = torch.tensor(tl, dtype=torch.int32, device="cuda")
    first = port.flash_prefill(q, k, v, ttl, window_size=W, need_scores=True)
    again = port.flash_prefill(q, k, v, ttl, window_size=W, need_scores=True)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["b2_ragged", "tile_edge", "pad_tiles",
                                  "d128_ragged"])
@pytest.mark.parametrize("dtype", sorted(TOL))
def test_prefill_scores_only_on_card(case, dtype):
    """Chunked prefill's finalize scores: the kernel pair (scored
    flash_prefill over V = K, then colsum_scores) on the card against the
    blocked plain version on the CPU, ragged rows; one launch of each."""
    from scope_tpu_torch.ops.attention import prefill_scores_only
    _need_card()
    B, H, S, D, tl, _ = CASES[case]
    dt = getattr(torch, dtype)
    q, k, _ = (x.to(dt) for x in make(B, H, S, D, seed=len(case)))
    ttl = torch.tensor(tl, dtype=torch.int32)
    launches = (port.flash_prefill.launches, port.colsum_scores.launches)
    got = prefill_scores_only(q.cuda(), k.cuda(), ttl.cuda(), window_size=W,
                              need_colsum_all=True)
    assert (port.flash_prefill.launches, port.colsum_scores.launches) == (
        launches[0] + 1, launches[1] + 1)
    ref = prefill_scores_only(q.float(), k.float(), ttl, window_size=W,
                              need_colsum_all=True)
    torch.testing.assert_close(got.colsum_all.cpu(), ref.colsum_all,
                               rtol=1e-3, atol=1e-3)
    assert got.colsum_window is None
