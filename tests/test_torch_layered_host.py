"""PyramidKV's layered host scheduling, and SnapKV / StreamingLLM on the
host path, against the JAX package.

tiny-llama in float32 on the CPU at the knobs of tests/test_host_sched.py
(P=64, w=8, W=32, r=16, delta=3, 128-token bucket, true_len 100: the
mid branch, where the port's larger pyramidkv cache binds no clamp).  The
per-layer mirror must plan the JAX package's steps; the layered host path
(per step and with chunks) must give tokens and per-layer lengths identical
to the JAX package's host path and to the port's cond mode; snapkv and
streamingllm must run on the host path; and the layered hot and force
steps must never ask the device for a value.
"""

from functools import partial

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from scope_tpu.compression import host_sched as jhost
from scope_tpu.config import CompressionConfig as JComp
from scope_tpu.config import EngineConfig as JEngine
from scope_tpu.engine.host_loop import HostScheduledDecoder as JDecoder
from scope_tpu.models import llama as jllama
from scope_tpu.models.registry import TINY_LLAMA

from scope_tpu_torch import CompressionConfig, EngineConfig
from scope_tpu_torch.compression import host_sched as thost
from scope_tpu_torch.config import pyramid_prefill_max
from scope_tpu_torch.engine.host_loop import (HostScheduledDecoder,
                                              host_generate)
from scope_tpu_torch.models import llama as tllama
from scope_tpu_torch.models.convert import params_from_jax
from scope_tpu_torch.models.registry import get_spec

TSPEC = get_spec("tiny-llama")
ENGINE = dict(max_prompt_len=128, max_new_tokens=48, dtype="float32")
STEPS = 40


def configs(method, metric, per_qhead=True, **engine):
    kw = dict(method=method, decoding_metric=metric, max_capacity_prompt=64,
              window_size=32 if method == "streamingllm" else 8,
              decoding_window_size=32, decoding_recent_size=16, delta=3,
              evict_per_qhead=per_qhead)
    ekw = dict(ENGINE, **engine)
    return JComp(**kw), JEngine(**ekw), CompressionConfig(**kw), \
        EngineConfig(**ekw)


@pytest.fixture(scope="module")
def weights():
    params = jllama.init_params(TINY_LLAMA, jax.random.key(0), jnp.float32)
    pnp = jax.tree_util.tree_map(np.asarray, params)
    return params, params_from_jax(pnp, device="cpu", dtype=torch.float32)


def prompt(seed=0):
    toks = np.random.default_rng(seed).integers(0, 512, (1, 128))
    return toks.astype(np.int32), np.array([100], np.int32)


def jax_host(jc, je, jp, toks, tl, steps):
    """The JAX package's host path through ``step_auto``: tokens
    [B, steps+1] and per-layer lengths after each call."""
    dec = JDecoder(TINY_LLAMA, jc, je)
    logits, cache, state = jax.jit(partial(jllama.prefill, TINY_LLAMA, jc,
                                           je))(jp, jnp.asarray(toks),
                                                jnp.asarray(tl))
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    sched = dec.new_scheduler(int(tl[0]), prompt_pad=toks.shape[1])
    seq, lens, s = [np.asarray(tok)], [], 0
    while len(seq) <= steps:
        out, cache, state = dec.step_auto(sched, jp, tok, jnp.asarray(tl) + s,
                                          cache, state)
        arr = np.asarray(out)
        seq.extend(arr.T)
        lens.append(np.asarray(cache.length))
        tok = out[:, -1]
        s += arr.shape[1]
    return np.stack(seq[:steps + 1], 1), lens


def torch_host(tc, te, tp, toks, tl, steps):
    """The port's host path, as :func:`jax_host`; also the mirror and the
    cache."""
    dec = HostScheduledDecoder(TSPEC, tc, te)
    logits, cache, state = tllama.prefill(TSPEC, tc, te, tp,
                                          torch.from_numpy(toks),
                                          torch.from_numpy(tl))
    tok = logits.argmax(-1).to(torch.int32)
    sched = dec.new_scheduler(int(tl[0]), prompt_pad=toks.shape[1])
    seq, lens, s = [tok.numpy()], [], 0
    while len(seq) <= steps:
        out, cache, state = dec.step_auto(sched, tp, tok,
                                          torch.from_numpy(tl) + s, cache,
                                          state)
        seq.extend(out.numpy().T)
        lens.append(cache.length.numpy().copy())
        tok = out[:, -1]
        s += out.shape[1]
    return np.stack(seq[:steps + 1], 1), lens, cache, sched


def torch_cond(tc, te, tp, toks, tl, steps):
    """The port's cond mode: tokens and per-layer lengths after each
    step."""
    logits, cache, state = tllama.prefill(TSPEC, tc, te, tp,
                                          torch.from_numpy(toks),
                                          torch.from_numpy(tl))
    tok = logits.argmax(-1).to(torch.int32)
    seq, lens = [tok.numpy()], []
    for s in range(steps):
        logits, cache, state = tllama.decode_step(
            TSPEC, tc, te, tp, tok, torch.from_numpy(tl) + s, cache, state)
        tok = logits.argmax(-1).to(torch.int32)
        seq.append(tok.numpy())
        lens.append(cache.length.numpy().copy())
    return np.stack(seq, 1), lens


# ---------------------------------------------------------------------------
# the per-layer mirror
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("P,w,beta,L", [(64, 8, 20, 2), (64, 8, 4, 4),
                                        (2048, 8, 20, 16), (192, 8, 20, 2)])
def test_pyramid_prefill_kept_matches_jax(P, w, beta, L):
    comp = dict(method="pyramidkv", max_capacity_prompt=P, window_size=w,
                beta=beta)
    for n in sorted({P - 1, P, P + 7, 2 * (P - w) - 1, 2 * (P - w),
                     2 * (P - w) + 5, 2 * P + 3, 4 * P}):
        for bucket in (b for b in (P, 2 * P, 8 * P) if b >= n):
            tc = CompressionConfig(**comp)
            got = thost.pyramid_prefill_kept(tc, L, n, bucket)
            assert got == jhost.pyramid_prefill_kept(JComp(**comp), L, n,
                                                     bucket)
            # What the port's capacity is sized for (config.py).
            assert max(got) <= min(n, pyramid_prefill_max(tc))


# Decode knobs and prompt (mid branch below 2(P - w) = 112, deep above).
GRID = [dict(W=32, r=16, delta=3, prompt=100, L=2),
        dict(W=48, r=8, delta=4, prompt=120, L=4),
        dict(W=40, r=24, delta=2, prompt=200, L=3),
        dict(W=64, r=32, delta=5, prompt=50, L=2)]


@pytest.mark.parametrize("knobs", range(len(GRID)))
@pytest.mark.parametrize("metric", ["none", "fixed", "linear", "jump",
                                    "pyramidinfer"])
def test_layered_plan_step_matches_jax(metric, knobs):
    """250 steps of per-layer plans and mirror state against the JAX
    package's LayeredHostScheduler, hot-run peeks included."""
    k = GRID[knobs]
    kw = dict(method="pyramidkv", decoding_metric=metric,
              max_capacity_prompt=64, window_size=8,
              decoding_window_size=k["W"], decoding_recent_size=k["r"],
              delta=k["delta"])
    pad = 128 if k["prompt"] <= 128 else 256
    args = (k["L"], k["prompt"], pad, 40, 320)
    js = jhost.LayeredHostScheduler(JComp(**kw), *args)
    ts = thost.LayeredHostScheduler(CompressionConfig(**kw), *args)
    fires = 0
    for step in range(250):
        assert ts.hot_run_length(8) == js.hot_run_length(8), step
        pj, pt = js.plan_step(), ts.plan_step()
        assert (pt.fire_any, pt.fire, pt.n_keep) == (pj.fire_any, pj.fire,
                                                     pj.n_keep), step
        assert ts._snapshot() == js._snapshot(), step
        assert ts.length == js.length
        fires += pj.fire_any
    assert fires > 0 or metric == "none"


# ---------------------------------------------------------------------------
# the layered host path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metric,per_qhead,chunks,max_new", [
    ("jump", True, (), 48), ("jump", False, (4, 2), 48),
    ("pyramidinfer", False, (4, 2), 48), ("linear", True, (), 48),
    ("jump", False, (), 1200)])
def test_layered_host_path_matches_jax_and_cond(weights, metric, per_qhead,
                                                chunks, max_new):
    """Tokens and per-layer cache lengths: the port's layered host path
    against the JAX package's and the port's cond mode; the mirror's
    per-layer lengths are the cache's.  At max_new_tokens=1200 the
    capacity (640) exceeds the first length bucket (512), which the hot
    steps then attend over."""
    jp, tp = weights
    jc, je, tc, te = configs("pyramidkv", metric, per_qhead,
                             decode_chunk_sizes=chunks,
                             max_new_tokens=max_new)
    if max_new > 48:
        dec = HostScheduledDecoder(TSPEC, tc, te)
        assert dec.buckets == (512, 640)
    toks, tl = prompt()
    jseq, jlens = jax_host(jc, je, jp, toks, tl, STEPS)
    tseq, tlens, cache, sched = torch_host(tc, te, tp, toks, tl, STEPS)
    cseq, clens = torch_cond(tc, te, tp, toks, tl, STEPS)
    np.testing.assert_array_equal(tseq, jseq)
    np.testing.assert_array_equal(tseq, cseq)
    for s, (a, b) in enumerate(zip(tlens, jlens)):
        np.testing.assert_array_equal(a, b, err_msg=f"call {s}")
    if not chunks:
        for s, (a, c) in enumerate(zip(tlens, clens)):
            np.testing.assert_array_equal(a, c, err_msg=f"step {s}")
    else:
        assert len(tlens) < STEPS * 3 // 4, "no chunk ran"
    assert sched.lengths == cache.length[:, 0].tolist()
    assert (cache.length <= te.cache_capacity(tc)).all()


def test_host_generate_layered_mirror(weights):
    """host_generate's per-layer mirror equals the cache's lengths."""
    _, tp = weights
    _, _, tc, te = configs("pyramidkv", "jump", decode_chunk_sizes=(4, 2))
    toks, tl = prompt(seed=2)
    gen, stats = host_generate(TSPEC, tc, te, tp, toks, tl, 30, device="cpu")
    assert gen.shape == (1, 30)
    assert stats["mirror_lengths"] == stats["cache_length"]
    assert stats["mirror_length"] == max(stats["cache_length"])


@pytest.mark.parametrize("method,metric,chunks", [
    ("snapkv", "jump", (4, 2)), ("streamingllm", "slm", ())])
def test_snapkv_and_streamingllm_take_the_host_path(weights, method, metric,
                                                    chunks):
    jp, tp = weights
    jc, je, tc, te = configs(method, metric, decode_chunk_sizes=chunks)
    dec = HostScheduledDecoder(TSPEC, tc, te)
    assert not dec.layered
    assert isinstance(dec.new_scheduler(100), thost.HostScheduler)
    toks, tl = prompt(seed=1)
    jseq, jlens = jax_host(jc, je, jp, toks, tl, STEPS)
    tseq, tlens, cache, sched = torch_host(tc, te, tp, toks, tl, STEPS)
    np.testing.assert_array_equal(tseq, jseq)
    for a, b in zip(tlens, jlens):
        np.testing.assert_array_equal(a, b)
    assert (cache.length == sched.length).all()


# ---------------------------------------------------------------------------
# no host sync
# ---------------------------------------------------------------------------

SYNCS = ("item", "tolist", "__bool__", "__int__", "__float__", "__index__",
         "numpy")


@pytest.mark.parametrize("metric,chunks", [("jump", (4, 2)),
                                           ("pyramidinfer", ())])
def test_layered_host_path_reads_nothing_from_the_device(
        weights, monkeypatch, metric, chunks):
    """The layered hot steps, chunks and force steps (per-layer gates) ask
    the device for nothing: every host read of a tensor raises while 60
    steps run."""
    _, tp = weights
    _, _, tc, te = configs("pyramidkv", metric, decode_chunk_sizes=chunks,
                           max_new_tokens=80)
    toks, tl = prompt()
    dec = HostScheduledDecoder(TSPEC, tc, te)
    logits, cache, state = tllama.prefill(TSPEC, tc, te, tp,
                                          torch.from_numpy(toks),
                                          torch.from_numpy(tl))
    tok = logits.argmax(-1).to(torch.int32)
    sched = dec.new_scheduler(100, prompt_pad=128)
    vpos = torch.from_numpy(tl)
    s, fires = 0, 0

    def refuse(self, *a, **k):
        raise AssertionError("the device was asked for a value")
    with monkeypatch.context() as m:
        for name in SYNCS:
            m.setattr(torch.Tensor, name, refuse)
        while s < 60:
            before = list(sched.lengths)
            out, cache, state = dec.step_auto(sched, tp, tok, vpos + s,
                                              cache, state)
            n = out.shape[1]
            fires += any(a < b + n for a, b in zip(sched.lengths, before))
            tok = out[:, -1]
            s += n
    assert fires >= 1
    assert sched.lengths == cache.length[:, 0].tolist()
