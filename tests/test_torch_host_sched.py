"""The port's host-scheduled decode against the JAX package's.

tiny-llama in float32 on the CPU, one numpy weight set carried into both
packages with ``params_from_jax``, at the knobs of tests/test_host_sched.py
(P=64, w=8, W=32, r=16, delta=3, 128-token bucket, true_len 100).  The
host mirror must plan the same steps as the JAX package's; the host path
must give tokens and per-layer cache lengths identical to the JAX
package's host path and to the port's cond mode; chunked hot runs must
equal per-step dispatch; and the hot and force steps must never ask the
device for a value.  Every comparison is exact, as in the JAX tests.
"""

from functools import partial

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from scope_tpu.compression import host_sched as jhost
from scope_tpu.compression import schedulers as jsched
from scope_tpu.config import CompressionConfig as JComp
from scope_tpu.config import EngineConfig as JEngine
from scope_tpu.engine.generate import StreamingGenerator as JStreaming
from scope_tpu.engine.host_loop import HostScheduledDecoder as JDecoder
from scope_tpu.engine.host_loop import host_generate as jhost_generate
from scope_tpu.models import llama as jllama
from scope_tpu.models.registry import get_spec as jget_spec

from scope_tpu_torch import CompressionConfig, EngineConfig
from scope_tpu_torch.compression import host_sched as thost
from scope_tpu_torch.compression import schedulers as tsched
from scope_tpu_torch.engine.generate import StreamingGenerator
from scope_tpu_torch.engine.host_loop import (HostScheduledDecoder,
                                              host_generate)
from scope_tpu_torch.models import llama as tllama
from scope_tpu_torch.models.convert import params_from_jax
from scope_tpu_torch.models.registry import get_spec

JSPEC, TSPEC = jget_spec("tiny-llama"), get_spec("tiny-llama")
ENGINE = dict(max_prompt_len=128, max_new_tokens=48, dtype="float32")
STEPS = 40
NO_EOS = 999999


def comp_kw(method, metric, per_qhead=True):
    return dict(method=method, decoding_metric=metric, max_capacity_prompt=64,
                window_size=8, decoding_window_size=32,
                decoding_recent_size=16, delta=3, evict_per_qhead=per_qhead)


def configs(method, metric, per_qhead=True, **engine):
    """(JAX comp, JAX engine, port comp, port engine).  The port's
    EngineConfig has no ``uniform_lengths`` (one write serves uniform and
    ragged rows), so only the JAX package gets it."""
    kw = comp_kw(method, metric, per_qhead)
    ekw = dict(ENGINE, **engine)
    tkw = {k: v for k, v in ekw.items() if k != "uniform_lengths"}
    return JComp(**kw), JEngine(**ekw), CompressionConfig(**kw), \
        EngineConfig(**tkw)


@pytest.fixture(scope="module")
def weights():
    params = jllama.init_params(JSPEC, jax.random.key(0), jnp.float32)
    pnp = jax.tree_util.tree_map(np.asarray, params)
    return params, params_from_jax(pnp, device="cpu", dtype=torch.float32)


def prompt(B=1, seed=0):
    toks = np.random.default_rng(seed).integers(0, 512, (B, 128))
    return toks.astype(np.int32), np.full((B,), 100, np.int32)


def jax_host(jc, je, jp, toks, tl, steps):
    """The JAX package's host path through ``step_auto`` (per step when
    ``je.decode_chunk_sizes`` is empty).  Returns (tokens [B, steps+1],
    cache lengths [L, B] after each call, cache, mirror)."""
    dec = JDecoder(JSPEC, jc, je)
    logits, cache, state = jax.jit(partial(jllama.prefill, JSPEC, jc, je))(
        jp, jnp.asarray(toks), jnp.asarray(tl))
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    sched = dec.new_scheduler(int(tl[0]))
    seq, lens, s = [np.asarray(tok)], [], 0
    while len(seq) <= steps:
        out, cache, state = dec.step_auto(sched, jp, tok, jnp.asarray(tl) + s,
                                          cache, state)
        arr = np.asarray(out)
        seq.extend(arr.T)
        lens.append(np.asarray(cache.length))
        tok = out[:, -1]
        s += arr.shape[1]
    return np.stack(seq[:steps + 1], 1), lens, cache, sched


def torch_host(tc, te, tp, toks, tl, steps):
    """The port's host path, as :func:`jax_host`."""
    dec = HostScheduledDecoder(TSPEC, tc, te)
    logits, cache, state = tllama.prefill(TSPEC, tc, te, tp,
                                          torch.from_numpy(toks),
                                          torch.from_numpy(tl))
    tok = logits.argmax(-1).to(torch.int32)
    sched = dec.new_scheduler(int(tl[0]))
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
    """The port's cond mode: the device's gates, per layer."""
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
    return np.stack(seq, 1), lens, cache


# ---------------------------------------------------------------------------
# the host mirror
# ---------------------------------------------------------------------------

# Decode knobs and prompt length; a prompt shorter than P=64 keeps all of it.
GRID_KNOBS = [dict(W=32, r=16, delta=3, prompt=100),
              dict(W=48, r=8, delta=4, prompt=100),
              dict(W=64, r=32, delta=2, prompt=40),
              dict(W=40, r=24, delta=5, prompt=200)]


@pytest.mark.parametrize("knobs", range(len(GRID_KNOBS)))
@pytest.mark.parametrize("metric", ["none", "fixed", "linear", "jump", "h2o"])
@pytest.mark.parametrize("method", ["h2o", "allkv", "fullkv"])
def test_plan_step_sequence_matches_jax(method, metric, knobs):
    """250 steps of plans and mirror state against the JAX package's eager
    mirror, hot-run peeks included."""
    k = GRID_KNOBS[knobs]
    kw = dict(method=method, decoding_metric=metric, max_capacity_prompt=64,
              window_size=8, decoding_window_size=k["W"],
              decoding_recent_size=k["r"], delta=k["delta"])
    L, prompt_len = 4, k["prompt"]
    kept = prompt_len if method in ("allkv", "fullkv") else min(64,
                                                                  prompt_len)
    args = (L, prompt_len, kept, 40)
    js = jhost.HostScheduler(JComp(**kw), *args, capacity=256)
    ts = thost.HostScheduler(CompressionConfig(**kw), *args, capacity=256)
    fires = 0
    for step in range(250):
        assert ts.hot_run_length(8) == js.hot_run_length(8), step
        pj, pt = js.plan_step(), ts.plan_step()
        assert (pt.fire, pt.n_keep, pt.w_t) == (pj.fire, pj.n_keep, pj.w_t), \
            step
        assert js.phys == js.length, step
        assert ts._snapshot() == (js.length, js.step_counter, js.jump_step,
                                  js.jump_layer), step
        fires += pj.fire
    assert fires > 0 or metric == "none" or method == "fullkv"


def test_hot_run_length_peek_restores():
    """Peeking leaves the mirror as it was; advance_hot covers the run."""
    comp = CompressionConfig(**comp_kw("h2o", "jump"))
    a = thost.HostScheduler(comp, 4, 100, 64, 16)
    b = thost.HostScheduler(comp, 4, 100, 64, 16)
    for _ in range(60):
        n = a.hot_run_length(8)
        assert a._snapshot() == b._snapshot()
        if n > 0:
            a.advance_hot(n)
            for _ in range(n):
                assert not b.plan_step().fire
        else:
            assert b.plan_step().fire == a.plan_step().fire
    with pytest.raises(RuntimeError, match="fire"):
        while True:
            a.advance_hot(1)


@pytest.mark.parametrize("method,metric", [
    ("h2o", "jump"), ("allkv", "fixed"), ("fullkv", "none"), ("h2o", "h2o"),
    ("snapkv", "linear"), ("streamingllm", "slm"), ("quest", "jump"),
    ("headwise", "fixed"), ("allkv", "h2o"), ("pyramidkv", "jump")])
def test_schedulable_sets_match_jax(method, metric):
    kw = dict(comp_kw(method, metric), beta=4)
    assert thost.host_schedulable(CompressionConfig(**kw)) == \
        jhost.host_schedulable(JComp(**kw))
    assert thost.host_schedulable_layered(CompressionConfig(**kw)) == \
        jhost.host_schedulable_layered(JComp(**kw))


@pytest.mark.parametrize("method,metric", [
    ("h2o", "jump"), ("allkv", "fixed"), ("h2o", "h2o")])
def test_force_pseg_matches_jax(method, metric):
    jc, _, tc, _ = configs(method, metric)
    pl = np.array([100, 77], np.int32)
    pj, posj = jsched.force_pseg(jc, 2, jnp.asarray(pl))
    pt, post = tsched.force_pseg(tc, 2, torch.from_numpy(pl))
    np.testing.assert_array_equal(np.asarray(pj), pt.numpy())
    assert posj == post


@pytest.mark.parametrize("positional", [False, True])
def test_block_map_positional_matches_jax(positional):
    """The rewrite map from slot 0 (h2o metric), by score or by position."""
    jc, _, tc, _ = configs("h2o", "h2o")
    rng = np.random.default_rng(5)
    probs = (np.round(rng.random((2, 4, 128)) * 8) / 8).astype(np.float32)
    length = np.array([97, 120], np.int32)
    pseg = np.zeros(2, np.int32)
    n_keep = np.array([80, 80], np.int32)
    gate = np.array([True, False])
    caps = (80, 128)
    sj, lj = jsched.block_map(jc, jsched.DecodeCaps(*caps), probs, length,
                              pseg, n_keep, gate, positional)
    st, lt = tsched.block_map(tc, tsched.DecodeCaps(*caps),
                              torch.from_numpy(probs),
                              torch.from_numpy(length),
                              torch.from_numpy(pseg),
                              torch.from_numpy(n_keep),
                              torch.from_numpy(gate), positional)
    np.testing.assert_array_equal(np.asarray(sj), st.numpy())
    np.testing.assert_array_equal(np.asarray(lj), lt.numpy())


# ---------------------------------------------------------------------------
# the host path
# ---------------------------------------------------------------------------

HOST_CASES = [("h2o", "fixed", True), ("h2o", "linear", True),
              ("h2o", "jump", True), ("h2o", "fixed", False),
              ("h2o", "linear", False), ("h2o", "jump", False),
              ("allkv", "fixed", True), ("h2o", "h2o", True)]


@pytest.mark.parametrize("method,metric,per_qhead", HOST_CASES)
def test_host_path_matches_jax_and_cond(weights, method, metric, per_qhead):
    """Tokens and per-layer cache lengths after every step: the port's
    host path against the JAX package's host path and the port's cond
    mode; the mirror's length is the cache's."""
    jp, tp = weights
    jc, je, tc, te = configs(method, metric, per_qhead)
    toks, tl = prompt()
    jseq, jlens, _, _ = jax_host(jc, je, jp, toks, tl, STEPS)
    tseq, tlens, tcache, sched = torch_host(tc, te, tp, toks, tl, STEPS)
    cseq, clens, _ = torch_cond(tc, te, tp, toks, tl, STEPS)
    np.testing.assert_array_equal(tseq, jseq)
    np.testing.assert_array_equal(tseq, cseq)
    for s, (a, b, c) in enumerate(zip(tlens, jlens, clens)):
        np.testing.assert_array_equal(a, b, err_msg=f"step {s}")
        np.testing.assert_array_equal(a, c, err_msg=f"step {s}")
    assert tlens[-1].max() < tlens[0].max() + len(tlens) - 1, \
        "no compression fired"
    assert sched.length == int(tcache.length[0, 0])
    assert (tcache.length == sched.length).all()


@pytest.mark.parametrize("method,metric", [
    ("h2o", "jump"), ("h2o", "fixed"), ("fullkv", "none")])
def test_chunked_equals_per_step_and_jax(weights, method, metric):
    """step_auto with chunks (8, 4, 2): tokens of per-step dispatch and of
    the JAX package's chunked path; the mirror's length is the cache's."""
    jp, tp = weights
    jc, je, tc, te = configs(method, metric, decode_chunk_sizes=(8, 4, 2))
    _, _, _, te1 = configs(method, metric)
    toks, tl = prompt(seed=3)
    jseq, _, _, _ = jax_host(jc, je, jp, toks, tl, STEPS)
    ref, _, _, _ = torch_host(tc, te1, tp, toks, tl, STEPS)
    got, lens, cache, sched = torch_host(tc, te, tp, toks, tl, STEPS)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, jseq)
    assert len(lens) < STEPS // 2, "no chunk ran"
    assert sched.length == int(cache.length.max())


@pytest.mark.parametrize("method,metric,steps", [
    ("fullkv", "none", 450), ("h2o", "fixed", 60)])
def test_bucketed_attention_equals_full_capacity(weights, method, metric,
                                                 steps):
    """Hot steps attend over the smallest length bucket that covers the
    cache: tokens equal cond mode over the full capacity, and the JAX
    package's bucketed host path.  fullkv's capacity (768) crosses the 512
    bucket."""
    jp, tp = weights
    jc, je, tc, te = configs(method, metric, max_new_tokens=600)
    toks, tl = prompt()
    dec = HostScheduledDecoder(TSPEC, tc, te)
    if method == "fullkv":
        assert dec.buckets == (512, 768)
    got, lens, _, sched = torch_host(tc, te, tp, toks, tl, steps)
    ref, _, _ = torch_cond(tc, te, tp, toks, tl, steps)
    jseq, _, _, _ = jax_host(jc, je, jp, toks, tl, steps)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, jseq)
    if method == "fullkv":
        assert lens[0].max() < 512 < lens[-1].max()


def test_streaming_generator_takes_the_host_path_and_matches_jax(weights):
    jp, tp = weights
    jc, je, tc, te = configs("h2o", "jump")
    toks, tl = prompt()
    sg = StreamingGenerator(TSPEC, tc, te, tp, eos_ids=(NO_EOS,),
                            device="cpu")
    assert isinstance(sg.host_decoder, HostScheduledDecoder)
    res = sg.generate(toks, tl, 48)
    ref = JStreaming(JSPEC, jc, je, jp, eos_ids=(NO_EOS,)).generate(
        toks, tl, 48)
    np.testing.assert_array_equal(res.tokens, ref.tokens)
    assert res.gen_lengths[0] == 48 and len(res.tpot_s) == 48


def test_streaming_generator_keeps_cond_mode_where_the_host_cannot_plan():
    comp = CompressionConfig(**dict(comp_kw("allkv", "h2o")))
    sg = StreamingGenerator(TSPEC, comp, EngineConfig(**ENGINE), {},
                            eos_ids=(), device="cpu")
    assert sg.host_decoder is None


@pytest.mark.parametrize("chunks", [(), (4, 2)])
def test_host_generate_matches_jax(weights, chunks):
    """B=2 rows of one prompt length (the host mirrors one stream)."""
    jp, tp = weights
    jc, je, tc, te = configs("h2o", "jump", uniform_lengths=True,
                             decode_chunk_sizes=chunks)
    toks, tl = prompt(B=2, seed=1)
    gen_t, stats = host_generate(TSPEC, tc, te, tp, toks, tl, 44,
                                 device="cpu")
    gen_j, _ = jhost_generate(JSPEC, jc, je, jp, toks, tl, 44)
    np.testing.assert_array_equal(gen_t, gen_j)
    assert gen_t.shape == (2, 44) and len(stats["tpot_s"]) == 44
    assert stats["cache_length"] == [stats["mirror_length"]] * TSPEC.num_layers


def test_host_generate_stops_at_eos(weights):
    _, tp = weights
    _, _, tc, te = configs("h2o", "jump")
    toks, tl = prompt()
    free, _ = host_generate(TSPEC, tc, te, tp, toks, tl, 30, device="cpu")
    eos = int(free[0, 12])
    first = int(np.argmax(free[0] == eos))
    gen, _ = host_generate(TSPEC, tc, te, tp, toks, tl, 30, eos_ids=(eos,),
                           device="cpu")
    np.testing.assert_array_equal(gen[0], free[0, :first + 1])


# ---------------------------------------------------------------------------
# what the host path refuses
# ---------------------------------------------------------------------------

def test_not_host_schedulable_raises():
    comp = CompressionConfig(**comp_kw("headwise", "fixed"))
    assert not thost.host_schedulable(comp)
    with pytest.raises(ValueError, match="cond"):
        HostScheduledDecoder(TSPEC, comp, EngineConfig(**ENGINE))


@pytest.mark.parametrize("method,metric", [("quest", "jump")])
def test_unported_methods_raise(method, metric):
    # Quest is ported (tests/test_torch_quest_generate.py); Mistral's
    # sliding window is not, whatever the method.
    comp = CompressionConfig(**dict(comp_kw(method, metric), beta=4))
    assert HostScheduledDecoder(TSPEC, comp, EngineConfig(**ENGINE)).quest
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        HostScheduledDecoder(get_spec("tiny-mistral"), comp,
                             EngineConfig(**ENGINE))


def test_ragged_prompts_raise(weights):
    _, tp = weights
    _, _, tc, te = configs("h2o", "jump")
    toks, _ = prompt(B=2)
    with pytest.raises(ValueError, match="uniform"):
        host_generate(TSPEC, tc, te, tp, toks, np.array([100, 90], np.int32),
                      4, device="cpu")


def test_unknown_compress_mode_raises(weights):
    _, tp = weights
    _, _, tc, te = configs("h2o", "jump")
    toks, tl = prompt()
    _, cache, state = tllama.prefill(TSPEC, tc, te, tp,
                                     torch.from_numpy(toks),
                                     torch.from_numpy(tl))
    with pytest.raises(ValueError, match="compress_mode"):
        tllama.decode_step(TSPEC, tc, te, tp, torch.zeros(1, dtype=torch.int32),
                           torch.from_numpy(tl), cache, state,
                           compress_mode="scan")


# ---------------------------------------------------------------------------
# no host sync
# ---------------------------------------------------------------------------

SYNCS = ("item", "tolist", "__bool__", "__int__", "__float__", "__index__",
         "numpy")


def refuse_host_reads(monkeypatch):
    """Every way a tensor's value reaches Python raises from here on."""
    def refuse(self, *a, **k):
        raise AssertionError("the device was asked for a value")
    for name in SYNCS:
        monkeypatch.setattr(torch.Tensor, name, refuse)


@pytest.mark.parametrize("metric", ["jump", "h2o"])
@pytest.mark.parametrize("chunks", [(), (8, 4, 2)])
def test_host_path_reads_nothing_from_the_device(weights, monkeypatch,
                                                 chunks, metric):
    """The hot steps, the force steps and decode_steps ask the device for
    nothing: every host read of a tensor raises while 79 steps run (jump
    waves, or the h2o metric's re-ranks from slot 0, included)."""
    _, tp = weights
    _, _, tc, te = configs("h2o", metric, decode_chunk_sizes=chunks,
                           max_new_tokens=80)
    toks, tl = prompt()
    dec = HostScheduledDecoder(TSPEC, tc, te)
    logits, cache, state = tllama.prefill(TSPEC, tc, te, tp,
                                          torch.from_numpy(toks),
                                          torch.from_numpy(tl))
    tok = logits.argmax(-1).to(torch.int32)
    sched = dec.new_scheduler(100)
    vpos = torch.from_numpy(tl)
    outs, s, fires = [], 0, 0
    with monkeypatch.context() as m:
        refuse_host_reads(m)
        while s < 79:
            length = sched.length
            out, cache, state = dec.step_auto(sched, tp, tok, vpos + s,
                                              cache, state)
            n = out.shape[1]
            fires += sched.length < length + n
            outs.append(out)
            tok = out[:, -1]
            s += n
        with pytest.raises(AssertionError, match="asked"):
            bool(tok[0] > 0)
    assert fires >= 2
    assert torch.cat(outs, 1).shape == (1, s)


def test_decode_steps_reads_nothing_from_the_device(weights, monkeypatch):
    _, tp = weights
    _, _, tc, te = configs("h2o", "jump")
    toks, tl = prompt()
    logits, cache, state = tllama.prefill(TSPEC, tc, te, tp,
                                          torch.from_numpy(toks),
                                          torch.from_numpy(tl))
    tok = logits.argmax(-1).to(torch.int32)
    with monkeypatch.context() as m:
        refuse_host_reads(m)
        out, cache, state = tllama.decode_steps(
            TSPEC, tc, te, tp, tok, torch.from_numpy(tl), cache, state,
            n_steps=8, attn_cap=128)
    assert out.shape == (1, 8) and (cache.length == 72).all()


# ---------------------------------------------------------------------------
# capacity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method,metric", [
    ("h2o", "jump"), ("h2o", "fixed"), ("allkv", "linear"), ("h2o", "none"),
    ("h2o", "h2o")])
@pytest.mark.parametrize("engine", [
    dict(), dict(decode_chunk_sizes=(16, 8)), dict(decode_chunk_sizes=(4, 2)),
    dict(max_prompt_len=4096, max_new_tokens=7950),
    dict(max_prompt_len=4096, max_new_tokens=7950,
         decode_chunk_sizes=(16, 8))])
def test_cache_capacity_matches_jax(method, metric, engine):
    """The chunk slack term included, capacities are the JAX package's."""
    _, je, _, te = configs(method, metric, **engine)
    jc, _, tc, _ = configs(method, metric)
    assert te.cache_capacity(tc) == je.cache_capacity(jc)
