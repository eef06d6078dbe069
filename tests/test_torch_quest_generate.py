"""Quest end to end against the JAX package: prefill, decode in cond mode
and on the host path, ``generate`` and ``StreamingGenerator``.

tiny-llama with 3 layers (the first a dense skip layer) in float32 on the
CPU, one numpy weight set carried into both packages, P=64, chunk 16,
W=32, r=16, delta=3, a 128-token bucket: greedy tokens and per-layer cache
lengths after prefill and after every decode step identical to the JAX
package's prefill / decode_step loop for quest with every decode metric
and both eviction granularities, int8 KV and the paged decode region;
identical to the JAX package's host path (its ``HostScheduledDecoder``);
``generate`` identical to ``generate_scan`` for a ragged batch.  The
port's host path (per step, chunked, ``StreamingGenerator``) is held to its
cond mode, and its mirror to the cache's lengths at every step.  A jump
wave spans two steps: the skip layer advances no counter.  int4 decodes
from the JAX package's own prefill cache (int4 prefill codes differ at
calibration ties, tests/test_torch_quant_generate.py).
"""

from functools import partial

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from scope_tpu.config import CompressionConfig as JComp
from scope_tpu.config import EngineConfig as JEngine
from scope_tpu.engine.generate import generate_scan
from scope_tpu.engine.host_loop import HostScheduledDecoder as JDecoder
from scope_tpu.models import llama as jllama
from scope_tpu.models.registry import TINY_LLAMA

from scope_tpu_torch import CompressionConfig, EngineConfig
from scope_tpu_torch.engine.generate import StreamingGenerator, generate
from scope_tpu_torch.engine.host_loop import (HostScheduledDecoder,
                                              host_generate)
from scope_tpu_torch.models import llama as tllama
from scope_tpu_torch.models.convert import params_from_jax
from scope_tpu_torch.models.registry import get_spec

STEPS = 39
NO_EOS = 999999
JSPEC = TINY_LLAMA.replace(num_layers=3)
TSPEC = get_spec("tiny-llama").replace(num_layers=3)


@pytest.fixture(scope="module")
def weights():
    jp = jllama.init_params(JSPEC, jax.random.key(7), jnp.float32)
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                               device="cpu", dtype=torch.float32)


def configs(metric, per_qhead, pages=0, **engine):
    kw = dict(method="quest", decoding_metric=metric, max_capacity_prompt=64,
              window_size=8, decoding_window_size=32,
              decoding_recent_size=16, delta=3, chunk_size=16,
              quest_skip_layers=1, quest_decode_pages=pages,
              evict_per_qhead=per_qhead)
    ekw = dict(max_prompt_len=128, max_new_tokens=40, dtype="float32",
               **engine)
    return JComp(**kw), JEngine(**ekw), CompressionConfig(**kw), \
        EngineConfig(**ekw)


def prompt(B, seed=0):
    toks = np.random.default_rng(seed).integers(1, 512, (B, 128))
    return toks.astype(np.int32), np.array((100, 77)[:B], np.int32)


def jax_steps(jc, je, jp, toks, tl, host=False, cache_out=None):
    """The JAX package's prefill, then its decode_step loop (or its host
    path): tokens [B, STEPS+1] and per-layer lengths after prefill and
    after each step."""
    logits, cache, state = jax.jit(partial(jllama.prefill, JSPEC, jc, je))(
        jp, jnp.asarray(toks), jnp.asarray(tl))
    if cache_out is not None:
        cache_out.append(cache)
    if host:
        dec = JDecoder(JSPEC, jc, je)
        sched = dec.new_scheduler(int(tl[0]), prompt_pad=toks.shape[1])
        step = partial(dec.step, sched)
    else:
        step = jax.jit(partial(jllama.decode_step, JSPEC, jc, je))
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    seq, lens = [np.asarray(tok)], [np.asarray(cache.length)]
    for s in range(STEPS):
        logits, cache, state = step(jp, tok, jnp.asarray(tl + s), cache,
                                    state)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        seq.append(np.asarray(tok))
        lens.append(np.asarray(cache.length))
    return np.stack(seq, 1), lens


def torch_steps(tc, te, tp, toks, tl, host=False, cache=None):
    """The port's prefill (or ``cache`` = (logits, cache) given), then its
    cond-mode loop or host path, as :func:`jax_steps`."""
    if cache is None:
        logits, cache, state = tllama.prefill(TSPEC, tc, te, tp,
                                              torch.from_numpy(toks),
                                              torch.from_numpy(tl))
    else:
        (logits, cache), state = cache, None
        from scope_tpu_torch.compression.schedulers import SchedState
        state = SchedState.init()
    if host:
        dec = HostScheduledDecoder(TSPEC, tc, te)
        sched = dec.new_scheduler(int(tl[0]), prompt_pad=toks.shape[1])
    tok = logits.argmax(-1).to(torch.int32)
    seq, lens = [tok.numpy()], [cache.length.numpy().copy()]
    for s in range(STEPS):
        if host:
            logits, cache, state = dec.step(sched, tp, tok,
                                            torch.from_numpy(tl + s), cache,
                                            state)
            assert sched.lengths == cache.length[:, 0].tolist()
        else:
            logits, cache, state = tllama.decode_step(
                TSPEC, tc, te, tp, tok, torch.from_numpy(tl + s), cache,
                state)
        assert torch.isfinite(logits).all()
        tok = logits.argmax(-1).to(torch.int32)
        seq.append(tok.numpy())
        lens.append(cache.length.numpy().copy())
    return np.stack(seq, 1), lens


def assert_same(a, b):
    (aseq, alens), (bseq, blens) = a, b
    for s, (x, y) in enumerate(zip(alens, blens)):
        np.testing.assert_array_equal(x, y, err_msg=f"after step {s - 1}")
    np.testing.assert_array_equal(aseq, bseq)


def waves(lens):
    """Decode steps at which some layer's length shrank."""
    return [s - 1 for s in range(1, len(lens))
            if (lens[s] < lens[s - 1]).any()]


# (metric, per_qhead, B, JAX host path too)
CASES = [("none", True, 1, False), ("none", False, 2, False),
         ("fixed", True, 1, False), ("fixed", False, 2, False),
         ("linear", True, 2, False), ("linear", False, 1, False),
         ("jump", True, 1, True), ("jump", False, 1, True),
         ("jump", True, 2, False)]


@pytest.mark.parametrize("metric,per_qhead,B,jax_host", CASES)
def test_tokens_and_lengths_match_jax_every_step(weights, metric, per_qhead,
                                                 B, jax_host):
    jp, tp = weights
    jc, je, tc, te = configs(metric, per_qhead)
    toks, tl = prompt(B, seed=B)
    jrun = jax_steps(jc, je, jp, toks, tl)
    trun = torch_steps(tc, te, tp, toks, tl)
    assert_same(jrun, trun)
    lens = trun[1]
    assert max(x.max() for x in lens) <= te.cache_capacity(tc)
    # The dense skip layer never compresses; a step that fires ends no
    # longer than it began (fixed rewrites to the length it reached).
    assert (np.diff(np.stack(lens)[:, 0], axis=0) == 1).all()
    fired = any((b <= a).any() for a, b in zip(lens, lens[1:]))
    assert fired == (metric != "none")
    if B == 1:
        # The port's host path against its cond mode, then the JAX
        # package's host path.
        assert_same(trun, torch_steps(tc, te, tp, toks, tl, host=True))
        if jax_host:
            assert_same(jax_steps(jc, je, jp, toks, tl, host=True), trun)


def test_jump_wave_spans_two_steps(weights):
    """The skip layer advances no counter, so one step cannot make all L
    jump_layer increments: waves come in pairs of consecutive steps that
    fire different layers, never the skip layer.  The port's mirror plans
    the JAX package's steps exactly, and the cache follows it."""
    from scope_tpu.compression.host_sched import QuestHostScheduler as JQ
    from scope_tpu_torch.compression.host_sched import QuestHostScheduler
    jc, _, tc, te = configs("jump", True)
    mine, ref = QuestHostScheduler(tc, 4, 100, 64), JQ(jc, 4, 100, 64)
    fires = []
    for step in range(200):
        a, b = mine.plan_step(), ref.plan_step()
        assert (a.fire, a.n_keep) == (list(b.fire), list(b.n_keep)), step
        assert mine.lengths == ref.lengths
        if a.fire_any:
            fires.append((step, tuple(a.fire)))
    (s0, f0), (s1, f1) = fires[:2]
    assert s1 == s0 + 1 and f0 != f1 and not f0[0] and not f1[0]
    _, tp = weights
    toks, tl = prompt(1)
    _, lens = torch_steps(tc, te, tp, toks, tl, host=True)
    w = waves(lens)
    assert len(w) >= 2 and w[1] == w[0] + 1, w


def test_generate_matches_generate_scan(weights):
    """B=2 ragged, quest + jump per query head: tokens and done steps."""
    jp, tp = weights
    jc, je, tc, te = configs("jump", True)
    toks, tl = prompt(2, seed=5)
    gen_j, done_j = generate_scan(JSPEC, jc, je, jp, jnp.asarray(toks),
                                  jnp.asarray(tl), STEPS + 1, NO_EOS)
    gen_t, done_t = generate(TSPEC, tc, te, tp, toks, tl, STEPS + 1, NO_EOS,
                             device="cpu")
    np.testing.assert_array_equal(np.asarray(gen_j), gen_t.numpy())
    np.testing.assert_array_equal(np.asarray(done_j), done_t.numpy())


def test_host_generate_and_streaming_match_cond(weights):
    """The host path with chunked hot runs and StreamingGenerator, against
    cond mode; the mirror ends at the cache's per-layer lengths."""
    _, tp = weights
    _, _, tc, te = configs("jump", False)
    toks, tl = prompt(1, seed=3)
    ref, _ = generate(TSPEC, tc, te, tp, toks, tl, STEPS + 1, NO_EOS,
                      device="cpu")
    gen, stats = host_generate(TSPEC, tc, te.replace(
        decode_chunk_sizes=(4, 2)), tp, toks, tl, STEPS + 1, device="cpu")
    np.testing.assert_array_equal(gen, ref.numpy())
    assert stats["mirror_lengths"] == stats["cache_length"]
    sg = StreamingGenerator(TSPEC, tc, te, tp, eos_ids=(NO_EOS,),
                            device="cpu")
    assert sg.host_decoder is not None and sg.host_decoder.quest
    np.testing.assert_array_equal(sg.generate(toks, tl, STEPS + 1).tokens,
                                  ref.numpy())


def test_int8_kv_matches_jax(weights):
    jp, tp = weights
    jc, je, tc, te = configs("jump", False, kv_dtype="int8")
    toks, tl = prompt(1, seed=4)
    assert_same(jax_steps(jc, je, jp, toks, tl),
                torch_steps(tc, te, tp, toks, tl))


def test_paged_decode_region_matches_jax(weights):
    """quest_decode_pages = 2 (metric none): the region outgrows the page
    budget within the run, so selection matters; cond mode and the host
    path (one pinned decode bucket) against the JAX package's."""
    jp, tp = weights
    jc, je, tc, te = configs("none", False, pages=2)
    toks, tl = prompt(1, seed=6)
    jrun = jax_steps(jc, je, jp, toks, tl)
    assert_same(jrun, torch_steps(tc, te, tp, toks, tl))
    assert_same(jrun, torch_steps(tc, te, tp, toks, tl, host=True))
    dec = HostScheduledDecoder(TSPEC, tc, te)
    assert dec.dec_bucket_for(1) == dec.dec_bucket_for(40)


@pytest.mark.parametrize("per_qhead", [True, False])
def test_int4_decode_from_jax_prefill_matches_jax(weights, per_qhead):
    """int4 quest from the JAX package's prefill cache (codes, scales,
    offsets and the uint8 page codes carried over)."""
    jp, tp = weights
    jc, je, tc, te = configs("fixed", per_qhead, kv_dtype="int4")
    toks, tl = prompt(1, seed=8)
    box = []
    jrun = jax_steps(jc, je, jp, toks, tl, cache_out=box)
    logits, ct, _ = tllama.prefill(TSPEC, tc, te, tp, torch.from_numpy(toks),
                                   torch.from_numpy(tl))
    for name in ("k", "v", "length", "pvalid", "k_scale", "v_scale", "k_off",
                 "v_off", "page_min", "page_max"):
        setattr(ct, name, torch.from_numpy(np.array(getattr(box[0], name))))
    assert ct.page_min.dtype == torch.uint8
    jl = jax.jit(partial(jllama.prefill, JSPEC, jc, je))(
        jp, jnp.asarray(toks), jnp.asarray(tl))[0]
    trun = torch_steps(tc, te, tp, toks, tl,
                       cache=(torch.from_numpy(np.array(jl)), ct))
    assert_same(jrun, trun)
