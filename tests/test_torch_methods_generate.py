"""SnapKV, StreamingLLM, PyramidKV and headwise, end to end against the JAX
package.

tiny-llama in float32 on the CPU, one numpy weight set carried into both
packages with ``params_from_jax``, at the knobs of the other generate
tests (P=64, w=8, W=32, r=16, delta=3, 128-token bucket, 40 new tokens):
greedy tokens and per-layer cache lengths after prefill and after every
decode step identical to the JAX package's prefill / decode_step loop (the
steps ``generate_scan`` scans), and ``generate`` identical to that loop
for a ragged batch of each method and to ``generate_scan`` itself for two
of them.  PyramidKV runs in
its mid branch (prompts below 2(P - w)), where the port's larger cache
(``EngineConfig.cache_capacity``) binds no clamp.  Headwise runs on 4
layers, since layers below HEADWISE_SKIP_LAYERS = 3 are not compressed;
its per-kv-head case uses a model with as many kv heads as query heads,
the only one the JAX package's headwise prefill can run per kv head.

The fault test: at prompts of at least 2(P - w) tokens PyramidKV's
shallow layers keep more than the JAX package's capacity holds; the port
sizes its cache for them (ROADMAP §3).
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
from scope_tpu.models import llama as jllama
from scope_tpu.models.registry import TINY_LLAMA

from scope_tpu_torch import CompressionConfig, EngineConfig
from scope_tpu_torch.compression.host_sched import pyramid_prefill_kept
from scope_tpu_torch.engine.generate import StreamingGenerator, generate
from scope_tpu_torch.engine.host_loop import HostScheduledDecoder
from scope_tpu_torch.models import llama as tllama
from scope_tpu_torch.models.convert import params_from_jax
from scope_tpu_torch.models.registry import get_spec

STEPS = 39
NO_EOS = 999999
ENGINE = dict(max_prompt_len=128, max_new_tokens=40, dtype="float32")
# name: (num_layers, num_kv_heads)
SPECS = {"tiny2": (2, 2), "tiny4": (4, 2), "tiny4_g1": (4, 4)}


def specs(name):
    L, hkv = SPECS[name]
    kw = dict(num_layers=L, num_kv_heads=hkv, name=name)
    return TINY_LLAMA.replace(**kw), get_spec("tiny-llama").replace(**kw)


@pytest.fixture(scope="module")
def weights():
    """Each spec's weights, made once for the module."""
    cache = {}

    def get(name):
        if name not in cache:
            jspec, _ = specs(name)
            jp = jllama.init_params(jspec, jax.random.key(7), jnp.float32)
            cache[name] = (jp, params_from_jax(
                jax.tree_util.tree_map(np.asarray, jp), device="cpu",
                dtype=torch.float32))
        return cache[name]
    return get


def configs(method, metric, per_qhead, **engine):
    kw = dict(method=method, decoding_metric=metric, max_capacity_prompt=64,
              window_size=32 if method == "streamingllm" else 8,
              decoding_window_size=32, decoding_recent_size=16, delta=3,
              evict_per_qhead=per_qhead, headwise_max_budget=64,
              headwise_min_budget=16, headwise_gamma=0.5)
    ekw = dict(ENGINE, **engine)
    return JComp(**kw), JEngine(**ekw), CompressionConfig(**kw), \
        EngineConfig(**ekw)


def prompt(B, seed=0, S=128):
    toks = np.random.default_rng(seed).integers(1, 512, (B, S))
    return toks.astype(np.int32), np.array((100, 77)[:B], np.int32)


def jax_steps(jspec, jc, je, jp, toks, tl, steps):
    """The JAX package's prefill and decode_step loop: tokens [B, steps+1]
    and per-layer lengths [L, B] after prefill and after each step."""
    logits, cache, state = jax.jit(partial(jllama.prefill, jspec, jc, je))(
        jp, jnp.asarray(toks), jnp.asarray(tl))
    step = jax.jit(partial(jllama.decode_step, jspec, jc, je))
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    seq, lens = [np.asarray(tok)], [np.asarray(cache.length)]
    for s in range(steps):
        logits, cache, state = step(jp, tok, jnp.asarray(tl + s), cache,
                                    state)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        seq.append(np.asarray(tok))
        lens.append(np.asarray(cache.length))
    return np.stack(seq, 1), lens


def torch_steps(tspec, tc, te, tp, toks, tl, steps):
    """The port's prefill and cond-mode decode_step loop, as
    :func:`jax_steps`; also returns the last cache."""
    logits, cache, state = tllama.prefill(tspec, tc, te, tp,
                                          torch.from_numpy(toks),
                                          torch.from_numpy(tl))
    tok = logits.argmax(-1).to(torch.int32)
    seq, lens = [tok.numpy()], [cache.length.numpy().copy()]
    for s in range(steps):
        logits, cache, state = tllama.decode_step(
            tspec, tc, te, tp, tok, torch.from_numpy(tl + s), cache, state)
        assert torch.isfinite(logits).all()
        tok = logits.argmax(-1).to(torch.int32)
        seq.append(tok.numpy())
        lens.append(cache.length.numpy().copy())
    return np.stack(seq, 1), lens, cache


def assert_same_run(jrun, trun):
    (jseq, jlens), (tseq, tlens) = jrun, trun[:2]
    for s, (a, b) in enumerate(zip(jlens, tlens)):
        np.testing.assert_array_equal(a, b, err_msg=f"after step {s - 1}")
    np.testing.assert_array_equal(jseq, tseq)


# (method, metric, per_qhead, B, spec)
CASES = [
    ("snapkv", "fixed", True, 1, "tiny2"), ("snapkv", "fixed", False, 1,
                                            "tiny2"),
    ("snapkv", "jump", True, 1, "tiny2"), ("snapkv", "jump", False, 1,
                                           "tiny2"),
    ("snapkv", "jump", False, 2, "tiny2"),
    ("streamingllm", "linear", True, 1, "tiny2"),
    ("streamingllm", "linear", False, 1, "tiny2"),
    ("streamingllm", "slm", True, 1, "tiny2"),
    ("streamingllm", "slm", False, 1, "tiny2"),
    ("streamingllm", "slm", True, 2, "tiny2"),
    ("pyramidkv", "jump", True, 1, "tiny2"),
    ("pyramidkv", "jump", False, 1, "tiny2"),
    ("pyramidkv", "pyramidinfer", True, 1, "tiny2"),
    ("pyramidkv", "pyramidinfer", False, 1, "tiny2"),
    ("pyramidkv", "jump", True, 2, "tiny2"),
    ("headwise", "none", True, 1, "tiny4"),
    ("headwise", "none", False, 1, "tiny4_g1"),
    ("headwise", "jump", True, 1, "tiny4"),
    ("headwise", "jump", False, 1, "tiny4_g1"),
    ("headwise", "jump", True, 2, "tiny4"),
]


@pytest.mark.parametrize("method,metric,per_qhead,B,spec", CASES)
def test_tokens_and_lengths_match_jax_every_step(weights, method, metric,
                                                 per_qhead, B, spec):
    jp, tp = weights(spec)
    jspec, tspec = specs(spec)
    jc, je, tc, te = configs(method, metric, per_qhead)
    toks, tl = prompt(B, seed=B)
    jrun = jax_steps(jspec, jc, je, jp, toks, tl, STEPS)
    trun = torch_steps(tspec, tc, te, tp, toks, tl, STEPS)
    assert_same_run(jrun, trun)
    lens, cache = trun[1], trun[2]
    cap = te.cache_capacity(tc)
    assert max(x.max() for x in lens) <= cap
    if metric != "none":
        # A step that fires ends no longer than it began (fixed-size
        # metrics rewrite to the length they reached).
        fired = [np.any(b <= a) for a, b in zip(lens, lens[1:])]
        assert any(fired), "no decode compression fired"
    if B == 2:
        gen, _ = generate(tspec, tc, te, tp, toks, tl, STEPS + 1, NO_EOS,
                          device="cpu")
        np.testing.assert_array_equal(gen.numpy(), jrun[0])
    if method == "headwise":
        pv = cache.pvalid.numpy()
        assert (pv[:3] == np.minimum(tl, 64)[None, :, None]).all()
        assert ((pv[3] >= 16) & (pv[3] <= 64)).all() and (pv[3] < 64).any()
    if method == "pyramidkv":
        for b in range(B):
            np.testing.assert_array_equal(
                lens[0][:, b], pyramid_prefill_kept(tc, 2, int(tl[b]), 128))


@pytest.mark.parametrize("method,metric,spec", [
    ("streamingllm", "slm", "tiny2"), ("pyramidkv", "jump", "tiny2")])
def test_generate_matches_generate_scan(weights, method, metric, spec):
    """B=2 ragged, per-query-head: tokens and done steps against
    ``generate_scan`` itself (the other cases hold ``generate`` against
    the loop of the steps it scans)."""
    jp, tp = weights(spec)
    jspec, tspec = specs(spec)
    jc, je, tc, te = configs(method, metric, True)
    toks, tl = prompt(2, seed=5)
    gen_j, done_j = generate_scan(jspec, jc, je, jp, jnp.asarray(toks),
                                  jnp.asarray(tl), STEPS + 1, NO_EOS)
    gen_t, done_t = generate(tspec, tc, te, tp, toks, tl, STEPS + 1, NO_EOS,
                             device="cpu")
    np.testing.assert_array_equal(np.asarray(gen_j), gen_t.numpy())
    np.testing.assert_array_equal(np.asarray(done_j), done_t.numpy())


# ---------------------------------------------------------------------------
# the fault: pyramidkv's deep branch outgrows the JAX package's capacity
# ---------------------------------------------------------------------------

FAULT_COMP = dict(method="pyramidkv", decoding_metric="jump",
                  max_capacity_prompt=192, window_size=8,
                  decoding_window_size=24, decoding_recent_size=16, delta=3)
FAULT_ENGINE = dict(max_prompt_len=384, max_new_tokens=16, dtype="float32")


def test_pyramid_deep_branch_fits_the_port_capacity(weights):
    """true_len 380 >= 2(P - w) = 368: layer 0 keeps 367 tokens.  The JAX
    package's cache holds 256 (its lengths overstate it); the port's holds
    512, stores each layer's last w prompt tokens after its kept ones, and
    its host path plans the same lengths as its cond mode."""
    jp, tp = weights("tiny2")
    jspec, tspec = specs("tiny2")
    jc, je = JComp(**FAULT_COMP), JEngine(**FAULT_ENGINE)
    tc, te = CompressionConfig(**FAULT_COMP), EngineConfig(**FAULT_ENGINE)
    toks = np.random.default_rng(9).integers(1, 512, (1, 384)).astype(
        np.int32)
    tl = np.array([380], np.int32)
    _, jcache, _ = jax.jit(partial(jllama.prefill, jspec, jc, je))(
        jp, jnp.asarray(toks), jnp.asarray(tl))
    jlen = np.asarray(jcache.length)[:, 0]
    assert je.cache_capacity(jc) == 256 and jlen.max() > 256
    np.testing.assert_array_equal(jlen, [367, 192])

    cap = te.cache_capacity(tc)
    assert cap == 512
    cond_seq, cond_lens, cache = torch_steps(tspec, tc, te, tp, toks, tl, 15)
    kept = pyramid_prefill_kept(tc, 2, 380, 384)
    assert kept == [367, 192]
    np.testing.assert_array_equal(cond_lens[0][:, 0], kept)
    assert max(x.max() for x in cond_lens) <= cap

    # The last w = 8 prompt tokens sit right after each layer's kept ones:
    # fullkv stores every roped key in order.
    _, full, _ = tllama.prefill(tspec, tc.replace(method="fullkv",
                                                  decoding_metric="none"),
                                te, tp, torch.from_numpy(toks),
                                torch.from_numpy(tl))
    logits, hcache, state = tllama.prefill(tspec, tc, te, tp,
                                           torch.from_numpy(toks),
                                           torch.from_numpy(tl))
    for l, n in enumerate(kept):
        for got, ref in ((hcache.k, full.k), (hcache.v, full.v)):
            assert torch.equal(got[l, 0, :, n - 8:n], ref[l, 0, :, 372:380])

    # The layered host path, step by step, against cond mode.
    dec = HostScheduledDecoder(tspec, tc, te)
    sched = dec.new_scheduler(380, prompt_pad=384)
    tok = logits.argmax(-1).to(torch.int32)
    seq, lens = [tok.numpy()], [hcache.length.numpy().copy()]
    for s in range(15):
        logits, hcache, state = dec.step(sched, tp, tok,
                                         torch.from_numpy(tl + s), hcache,
                                         state)
        tok = logits.argmax(-1).to(torch.int32)
        seq.append(tok.numpy())
        lens.append(hcache.length.numpy().copy())
        assert sched.lengths == lens[-1][:, 0].tolist()
    np.testing.assert_array_equal(np.stack(seq, 1), cond_seq)
    for a, b in zip(lens, cond_lens):
        np.testing.assert_array_equal(a, b)
    assert min(x.min() for x in lens[1:]) < 367, "no wave fired"


def test_streaming_generator_paths(weights):
    """StreamingGenerator takes the host path for snapkv, streamingllm and
    pyramidkv (layered), cond mode for headwise."""
    _, tp = weights("tiny2")
    _, tspec = specs("tiny2")
    for method, metric, host in (("snapkv", "jump", True),
                                 ("streamingllm", "slm", True),
                                 ("pyramidkv", "pyramidinfer", True),
                                 ("headwise", "jump", False)):
        _, _, tc, te = configs(method, metric, True)
        sg = StreamingGenerator(tspec, tc, te, tp, eos_ids=(NO_EOS,),
                                device="cpu")
        assert (sg.host_decoder is not None) == host, method
        if method == "pyramidkv":
            assert sg.host_decoder.layered
