"""The port's main path end to end against the JAX package's.

tiny-llama in float32 on the CPU, one numpy weight set carried into both
packages with ``params_from_jax``, H2O prefill + SCOPE jump decode at the
verify recipe's knobs (P=64, w=8, W=32, r=16, delta=3, 128-token bucket,
48 new tokens).  Greedy tokens must be identical to ``generate_scan``, and
per-layer cache lengths equal after prefill and after every decode step.
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
from scope_tpu.models.registry import get_spec as jget_spec

from scope_tpu_torch import CompressionConfig, EngineConfig
from scope_tpu_torch.engine.generate import StreamingGenerator, generate
from scope_tpu_torch.models import llama as tllama
from scope_tpu_torch.models.convert import params_from_jax
from scope_tpu_torch.models.registry import get_spec

MAX_NEW = 48
NO_EOS = 999999
COMP = dict(method="h2o", decoding_metric="jump", max_capacity_prompt=64,
            window_size=8, decoding_window_size=32, decoding_recent_size=16,
            delta=3)
ENGINE = dict(max_prompt_len=128, max_new_tokens=MAX_NEW, dtype="float32")
TRUE_LEN = {1: (100,), 2: (100, 77)}


@pytest.fixture(scope="module")
def weights():
    spec = jget_spec("tiny-llama")
    params = jllama.init_params(spec, jax.random.key(7), jnp.float32)
    pnp = jax.tree_util.tree_map(np.asarray, params)
    return params, params_from_jax(pnp, device="cpu", dtype=torch.float32)


def _configs(per_qhead):
    kw = dict(COMP, evict_per_qhead=per_qhead)
    return (JComp(**kw), JEngine(**ENGINE), CompressionConfig(**kw),
            EngineConfig(**ENGINE))


def _prompt(B):
    toks = np.random.default_rng(0).integers(1, 512, (B, 128))
    return toks.astype(np.int32), np.array(TRUE_LEN[B], np.int32)


@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("per_qhead", [True, False])
def test_generate_matches_generate_scan(weights, per_qhead, B):
    jp, tp = weights
    jc, je, tc, te = _configs(per_qhead)
    toks, tl = _prompt(B)
    gen_j, done_j = generate_scan(jget_spec("tiny-llama"), jc, je, jp,
                                  jnp.asarray(toks), jnp.asarray(tl),
                                  MAX_NEW, NO_EOS)
    gen_t, done_t = generate(get_spec("tiny-llama"), tc, te, tp, toks, tl,
                             MAX_NEW, NO_EOS, device="cpu")
    np.testing.assert_array_equal(np.asarray(gen_j), gen_t.numpy())
    np.testing.assert_array_equal(np.asarray(done_j), done_t.numpy())


@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("per_qhead", [True, False])
def test_cache_lengths_match_every_step(weights, per_qhead, B):
    """Per-layer lengths after prefill and after each decode step, fed the
    same greedy tokens; a jump wave must fire (lengths fall)."""
    jp, tp = weights
    jc, je, tc, te = _configs(per_qhead)
    jspec, tspec = jget_spec("tiny-llama"), get_spec("tiny-llama")
    toks, tl = _prompt(B)
    lj, cj, sj = jax.jit(partial(jllama.prefill, jspec, jc, je))(
        jp, jnp.asarray(toks), jnp.asarray(tl))
    lt, ct, st = tllama.prefill(tspec, tc, te, tp, torch.from_numpy(toks),
                                torch.from_numpy(tl))
    lengths = [np.asarray(cj.length)]
    np.testing.assert_array_equal(lengths[-1], ct.length.numpy())
    step = jax.jit(partial(jllama.decode_step, jspec, jc, je))
    tok = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)
    for s in range(MAX_NEW - 1):
        vpos = tl + s
        lj, cj, sj = step(jp, jnp.asarray(tok), jnp.asarray(vpos), cj, sj)
        lt, ct, st = tllama.decode_step(tspec, tc, te, tp,
                                        torch.from_numpy(tok),
                                        torch.from_numpy(vpos), ct, st)
        lengths.append(np.asarray(cj.length))
        np.testing.assert_array_equal(lengths[-1], ct.length.numpy(),
                                      err_msg=f"decode step {s}")
        nxt = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)
        np.testing.assert_array_equal(nxt, lt.argmax(-1).numpy())
        tok = nxt
    fell = [np.any(b < a) for a, b in zip(lengths, lengths[1:])]
    assert any(fell), "no jump wave fired"
    assert max(x.max() for x in lengths) <= te.cache_capacity(tc)


@pytest.mark.parametrize("method,metric", [
    ("allkv", "jump"),     # per-row prompt segments: per-row block writes
    ("h2o", "fixed"), ("h2o", "linear"), ("fullkv", "none")])
def test_other_ported_paths_match_generate_scan(weights, method, metric):
    jp, tp = weights
    kw = dict(COMP, method=method, decoding_metric=metric)
    toks, tl = _prompt(2)
    gen_j, done_j = generate_scan(jget_spec("tiny-llama"), JComp(**kw),
                                  JEngine(**ENGINE), jp, jnp.asarray(toks),
                                  jnp.asarray(tl), MAX_NEW, NO_EOS)
    gen_t, done_t = generate(get_spec("tiny-llama"), CompressionConfig(**kw),
                             EngineConfig(**ENGINE), tp, toks, tl, MAX_NEW,
                             NO_EOS, device="cpu")
    np.testing.assert_array_equal(np.asarray(gen_j), gen_t.numpy())
    np.testing.assert_array_equal(np.asarray(done_j), done_t.numpy())


def test_streaming_generator_matches_generate_scan(weights):
    jp, tp = weights
    jc, je, tc, te = _configs(True)
    toks, tl = _prompt(1)
    gen_j, _ = generate_scan(jget_spec("tiny-llama"), jc, je, jp,
                             jnp.asarray(toks), jnp.asarray(tl), MAX_NEW,
                             NO_EOS)
    sg = StreamingGenerator(get_spec("tiny-llama"), tc, te, tp,
                            eos_ids=(NO_EOS,), device="cpu")
    res = sg.generate(toks, tl, MAX_NEW)
    np.testing.assert_array_equal(res.tokens, np.asarray(gen_j))
    assert res.gen_lengths[0] == MAX_NEW
    assert len(res.tpot_s) == MAX_NEW and res.ttft_s > 0


def test_eos_semantics_match_generate_scan(weights):
    """A row that emits eos keeps feeding eos; done_step counts to it."""
    jp, tp = weights
    jc, je, tc, te = _configs(True)
    toks, tl = _prompt(2)
    gen_j, _ = generate_scan(jget_spec("tiny-llama"), jc, je, jp,
                             jnp.asarray(toks), jnp.asarray(tl), MAX_NEW,
                             NO_EOS)
    eos = int(np.asarray(gen_j)[0, 10])       # a token row 0 emits mid-run
    gen_j, done_j = generate_scan(jget_spec("tiny-llama"), jc, je, jp,
                                  jnp.asarray(toks), jnp.asarray(tl),
                                  MAX_NEW, eos)
    gen_t, done_t = generate(get_spec("tiny-llama"), tc, te, tp, toks, tl,
                             MAX_NEW, eos, device="cpu")
    np.testing.assert_array_equal(np.asarray(gen_j), gen_t.numpy())
    np.testing.assert_array_equal(np.asarray(done_j), done_t.numpy())
    assert int(done_t[0]) <= 11
