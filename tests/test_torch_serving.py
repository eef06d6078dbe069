"""The port's continuous-batching ServingEngine against the JAX package.

tiny-llama in float32 on the CPU, one numpy weight set carried into both
packages with ``params_from_jax``, at the knobs of tests/test_serving.py
(P=64, w=8, W=32, r=16, delta=3, 128-token bucket).  The counterparts of
its ported cases: each request's tokens identical to the JAX package's
``generate_scan`` run of that request alone, and to the JAX package's own
``ServingEngine`` given the same submits; pipelined fetches identical to
unpipelined ones; the native slot scheduler identical to its plain version
and to the JAX package's wrapper; an idle slot that outlives the cache's
free slots leaves the active rows' tokens unchanged.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from scope_tpu.config import CompressionConfig as JComp
from scope_tpu.config import EngineConfig as JEngine
from scope_tpu.engine.generate import generate_scan
from scope_tpu.engine.serving import ServingEngine as JServingEngine
from scope_tpu.models import llama as jllama
from scope_tpu.models.registry import TINY_LLAMA
from scope_tpu.native import SlotScheduler as JSlotScheduler

from scope_tpu_torch import CompressionConfig, EngineConfig
from scope_tpu_torch.engine.generate import generate
from scope_tpu_torch.engine.serving import ServingEngine
from scope_tpu_torch.models.convert import params_from_jax
from scope_tpu_torch.models.registry import get_spec
from scope_tpu_torch.native import PySlotScheduler, SlotScheduler

TSPEC = get_spec("tiny-llama")
ENGINE = dict(max_prompt_len=128, max_new_tokens=32, dtype="float32")


def configs(metric="none", per_qhead=True, **engine):
    kw = dict(method="h2o", decoding_metric=metric, max_capacity_prompt=64,
              window_size=8, decoding_window_size=32,
              decoding_recent_size=16, delta=3, evict_per_qhead=per_qhead)
    ekw = dict(ENGINE, **engine)
    return JComp(**kw), JEngine(**ekw), CompressionConfig(**kw), \
        EngineConfig(**ekw)


@pytest.fixture(scope="module")
def weights():
    params = jllama.init_params(TINY_LLAMA, jax.random.key(0), jnp.float32)
    return params, params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                   device="cpu", dtype=torch.float32)


def prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 512, n).astype(np.int32) for n in lens]


def serve(tc, te, tp, ps, max_new, max_slots=2, **kw):
    eng = ServingEngine(TSPEC, tc, te, tp, max_slots=max_slots, device="cpu",
                        **kw)
    ids = [eng.submit(p, max_new) for p in ps]
    res = eng.run()
    return eng, [res[i] for i in ids]


def jax_single(jc, je, jp, p, max_new):
    toks = np.zeros((1, je.bucket_for(len(p))), np.int32)
    toks[0, :len(p)] = p
    gen, _ = generate_scan(TINY_LLAMA, jc, je, jp, jnp.asarray(toks),
                           jnp.array([len(p)], jnp.int32), max_new, -1)
    return np.asarray(gen[0])


def assert_matches_single_stream(jc, je, jp, ps, results, max_new):
    for p, got in zip(ps, results):
        np.testing.assert_array_equal(jax_single(jc, je, jp, p, max_new),
                                      np.array(got))


# ------------------------------ slot scheduler ------------------------------

def test_slot_scheduler_lifecycle():
    s = SlotScheduler(max_slots=2, token_budget=1000)
    r1, r2, r3 = (s.submit(100, 10) for _ in range(3))
    assert s.queued == 3 and s.active == 0
    a1, a2 = s.admit(), s.admit()
    assert a1[1] == r1 and a2[1] == r2
    assert s.admit() is None                # no free slot for r3
    assert s.active == 2 and s.queued == 1 and s.live_tokens == 220
    for _ in range(9):
        assert not s.step(a1[0])
    assert s.step(a1[0])                    # hits max_new
    assert s.finish(a1[0]) == r1
    a3 = s.admit()
    assert a3 is not None and a3[1] == r3


def test_slot_scheduler_token_budget():
    s = SlotScheduler(max_slots=4, token_budget=250)
    for _ in range(3):
        s.submit(100, 10)
    assert s.admit() is not None and s.admit() is not None
    assert s.admit() is None                # 330 > 250
    assert s.active == 2


def _random_ops(seed, n=400):
    rng = np.random.default_rng(seed)
    return [(rng.choice(["submit", "admit", "step", "finish", "snap"],
                        p=[0.3, 0.25, 0.3, 0.1, 0.05]),
             int(rng.integers(0, 3)), int(rng.integers(1, 40)),
             int(rng.integers(1, 12))) for _ in range(n)]


def _drive(sched, ops):
    """Every op's result and the counters after it; a snapshot taken
    mid-sequence is restored into a fresh scheduler of the same kind."""
    out = []
    for op, slot, pl, mn in ops:
        if op == "submit":
            r = sched.submit(pl, mn)
        elif op == "admit":
            r = sched.admit()
        elif op == "step":
            r = sched.step(slot)
        elif op == "finish":
            r = sched.finish(slot)
        else:
            snap = sched.snapshot()
            fresh = type(sched)(3, 120, queue_cap=6)
            fresh.restore(snap)
            sched, r = fresh, None
        out.append((op, r, sched.active, sched.queued, sched.live_tokens))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_slot_scheduler_matches_plain_and_jax(seed):
    """On random op sequences (a full queue, budget refusals, steps and
    finishes of free slots, snapshot/restore), the native scheduler, its
    plain version and the JAX package's wrapper give the same results."""
    ops = _random_ops(seed)
    native = _drive(SlotScheduler(3, 120, queue_cap=6), ops)
    assert native == _drive(PySlotScheduler(3, 120, queue_cap=6), ops)
    jax_ops = [o for o in ops if o[0] != "snap"]
    native = _drive(SlotScheduler(3, 120, queue_cap=6), jax_ops)
    assert native == _drive(JSlotScheduler(3, 120, queue_cap=6), jax_ops)
    assert any(r == -1 for op, r, *_ in native if op == "submit")


# ------------------------------ serving engine ------------------------------

def test_serving_matches_single_stream(weights):
    jp, tp = weights
    jc, je, tc, te = configs("none")
    ps = prompts(0, (100, 77, 120, 90))
    eng, res = serve(tc, te, tp, ps, 8, max_slots=3)
    assert_matches_single_stream(jc, je, jp, ps, res, 8)


@pytest.mark.parametrize("metric,lens,max_new,seed", [
    ("fixed", (100, 100, 100), 24, 1),
    ("linear", (100, 90, 110), 20, 3),
    ("jump", (100, 90, 110), 20, 3),
    ("h2o", (100, 77, 120), 24, 2)])
def test_serving_per_slot_schedules_match_single_stream(weights, metric, lens,
                                                        max_new, seed):
    """Per-row fixed gates, per-slot linear / jump counters and the h2o
    metric under continuous batching, with slot reuse: each request
    matches its dedicated single-stream run."""
    jp, tp = weights
    jc, je, tc, te = configs(metric)
    ps = prompts(seed, lens)
    _, res = serve(tc, te, tp, ps, max_new)
    assert_matches_single_stream(jc, je, jp, ps, res, max_new)


def test_serving_rejects_mismatched_method_metric(weights):
    with pytest.raises(ValueError):
        ServingEngine(TSPEC, configs("slm")[2], configs()[3], weights[1],
                      device="cpu")


@pytest.mark.parametrize("kw,comp", [
    (dict(prefill_chunk=32, mesh=object()), {}), (dict(mesh=object()), {}),
    ({}, dict(method="quest", mistral_window_parity=True)),
    ({}, dict(method="allkv", mistral_window_parity=True))])
def test_serving_refuses_what_is_not_ported(weights, kw, comp):
    # Chunked admission and Quest are ported; a mesh and the Mistral
    # window parity are not, whatever they come with.
    tc = configs("fixed")[2].replace(**comp)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ServingEngine(TSPEC, tc, configs()[3], weights[1], device="cpu", **kw)


@pytest.mark.parametrize("n_prompt,max_new", [(0, 4), (129, 4), (50, 0)])
def test_serving_rejects_bad_requests(weights, n_prompt, max_new):
    """An empty prompt, one past max_prompt_len or no token to generate is
    refused at submit, before it takes a place in the queue."""
    _, _, tc, te = configs("none")
    eng = ServingEngine(TSPEC, tc, te, weights[1], device="cpu")
    with pytest.raises(ValueError):
        eng.submit(np.ones(n_prompt, np.int32), max_new)
    assert eng.sched.queued == 0


def test_serving_queue_overflow_admits_later(weights):
    _, tp = weights
    _, _, tc, te = configs("none")
    ps = prompts(2, [60 + 7 * i for i in range(5)])
    _, res = serve(tc, te, tp, ps, 5)
    assert [len(r) for r in res] == [5] * 5


def test_serving_headline_config_kvhead_int8(weights):
    """h2o + jump, per-KV-head eviction, int8 KV, with chunked hot runs:
    token-identical to dedicated single-stream generation."""
    jp, tp = weights
    jc, je, tc, te = configs("jump", per_qhead=False, kv_dtype="int8")
    ps = prompts(11, (100, 90, 80))
    eng, res = serve(tc, te.replace(decode_chunk_sizes=(4, 2)), tp, ps, 20)
    assert eng.cache.k.dtype == torch.int8
    assert eng.cache.k.shape[2] == TSPEC.num_kv_heads
    assert_matches_single_stream(jc, je, jp, ps, res, 20)


def test_serving_headline_config_int4(weights):
    """The int4 counterpart, on the inputs of tests/test_int4_kv.py::
    test_int4_serving_headline_matches_single_stream: token-identical to
    the port's own single-stream generation.  (Not to the JAX package's:
    int4 calibration puts channel extremes on rounding ties, which the two
    packages' float32 prefills break differently; tests/
    test_torch_quant_generate.py holds that difference to the ties.)"""
    _, tp = weights
    _, _, tc, te = configs("jump", per_qhead=False, kv_dtype="int4")
    ps = prompts(11, (100, 90, 80))
    eng, res = serve(tc, te.replace(decode_chunk_sizes=(4, 2)), tp, ps, 20)
    assert eng.cache.k.dtype == torch.uint8
    assert eng.cache.k.shape[-1] == TSPEC.head_dim // 2
    for p, got in zip(ps, res):
        toks = np.zeros((1, 128), np.int32)
        toks[0, :len(p)] = p
        gen, _ = generate(TSPEC, tc, te, tp, toks,
                          np.array([len(p)], np.int32), 20, -1, device="cpu")
        np.testing.assert_array_equal(gen[0].numpy(), np.array(got))


@pytest.mark.parametrize("depth", [0, 3])
def test_serving_pipeline_depths_match(weights, depth):
    """Pipelined fetches (EOS and budget detection trailing the dispatch
    stream) give exactly the unpipelined engine's tokens, with an early EOS
    finish, slot reuse, chunked hot runs and a sampled request."""
    _, tp = weights
    _, _, tc, te = configs("jump", decode_chunk_sizes=(4, 2))
    ps = prompts(13, (100, 77, 120, 90, 64))

    def run(pdepth, eos):
        eng = ServingEngine(TSPEC, tc, te, tp, max_slots=2, eos_ids=eos,
                            pipeline_depth=pdepth, device="cpu")
        ids = [eng.submit(p, 12, **(dict(temperature=0.8, top_k=8, seed=42)
                                    if i == 2 else {}))
               for i, p in enumerate(ps)]
        res = eng.run()
        return [res[i] for i in ids]

    res0 = run(0, ())
    eos = (int(res0[0][5]),)
    ref = run(0, eos)
    assert any(len(r) < 12 for r in ref)
    assert run(depth, eos) == ref


def test_serving_chunked_decode_matches_per_step(weights):
    """Multi-step hot chunks give exactly the per-step engine's tokens."""
    _, tp = weights
    _, _, tc, te = configs("jump")
    ps = prompts(5, (100, 77, 120, 90, 64))
    _, ref = serve(tc, te, tp, ps, 12)
    _, got = serve(tc, te.replace(decode_chunk_sizes=(4, 2)), tp, ps, 12)
    assert got == ref


def test_serving_request_metrics(weights):
    _, tp = weights
    _, _, tc, te = configs("none")
    ps = prompts(5, [80 + 9 * i for i in range(4)])
    eng = ServingEngine(TSPEC, tc, te, tp, max_slots=2, device="cpu")
    ids = [eng.submit(p, 6) for p in ps]
    res = eng.run()
    for rid in ids:
        m = eng.request_metrics[rid]
        assert 0 <= m["queue_s"] <= m["ttft_s"] <= m["total_s"]
        assert m["ttft_s"] > m["queue_s"]
        assert m["n_tokens"] == len(res[rid]) == 6
        assert m["tpot_s"] >= 0
    assert (eng.request_metrics[ids[-1]]["queue_s"]
            >= eng.request_metrics[ids[0]]["queue_s"])


@pytest.mark.parametrize("kv_dtype,per_qhead", [("bfloat16", True),
                                                ("int8", False)])
def test_serving_matches_jax_serving_engine(weights, kv_dtype, per_qhead):
    """The JAX package's ServingEngine given the same submits (three
    slots, five ragged requests, chunked hot runs, pipelined fetches)
    returns the same tokens for every request."""
    jp, tp = weights
    jc, je, tc, te = configs("jump", per_qhead, kv_dtype=kv_dtype,
                             decode_chunk_sizes=(4, 2))
    ps = prompts(17, (100, 77, 120, 64, 90))
    _, res = serve(tc, te, tp, ps, 16, max_slots=3)
    jeng = JServingEngine(TINY_LLAMA, jc, je, jp, max_slots=3)
    jids = [jeng.submit(p, 16) for p in ps]
    jres = jeng.run()
    assert res == [jres[i] for i in jids]


SYNCS = ("item", "tolist", "__bool__", "__int__", "__float__", "__index__",
         "numpy")


@pytest.mark.parametrize("sampled", [False, True])
def test_serving_dispatch_reads_nothing_from_the_device(weights, monkeypatch,
                                                        sampled):
    """Every dispatch (hot steps, force steps gated to part of the rows,
    hot chunks, with int8 KV) asks the device for nothing: each host read
    of a tensor raises while a dispatch runs.  Gates, keep counts and
    positions only travel host to device; tokens come back afterwards."""
    _, tp = weights
    _, _, tc, te = configs("jump", per_qhead=False, kv_dtype="int8",
                           decode_chunk_sizes=(4, 2))
    eng = ServingEngine(TSPEC, tc, te, tp, max_slots=2, device="cpu")
    ps = prompts(23, (100, 90, 110, 80))
    for i, p in enumerate(ps):
        eng.submit(p, 32, **(dict(temperature=0.7, top_k=5, seed=3)
                             if sampled and i == 1 else {}))
    dispatch, calls = eng._dispatch, []

    def guarded():
        def refuse(self, *a, **k):
            raise AssertionError("the device was asked for a value")
        with monkeypatch.context() as m:
            for name in SYNCS:
                m.setattr(torch.Tensor, name, refuse)
            dispatch()
        calls.append(1)

    force, forced = eng._hdec.step_force, []
    eng._dispatch = guarded
    eng._hdec.step_force = lambda *a, **k: forced.append(1) or force(*a, **k)
    res = eng.run()
    assert sorted(len(t) for t in res.values()) == [32] * 4
    assert len(calls) > 20 and forced


def test_serving_idle_slot_outlives_the_cache(weights):
    """A slot idles while another request decodes for longer than the
    idle row's free cache slots last: every decode step still runs that
    row, whose appends reach the capacity and stay in its last slot.  The
    active rows' tokens are unchanged."""
    jp, tp = weights
    jc, je, tc, te = configs("jump", max_new_tokens=100)
    capacity = te.cache_capacity(tc)
    ps = prompts(19, (100, 110))
    eng = ServingEngine(TSPEC, tc, te, tp, max_slots=2, device="cpu")
    ids = [eng.submit(ps[0], 4), eng.submit(ps[1], 96)]
    res = eng.run()
    # The idle row appended past its capacity; the active row did not.
    lengths = eng.cache.length
    assert int(lengths[:, 0].min()) > capacity
    assert int(lengths[:, 1].max()) < capacity
    assert_matches_single_stream(jc, je, jp, ps[1:], [res[ids[1]]], 96)
    assert len(res[ids[0]]) == 4
