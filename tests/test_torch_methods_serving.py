"""The port's ServingEngine with the SCOPE method grid, against the JAX
package's.

tiny-llama in float32 on the CPU, one numpy weight set carried into both
packages, at the knobs of tests/test_serving.py (P=64, w=8, W=32, r=16,
delta=3, 128-token bucket): three slots, five ragged requests, the same
submits to both engines, tokens identical for every request.  snapkv and
streamingllm (with its slm metric) run in host mode, per-slot mirrors;
pyramidkv and headwise run every step in the device's cond mode over the
pool, with per-row scheduler counters that each admission resets.  The
per-row counters are also held against the JAX package's directly, layer
call by layer call, with staggered resets.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from scope_tpu.compression import schedulers as jsched
from scope_tpu.config import CompressionConfig as JComp
from scope_tpu.config import EngineConfig as JEngine
from scope_tpu.engine.serving import ServingEngine as JServingEngine
from scope_tpu.models import llama as jllama
from scope_tpu.models.registry import TINY_LLAMA

from scope_tpu_torch import CompressionConfig, EngineConfig
from scope_tpu_torch.compression import schedulers as tsched
from scope_tpu_torch.engine.serving import ServingEngine
from scope_tpu_torch.models.convert import params_from_jax
from scope_tpu_torch.models.registry import get_spec

ENGINE = dict(max_prompt_len=128, max_new_tokens=32, dtype="float32")


def configs(method, metric, per_qhead=True, **engine):
    kw = dict(method=method, decoding_metric=metric, max_capacity_prompt=64,
              window_size=32 if method == "streamingllm" else 8,
              decoding_window_size=32, decoding_recent_size=16, delta=3,
              evict_per_qhead=per_qhead, headwise_max_budget=64,
              headwise_min_budget=16, headwise_gamma=0.5)
    ekw = dict(ENGINE, **engine)
    return JComp(**kw), JEngine(**ekw), CompressionConfig(**kw), \
        EngineConfig(**ekw)


@pytest.fixture(scope="module")
def weights():
    """(JAX spec, port spec, JAX params, port params) per layer count."""
    cache = {}

    def get(layers):
        if layers not in cache:
            jspec = TINY_LLAMA.replace(num_layers=layers)
            jp = jllama.init_params(jspec, jax.random.key(0), jnp.float32)
            cache[layers] = (jspec, get_spec("tiny-llama").replace(
                num_layers=layers), jp, params_from_jax(
                    jax.tree_util.tree_map(np.asarray, jp), device="cpu",
                    dtype=torch.float32))
        return cache[layers]
    return get


def prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 512, n).astype(np.int32) for n in lens]


# (method, metric, per_qhead, layers, chunks): host mode first, then the
# device-cond path.
SERVE_CASES = [
    ("streamingllm", "slm", True, 2, (4, 2)),
    ("snapkv", "jump", False, 2, (4, 2)),
    ("pyramidkv", "pyramidinfer", True, 2, ()),
    ("pyramidkv", "jump", False, 2, ()),
    ("headwise", "jump", True, 4, ()),
]


@pytest.mark.parametrize("method,metric,per_qhead,layers,chunks",
                         SERVE_CASES)
def test_serving_matches_jax_serving_engine(weights, method, metric,
                                            per_qhead, layers, chunks):
    jspec, tspec, jp, tp = weights(layers)
    jc, je, tc, te = configs(method, metric, per_qhead,
                             decode_chunk_sizes=chunks)
    ps = prompts(17, (100, 77, 120, 64, 90))
    eng = ServingEngine(tspec, tc, te, tp, max_slots=3, device="cpu")
    assert eng._host_mode == (method in ("snapkv", "streamingllm"))
    if not eng._host_mode:
        per_row = metric in ("linear", "jump")
        assert eng.state.step.shape == ((3,) if per_row else ())
    if method == "headwise":
        assert eng.cache.prefill_gap == 64
    ids = [eng.submit(p, 16) for p in ps]
    res = eng.run()
    jeng = JServingEngine(jspec, jc, je, jp, max_slots=3)
    jids = [jeng.submit(p, 16) for p in ps]
    jres = jeng.run()
    assert [res[i] for i in ids] == [jres[i] for i in jids]
    assert all(len(res[i]) == 16 for i in ids)


def test_serving_cond_path_resets_counters_at_admission(weights):
    """A slot's counters restart with each request it takes: the second
    request in a slot decodes as it would in a fresh engine."""
    _, tspec, _, tp = weights(2)
    _, _, tc, te = configs("pyramidkv", "jump")
    ps = prompts(3, (100, 90, 110))

    def run(reqs, slots):
        eng = ServingEngine(tspec, tc, te, tp, max_slots=slots, device="cpu")
        ids = [eng.submit(p, n) for p, n in reqs]
        res = eng.run()
        return [res[i] for i in ids], eng
    both, eng = run([(ps[0], 24), (ps[1], 12), (ps[2], 20)], 2)
    alone, _ = run([(ps[2], 20)], 1)
    assert both[2] == alone[0]
    assert eng.state.step.shape == (2,)


# ---------------------------------------------------------------------------
# per-row scheduler counters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metric", ["jump", "linear"])
def test_per_row_schedule_decision_matches_jax(metric):
    """SchedState.init(batch=3), every layer call of 60 steps, rows reset
    at different steps (new requests): gates, keep counts, pseg and every
    row's counters identical to the JAX package's."""
    kw = dict(method="pyramidkv", decoding_metric=metric,
              max_capacity_prompt=64, window_size=8, decoding_window_size=32,
              decoding_recent_size=16, delta=3)
    jc, tc = JComp(**kw), CompressionConfig(**kw)
    L, B, cap = 2, 3, 256
    caps = (jsched.static_keep_cap(jc, 60), cap)
    sj = jsched.SchedState.init(batch=B)
    st = tsched.SchedState.init(batch=B)
    length = np.array([[72, 60, 80], [70, 60, 75]], np.int32)      # [L, B]
    prompt_len = np.array([100, 60, 90], np.int32)
    fired = np.zeros(B, int)
    for step in range(60):
        if step in (9, 23):
            row = 1 if step == 9 else 2
            sj, st = sj.reset_row(row), st.reset_row(row)
            length[:, row] = 72
        length = length + 1
        for l in range(L):
            gj, nj, pj, _, sj = jsched.schedule_decision(
                jc, jsched.DecodeCaps(*caps), sj, length[l], prompt_len,
                l, L)
            gt, nt, pt, _, st = tsched.schedule_decision(
                tc, tsched.DecodeCaps(*caps), st, torch.from_numpy(length[l]),
                torch.from_numpy(prompt_len), l, L)
            for a, b in ((gj, gt), (nj, nt), (pj, pt), (sj.step, st.step),
                         (sj.jump_step, st.jump_step),
                         (sj.jump_layer, st.jump_layer)):
                np.testing.assert_array_equal(np.asarray(a), b.numpy())
            gate = np.asarray(gj)
            fired += gate
            length[l] = np.where(gate, np.asarray(pj) + np.asarray(nj) + 16,
                                 length[l])
    assert (fired > 0).all()


def test_reset_row_zeroes_one_row():
    st = tsched.SchedState.init(batch=3)
    st = st.replace(step=torch.tensor([4, 5, 6], dtype=torch.int32))
    out = st.reset_row(1)
    assert out.step.tolist() == [4, 0, 6] and st.step.tolist() == [4, 5, 6]
    assert tsched.SchedState.init().step.shape == ()
