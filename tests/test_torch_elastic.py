"""Fail-stop recovery of the port's ServingEngine, the counterparts of
tests/test_elastic.py.

The engine snapshots its whole state (the cache and counters copied to the
host, the host mirrors, the native slot scheduler's bytes) and restores it
after a failure; the reference for every case is an uninterrupted run of
the same engine, which must give identical tokens.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from scope_tpu.models import llama as jllama
from scope_tpu.models.registry import TINY_LLAMA

from scope_tpu_torch import CompressionConfig, EngineConfig
from scope_tpu_torch.engine.serving import ServingEngine
from scope_tpu_torch.models.convert import params_from_jax
from scope_tpu_torch.models.registry import get_spec

TSPEC = get_spec("tiny-llama")
COMP = CompressionConfig(method="h2o", decoding_metric="jump",
                         max_capacity_prompt=64, window_size=8,
                         decoding_window_size=32, decoding_recent_size=16,
                         delta=3)


def ecfg(kv_dtype="bfloat16"):
    return EngineConfig(max_prompt_len=128, max_new_tokens=48,
                        dtype="float32", kv_dtype=kv_dtype)


@pytest.fixture(scope="module")
def setup():
    params = jllama.init_params(TINY_LLAMA, jax.random.key(5), jnp.float32)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                         device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 512, n).astype(np.int32)
               for n in (100, 90, 110, 80)]
    return tp, prompts


def engine(tp, kv_dtype="bfloat16"):
    return ServingEngine(TSPEC, COMP, ecfg(kv_dtype), tp, max_slots=2,
                         device="cpu")


def submit_all(eng, prompts, max_new=24):
    return [eng.submit(p, max_new) for p in prompts]


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_snapshot_restore_into_fresh_engine(setup, kv_dtype):
    tp, prompts = setup
    eng = engine(tp, kv_dtype)
    ids = submit_all(eng, prompts)
    ref = dict(eng.run())

    eng2 = engine(tp, kv_dtype)
    ids2 = submit_all(eng2, prompts)
    for _ in range(10):
        eng2.step()
    snap = eng2.snapshot()
    # The process dies: a brand-new engine restores and finishes the work.
    eng3 = engine(tp, kv_dtype)
    eng3.restore(snap)
    out = eng3.run()
    for a, b in zip(ids, ids2):
        assert ref[a] == out[b]
    assert set(out) == set(ids2)


def test_run_recovers_from_injected_failure(setup):
    tp, prompts = setup
    eng = engine(tp)
    ids = submit_all(eng, prompts)
    ref = dict(eng.run())

    eng2 = engine(tp)
    ids2 = submit_all(eng2, prompts)
    boom = {"left": 2}
    orig_step = eng2.step

    def flaky_step():
        if 0 < eng2.sched.live_tokens and boom["left"] > 0 \
                and len(eng2.results) >= 1:
            boom["left"] -= 1
            raise RuntimeError("injected device failure")
        return orig_step()

    eng2.step = flaky_step
    out = eng2.run(snapshot_every=4, max_recoveries=3)
    assert boom["left"] == 0
    for a, b in zip(ids, ids2):
        assert ref[a] == out[b]


def test_run_gives_up_past_max_recoveries(setup):
    tp, prompts = setup
    eng = engine(tp)
    submit_all(eng, prompts[:1])

    def broken():
        raise RuntimeError("injected device failure")

    eng.step = broken
    with pytest.raises(RuntimeError, match="injected"):
        eng.run(snapshot_every=1, max_recoveries=2)


def test_recover_replays_post_snapshot_submissions(setup):
    tp, prompts = setup
    eng = engine(tp)
    ids_a = submit_all(eng, prompts[:2])
    for _ in range(6):
        eng.step()
    snap = eng.snapshot()
    # Submitted after the snapshot: lost on failure, replayed on recover.
    ids_b = submit_all(eng, prompts[2:])
    ref_engine = engine(tp)
    rids = submit_all(ref_engine, prompts)
    ref = ref_engine.run()

    eng2 = engine(tp)
    remap = eng2.recover(snap, {ids_b[0]: (prompts[2], 24),
                                ids_b[1]: (prompts[3], 24)})
    out = eng2.run()
    assert ref[rids[0]] == out[ids_a[0]]
    assert ref[rids[1]] == out[ids_a[1]]
    assert ref[rids[2]] == out[remap[ids_b[0]]]
    assert ref[rids[3]] == out[remap[ids_b[1]]]
    m = eng2.request_metrics[ids_a[0]]
    assert 0 <= m["ttft_s"] <= m["total_s"] and m["tpot_s"] >= 0
