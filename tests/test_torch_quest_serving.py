"""Quest served by the port's ServingEngine, against the JAX package.

tiny-llama in float32 on the CPU, one numpy weight set carried into both
packages, the knobs of tests/test_serving.py's quest cases (P=64, chunk 8,
one skip layer, W=32, r=16, delta=3, 128-token bucket): two slots, three
ragged requests, so a slot is reused and its page rows replaced.  Each
slot runs its own ``QuestHostScheduler`` and a force step gates [L, B]:
tokens identical to the JAX package's dedicated ``generate_scan`` per
request for every decode metric, with per-step dispatch and with hot
chunks, and with the paged decode region; the port's engine also equals
the JAX package's ServingEngine, and a snapshot taken mid-run and
restored into a fresh engine finishes with the same tokens.
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

from scope_tpu_torch import CompressionConfig, EngineConfig
from scope_tpu_torch.engine.serving import ServingEngine
from scope_tpu_torch.models.convert import params_from_jax
from scope_tpu_torch.models.registry import get_spec

ENGINE = dict(max_prompt_len=128, max_new_tokens=32, dtype="float32")
TSPEC = get_spec("tiny-llama")
NEW = 16


@pytest.fixture(scope="module")
def weights():
    jp = jllama.init_params(TINY_LLAMA, jax.random.key(0), jnp.float32)
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                               device="cpu", dtype=torch.float32)


def configs(metric, pages=0, **engine):
    kw = dict(method="quest", decoding_metric=metric, max_capacity_prompt=64,
              window_size=8, decoding_window_size=32,
              decoding_recent_size=16, delta=3, chunk_size=8,
              quest_skip_layers=1, quest_decode_pages=pages)
    ekw = dict(ENGINE, **engine)
    return JComp(**kw), JEngine(**ekw), CompressionConfig(**kw), \
        EngineConfig(**ekw)


def prompts(seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 512, n).astype(np.int32) for n in (100, 90, 110)]


def serve(tc, te, tp, ps, slots=2):
    eng = ServingEngine(TSPEC, tc, te, tp, max_slots=slots, device="cpu")
    assert eng._host_mode and eng.cache.page_min is not None
    ids = [eng.submit(p, NEW) for p in ps]
    res = eng.run()
    return [res[i] for i in ids]


def single_stream(jc, je, jp, ps):
    out = []
    for p in ps:
        toks = np.zeros((1, 128), np.int32)
        toks[0, :len(p)] = p
        gen, _ = generate_scan(TINY_LLAMA, jc, je, jp, jnp.asarray(toks),
                               jnp.array([len(p)], jnp.int32), NEW, -1)
        out.append(np.asarray(gen[0]).tolist())
    return out


@pytest.mark.parametrize("metric", ["none", "fixed", "linear", "jump"])
def test_serving_quest_matches_single_stream(weights, metric):
    jp, tp = weights
    jc, je, tc, te = configs(metric)
    ps = prompts(23)
    assert serve(tc, te, tp, ps) == single_stream(jc, je, jp, ps)


def test_serving_quest_chunked_dispatch_matches_jax_engine(weights):
    """quest + jump with hot chunks (4, 2): the port's engine, per step
    and chunked, against the JAX package's engine."""
    jp, tp = weights
    jc, je, tc, te = configs("jump", decode_chunk_sizes=(4, 2))
    ps = prompts(29)
    eng = JServingEngine(TINY_LLAMA, jc, je, jp, max_slots=2)
    ids = [eng.submit(p, NEW) for p in ps]
    res = eng.run()
    want = [list(res[i]) for i in ids]
    assert serve(tc, te, tp, ps) == want
    assert serve(tc, te.replace(decode_chunk_sizes=()), tp, ps) == want


def test_serving_quest_paged_decode_matches_single_stream(weights):
    """quest_decode_pages: ragged prompts fold the metadata per row; a
    reused slot gets the new request's page rows."""
    jp, tp = weights
    jc, je, tc, te = configs("none", pages=4)
    ps = prompts(29)
    assert serve(tc, te, tp, ps) == single_stream(jc, je, jp, ps)


def test_serving_quest_snapshot_restore(weights):
    """A snapshot mid-run (page rows and per-slot mirrors included),
    restored into a fresh engine, finishes with the uninterrupted run's
    tokens."""
    _, tp = weights
    _, _, tc, te = configs("jump")
    ps = prompts(31)
    want = serve(tc, te, tp, ps)
    eng = ServingEngine(TSPEC, tc, te, tp, max_slots=2, device="cpu")
    ids = [eng.submit(p, NEW) for p in ps]
    for _ in range(9):
        eng.step()
    snap = eng.snapshot()
    assert snap["cache"]["page_min"] is not None
    fresh = ServingEngine(TSPEC, tc, te, tp, max_slots=2, device="cpu")
    fresh.restore(snap)
    res = fresh.run()
    assert [res[i] for i in ids] == want
