"""Each module of the PyTorch port against its JAX counterpart.

Same numpy inputs through both packages, float32 on the CPU.  Exact where
the arithmetic is integer or a gather; 1e-5 (float32 rounding in another
op order) where it is floating point.
"""

import dataclasses
import subprocess
import sys
from functools import partial

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import scope_tpu.config as jconfig
from scope_tpu.cache import slot_mask as j_slot_mask
from scope_tpu.compression import policies as jpol
from scope_tpu.compression import schedulers as jsched
from scope_tpu.models import llama as jllama
from scope_tpu.models import registry as jregistry
from scope_tpu.ops import attention as jattn
from scope_tpu.ops import common as jcommon

import scope_tpu_torch.config as tconfig
from scope_tpu_torch.cache import slot_mask as t_slot_mask
from scope_tpu_torch.compression import policies as tpol
from scope_tpu_torch.compression import schedulers as tsched
from scope_tpu_torch.device import resolve_device
from scope_tpu_torch.models import llama as tllama
from scope_tpu_torch.models import registry as tregistry
from scope_tpu_torch.models.convert import params_from_jax
from scope_tpu_torch.ops import attention as tattn
from scope_tpu_torch.ops import common as tcommon

RNG = np.random.default_rng


def t(x):
    return torch.from_numpy(np.array(x))


def close(a, b, tol=1e-5):
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=tol,
                               atol=tol)


# ---------------------------------------------------------------------------
# config / registry
# ---------------------------------------------------------------------------

def test_registry_matches_jax():
    j_specs, t_specs = jregistry.list_specs(), tregistry.list_specs()
    assert sorted(j_specs) == sorted(t_specs)
    for name, js in j_specs.items():
        assert dataclasses.asdict(js) == dataclasses.asdict(t_specs[name])
    assert tregistry.get_spec("Llama-3.2-1B-Instruct").name == "llama-3.2-1b"


COMP_CASES = [
    dict(method="h2o", decoding_metric="jump", max_capacity_prompt=2048,
         window_size=8, decoding_window_size=512, decoding_recent_size=256,
         delta=30),
    dict(method="h2o", decoding_metric="fixed"),
    dict(method="h2o", decoding_metric="linear", delta=7),
    dict(method="allkv", decoding_metric="jump", max_capacity_prompt=64,
         decoding_window_size=32, decoding_recent_size=16, delta=3),
    dict(method="fullkv"),
    dict(method="snapkv", decoding_metric="pyramidinfer"),
    dict(method="headwise", decoding_metric="none"),
]


@pytest.mark.parametrize("i", range(len(COMP_CASES)))
def test_engine_capacities_match_jax(i):
    kw = COMP_CASES[i]
    jc, tc = jconfig.CompressionConfig(**kw), tconfig.CompressionConfig(**kw)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    for ekw in (dict(max_prompt_len=4096, max_new_tokens=7950),
                dict(max_prompt_len=128, max_new_tokens=48),
                dict(max_prompt_len=3000, max_new_tokens=100)):
        je, te = jconfig.EngineConfig(**ekw), tconfig.EngineConfig(**ekw)
        assert je.cache_capacity(jc) == te.cache_capacity(tc)
        assert je.decode_budget_cap(jc) == te.decode_budget_cap(tc)
        assert je.prompt_buckets() == te.prompt_buckets()
        assert je.bucket_for(100) == te.bucket_for(100)
        assert (jsched.static_keep_cap(jc, je.max_new_tokens)
                == tsched.static_keep_cap(tc, te.max_new_tokens))


@pytest.mark.parametrize("kw", [
    dict(method="nope"), dict(decoding_metric="nope"),
    dict(method="h2o", max_capacity_prompt=8, window_size=8),
    dict(decoding_metric="jump", decoding_window_size=16,
         decoding_recent_size=16),
    dict(method="h2o", quest_decode_pages=4),
])
def test_config_validation_matches_jax(kw):
    with pytest.raises(ValueError):
        jconfig.CompressionConfig(**kw)
    with pytest.raises(ValueError):
        tconfig.CompressionConfig(**kw)


def test_derive_delta_matches_jax():
    for args in ((7950, 512, 256), (48, 32, 16), (100, 300, 299)):
        assert jconfig.derive_delta(*args) == tconfig.derive_delta(*args)


# ---------------------------------------------------------------------------
# ops/common
# ---------------------------------------------------------------------------

COMMON_OPS = ["rms_norm", "rope_plain", "rope_llama31", "repeat_kv", "mlp"]


@pytest.mark.parametrize("op", COMMON_OPS)
def test_common_ops_match_jax(op):
    rng = RNG(COMMON_OPS.index(op))
    B, S, H, D = 2, 7, 4, 16
    if op == "rms_norm":
        x = rng.standard_normal((B, S, 64)).astype(np.float32)
        w = rng.standard_normal(64).astype(np.float32)
        close(jcommon.rms_norm(x, w, 1e-5), tcommon.rms_norm(t(x), t(w), 1e-5))
    elif op.startswith("rope"):
        scaling = (32.0, 1.0, 4.0, 8192) if op == "rope_llama31" else None
        theta = 500000.0 if scaling else 10000.0
        inv_j = jcommon.rope_inv_freq(64, theta, scaling)
        inv_t = tcommon.rope_inv_freq(64, theta, scaling)
        close(inv_j, inv_t, 1e-6)
        pos = np.array([[0, 1, 2, 3000, 70000, 5, 6]] * B, np.int32)
        cj, sj = jcommon.rope_cos_sin(pos, inv_j)
        ct, st = tcommon.rope_cos_sin(t(pos), inv_t)
        close(cj, ct, 1e-4)
        close(sj, st, 1e-4)
        x = rng.standard_normal((B, H, S, 64)).astype(np.float32)
        close(jcommon.apply_rope(x, cj, sj),
              tcommon.apply_rope(t(x), t(cj), t(sj)))
    elif op == "repeat_kv":
        x = rng.standard_normal((B, 2, S, D)).astype(np.float32)
        np.testing.assert_array_equal(np.asarray(jcommon.repeat_kv(x, 3)),
                                      tcommon.repeat_kv(t(x), 3).numpy())
    else:
        p = {n: rng.standard_normal(s).astype(np.float32) * 0.1
             for n, s in (("w_gate", (32, 48)), ("w_up", (32, 48)),
                          ("w_down", (48, 32)))}
        x = rng.standard_normal((B, S, 32)).astype(np.float32)
        close(jcommon.mlp(x, p),
              tcommon.mlp(t(x), {n: t(a) for n, a in p.items()}))


def test_wdot_rejects_int8_weights():
    """An int8 weight is refused without its per-output-channel scale
    (``<name>_scale``, from ops/quant.quantize_layer_weights), and a weight
    dtype the port has no branch for is refused outright."""
    with pytest.raises(KeyError, match="w_scale"):
        tcommon.wdot(torch.zeros(2, 4), {"w": torch.zeros(4, 4,
                                                          dtype=torch.int8)},
                     "w")
    with pytest.raises(NotImplementedError):
        tcommon.wdot(torch.zeros(2, 4),
                     {"w": torch.zeros(4, 4, dtype=torch.float16)}, "w")


# ---------------------------------------------------------------------------
# cache / decode attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gap", [0, 6])
def test_slot_mask_matches_jax(gap):
    length = np.array([3, 9], np.int32)
    pvalid = np.array([[3, 2, 1], [5, 5, 0]], np.int32)
    np.testing.assert_array_equal(
        np.asarray(j_slot_mask(length, pvalid, gap, 12)),
        t_slot_mask(t(length), t(pvalid), gap, 12).numpy())


@pytest.mark.parametrize("grouped", [False, True])
def test_decode_attention_matches_jax(grouped):
    rng = RNG(11)
    B, Hq, Hkv, S, D = 2, 4, 2, 24, 16
    Hc = Hkv if grouped else Hq
    q = rng.standard_normal((B, Hq, 1, D)).astype(np.float32)
    ck = rng.standard_normal((B, Hc, S, D)).astype(np.float32)
    cv = rng.standard_normal((B, Hc, S, D)).astype(np.float32)
    mask = np.arange(S)[None, None, :] < np.array([10, 24])[:, None, None]
    mask = np.broadcast_to(mask, (B, Hc, S))
    if grouped:
        oj, pj = jllama._grouped_decode_attention(q, ck, cv, mask, Hq // Hkv)
        ot, pt = tllama._grouped_decode_attention(t(q), t(ck), t(cv),
                                                  t(mask), Hq // Hkv)
    else:
        oj, pj = jattn.decode_attention(q, ck, cv, mask)
        ot, pt = tattn.decode_attention(t(q), t(ck), t(cv), t(mask))
    close(oj, ot)
    close(pj, pt)


# ---------------------------------------------------------------------------
# compress_prefill
# ---------------------------------------------------------------------------

def _prefill_inputs(B, H, S, D, seed):
    rng = RNG(seed)
    k = rng.standard_normal((B, H, S, D)).astype(np.float32)
    v = rng.standard_normal((B, H, S, D)).astype(np.float32)
    # Scores quantized to force ties, which must break by index.
    cs = np.round(rng.random((B, H, S)) * 20).astype(np.float32)
    return k, v, cs


@pytest.mark.parametrize("method,S,true_len", [
    ("h2o", 128, (100, 77)),      # both rows compress
    ("h2o", 128, (100, 50)),      # row 1 shorter than P: identity
    ("h2o", 64, (60, 40)),        # S_pad <= P: passthrough
    ("allkv", 128, (100, 77)),
    ("fullkv", 128, (128, 3)),
])
def test_compress_prefill_matches_jax(method, S, true_len):
    B, H, D, cap = 2, 4, 8, 128
    comp_kw = dict(method=method, max_capacity_prompt=64, window_size=8)
    k, v, cs = _prefill_inputs(B, H, S, D, seed=S + true_len[1])
    tl = np.array(true_len, np.int32)
    rj = jpol.compress_prefill(
        jconfig.CompressionConfig(**comp_kw), 0, 2, k, v, k,
        jattn.PrefillScores(colsum_all=cs, colsum_window=None), tl, cap)
    rt = tpol.compress_prefill(
        tconfig.CompressionConfig(**comp_kw), 0, 2, t(k), t(v), t(k),
        tattn.PrefillScores(colsum_all=t(cs), colsum_window=None), t(tl),
        cap)
    np.testing.assert_array_equal(np.asarray(rj.length), rt.length.numpy())
    np.testing.assert_array_equal(np.asarray(rj.pvalid), rt.pvalid.numpy())
    for b in range(B):
        n = int(rj.length[b])     # slots past length are junk on both sides
        np.testing.assert_array_equal(np.asarray(rj.cache_k)[b, :, :n],
                                      rt.cache_k[b, :, :n].numpy())
        np.testing.assert_array_equal(np.asarray(rj.cache_v)[b, :, :n],
                                      rt.cache_v[b, :, :n].numpy())


@pytest.mark.parametrize("method", ["quest"])
def test_unported_methods_raise(method):
    # Quest was the last method the port refused: its prefill keeps the
    # whole prompt, as fullkv's does, and every method now compresses.
    k = torch.randn((1, 1, 128, 8))
    comp = tconfig.CompressionConfig(method=method, max_capacity_prompt=64)
    res = tpol.compress_prefill(comp, 0, 1, k, k, k,
                                tattn.PrefillScores(None, None),
                                torch.tensor([100]), 256)
    assert torch.equal(res.cache_k[:, :, :128], k)
    assert res.length.tolist() == [100] and res.cache_k.shape[2] == 256
    assert set(tconfig.PREFILL_METHODS) >= {"quest", "h2o", "headwise"}


# ---------------------------------------------------------------------------
# schedulers
# ---------------------------------------------------------------------------

def _sched_comp(metric, method="h2o"):
    kw = dict(method=method, decoding_metric=metric, max_capacity_prompt=64,
              window_size=8, decoding_window_size=32,
              decoding_recent_size=16, delta=3, headwise_max_budget=64)
    return jconfig.CompressionConfig(**kw), tconfig.CompressionConfig(**kw)


@pytest.mark.parametrize("metric,method", [
    ("jump", "h2o"), ("linear", "h2o"), ("fixed", "h2o"), ("jump", "allkv"),
    ("none", "h2o"), ("h2o", "h2o"), ("slm", "streamingllm"),
    ("pyramidinfer", "pyramidkv"), ("jump", "headwise")])
def test_schedule_decision_matches_jax(metric, method):
    """A whole decode run of counter/gate decisions, layer by layer."""
    jc, tc = _sched_comp(metric, method)
    L, B, cap = 2, 2, 256
    caps_j = jsched.DecodeCaps(keep_cap=jsched.static_keep_cap(jc, 60),
                               capacity=cap)
    caps_t = tsched.DecodeCaps(*caps_j)
    sj, st = jsched.SchedState.init(), tsched.SchedState.init()
    length = np.array([64, 60], np.int32)
    prompt_len = np.array([100, 60], np.int32)
    fired = 0
    for step in range(60):
        length = length + 1
        for l in range(L):
            gj, nj, pj, posj, sj = jsched.schedule_decision(
                jc, caps_j, sj, length, prompt_len, l, L)
            gt, nt, pt, post, st = tsched.schedule_decision(
                tc, caps_t, st, t(length), t(prompt_len), l, L)
            for a, b in ((gj, gt), (nj, nt), (pj, pt), (sj.step, st.step),
                         (sj.jump_step, st.jump_step),
                         (sj.jump_layer, st.jump_layer)):
                np.testing.assert_array_equal(np.asarray(a), b.numpy())
            assert posj == post
            gate = np.asarray(gj)
            fired += int(gate.any())
            length = np.where(gate, np.asarray(pj) + np.asarray(nj)
                              + jc.decoding_recent_size, length)
    assert fired > 0 or metric == "none"


def _block_inputs(seed, B=2, H=4, cap=128, D=8):
    rng = RNG(seed)
    # Coarse probabilities: many ties, which must break by slot index.
    probs = np.round(rng.random((B, H, cap)) * 8).astype(np.float32) / 8
    ck = rng.standard_normal((B, H, cap, D)).astype(np.float32)
    cv = rng.standard_normal((B, H, cap, D)).astype(np.float32)
    return probs, ck, cv


@pytest.mark.parametrize("gate", [(True, True), (True, False)])
def test_block_map_matches_jax(gate):
    jc, tc = _sched_comp("jump")
    caps = (33, 128)
    probs, _, _ = _block_inputs(1)
    length = np.array([110, 101], np.int32)
    pseg = np.array([64, 64], np.int32)
    n_keep = np.array([20, 17], np.int32)
    row_gate = np.array(gate)
    sj, lj = jsched.block_map(jc, jsched.DecodeCaps(*caps), probs, length,
                              pseg, n_keep, row_gate, False)
    st, lt = tsched.block_map(tc, tsched.DecodeCaps(*caps), t(probs),
                              t(length), t(pseg), t(n_keep), t(row_gate))
    np.testing.assert_array_equal(np.asarray(sj), st.numpy())
    np.testing.assert_array_equal(np.asarray(lj), lt.numpy())


@pytest.mark.parametrize("fire", [True, False])
def test_block_rewrite_matches_jax(fire):
    jc, tc = _sched_comp("jump")
    caps = (33, 128)
    probs, ck, cv = _block_inputs(2)
    length = np.array([110, 101], np.int32)
    pseg = np.array([64, 64], np.int32)
    n_keep = np.array([20, 17], np.int32)
    row_gate = np.array([fire, False])
    kj, vj, lj = jsched.block_rewrite_cond(
        jc, jsched.DecodeCaps(*caps), probs, ck, cv, length, pseg, n_keep,
        row_gate, False, 4)
    kt, vt, lt = tsched.block_rewrite(
        tc, tsched.DecodeCaps(*caps), t(probs), t(ck), t(cv), t(length),
        t(pseg), t(n_keep), t(row_gate))
    np.testing.assert_array_equal(np.asarray(lj), lt.numpy())
    if fire:
        np.testing.assert_array_equal(np.asarray(kj), kt.numpy())
        np.testing.assert_array_equal(np.asarray(vj), vt.numpy())
    else:
        # Hold: the JAX branch returns the region unchanged; the port
        # returns nothing to write.
        assert kt is None and vt is None
        np.testing.assert_array_equal(np.asarray(kj),
                                      ck[:, :, 64:64 + kj.shape[2]])


# ---------------------------------------------------------------------------
# model: prefill + one decode step
# ---------------------------------------------------------------------------

def _tiny(per_qhead, max_new=48):
    spec = jregistry.get_spec("tiny-llama")
    kw = dict(method="h2o", decoding_metric="jump", max_capacity_prompt=64,
              window_size=8, decoding_window_size=32,
              decoding_recent_size=16, delta=3, evict_per_qhead=per_qhead)
    ekw = dict(max_prompt_len=128, max_new_tokens=max_new, dtype="float32")
    params = jllama.init_params(spec, jax.random.key(7), jnp.float32)
    pnp = jax.tree_util.tree_map(np.asarray, params)
    return (spec, jconfig.CompressionConfig(**kw),
            jconfig.EngineConfig(**ekw), params,
            tregistry.get_spec("tiny-llama"),
            tconfig.CompressionConfig(**kw), tconfig.EngineConfig(**ekw),
            params_from_jax(pnp, device="cpu", dtype=torch.float32))


@pytest.mark.parametrize("per_qhead", [True, False])
def test_prefill_and_decode_step_match_jax(per_qhead):
    spec, jc, je, jp, tspec, tc, te, tp = _tiny(per_qhead)
    toks = RNG(0).integers(1, spec.vocab_size, (2, 128)).astype(np.int32)
    tl = np.array([100, 77], np.int32)
    lj, cj, sj = jllama.prefill(spec, jc, je, jp, jnp.asarray(toks),
                                jnp.asarray(tl))
    lt, ct, st = tllama.prefill(tspec, tc, te, tp, t(toks), t(tl))
    close(lj, lt, 1e-4)
    np.testing.assert_array_equal(np.asarray(cj.length), ct.length.numpy())
    for b, n in enumerate(np.asarray(cj.length)[0]):
        close(np.asarray(cj.k)[:, b, :, :n], ct.k[:, b, :, :n], 1e-4)
        close(np.asarray(cj.v)[:, b, :, :n], ct.v[:, b, :, :n], 1e-4)

    tok = np.array([5, 9], np.int32)
    step = jax.jit(partial(jllama.decode_step, spec, jc, je))
    lj, cj, sj = step(jp, jnp.asarray(tok), jnp.asarray(tl), cj, sj)
    lt, ct, st = tllama.decode_step(tspec, tc, te, tp, t(tok), t(tl), ct, st)
    close(lj, lt, 1e-4)
    np.testing.assert_array_equal(np.asarray(cj.length), ct.length.numpy())
    np.testing.assert_array_equal(np.asarray(sj.step), st.step.numpy())
    for b, n in enumerate(np.asarray(cj.length)[0]):
        close(np.asarray(cj.k)[:, b, :, :n], ct.k[:, b, :, :n], 1e-4)


def test_h2o_short_prompt_large_capacity_stays_finite():
    """A prompt shorter than P in a bucket wider than P keeps every slot
    (identity map).  When the cache capacity exceeds the bucket, the slots
    past it must read zero: the JAX package's gather fills them with NaN
    (ROADMAP §3), which the decode PV product turns into NaN logits."""
    spec, jc, je, jp, tspec, tc, te, tp = _tiny(True, max_new=600)
    assert te.cache_capacity(tc) > 128
    toks = RNG(0).integers(1, spec.vocab_size, (1, 128)).astype(np.int32)
    tl = torch.tensor([50], dtype=torch.int32)
    logits, cache, state = tllama.prefill(tspec, tc, te, tp, t(toks), tl)
    assert int(cache.length[0, 0]) == 50
    assert (cache.k[:, :, :, 128:] == 0).all()
    logits, cache, state = tllama.decode_step(
        tspec, tc, te, tp, torch.tensor([5]), tl, cache, state)
    assert torch.isfinite(logits).all()


def test_unported_model_features_raise():
    spec, jc, je, jp, tspec, tc, te, tp = _tiny(True)
    for s, c in ((tregistry.get_spec("tiny-mistral"), tc),
                 (tregistry.get_spec("tiny-qwen2"), tc),
                 (tspec, tc.replace(mistral_window_parity=True))):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tllama.prefill(s, c, te, tp, torch.zeros((1, 128)),
                           torch.tensor([100]))


# ---------------------------------------------------------------------------
# package boundary
# ---------------------------------------------------------------------------

def test_entry_points_run_on_the_card_unless_asked():
    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tllama.init_params(tregistry.get_spec("tiny-llama"))


PORT_MODULES = [
    "scope_tpu_torch", "scope_tpu_torch.config", "scope_tpu_torch.device",
    "scope_tpu_torch.cache", "scope_tpu_torch.models.registry",
    "scope_tpu_torch.models.llama", "scope_tpu_torch.models.convert",
    "scope_tpu_torch.ops.common", "scope_tpu_torch.ops.build",
    "scope_tpu_torch.ops.flash_prefill", "scope_tpu_torch.ops.attention",
    "scope_tpu_torch.compression.policies",
    "scope_tpu_torch.compression.headwise",
    "scope_tpu_torch.compression.schedulers",
    "scope_tpu_torch.compression.host_sched",
    "scope_tpu_torch.engine.host_loop", "scope_tpu_torch.engine.generate",
    "scope_tpu_torch.ops.quant", "scope_tpu_torch.native",
    "scope_tpu_torch.engine.serving",
]


def test_port_imports_no_jax():
    """Importing every module of the port loads no JAX, Flax or
    scope_tpu module (the port keeps its own copies)."""
    code = (
        "import importlib, sys\n"
        f"for m in {PORT_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'scope_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
