"""The port's ops/quant.py and int8 ``wdot`` against the JAX package's.

Every function of ``scope_tpu.ops.quant`` and its counterpart in
``scope_tpu_torch.ops.quant`` take the same numpy inputs, made from a seed:
integer codes and packed bytes must be identical, scales and offsets within
1e-6 relative, dequantized values and products within 1e-5.  The folded
attention algebra (the counterparts of tests/test_int8_kv.py::
test_int8_scale_folding_algebra and tests/test_int4_kv.py::
test_int4_zero_point_folding_algebra) is held within 1e-5 against the
port's attention over the dequantized values.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from scope_tpu.models import llama as jllama
from scope_tpu.models.registry import TINY_LLAMA
from scope_tpu.ops import common as jcommon
from scope_tpu.ops import quant as jq

from scope_tpu_torch.cache import slot_mask
from scope_tpu_torch.models import llama as tllama
from scope_tpu_torch.models.convert import params_from_jax
from scope_tpu_torch.models.registry import get_spec
from scope_tpu_torch.ops import common as tcommon
from scope_tpu_torch.ops import quant as tq
from scope_tpu_torch.ops.attention import decode_attention

RNG = np.random.default_rng


def t(x):
    return torch.from_numpy(np.array(x))


def same(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def close(a, b, tol):
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=tol,
                               atol=tol)


def kv(seed, shape=(2, 4, 32, 16), scale=3.0, shift=0.0):
    return (RNG(seed).standard_normal(shape) * scale + shift).astype(
        np.float32)


def test_constants_match_jax():
    assert (tq.MARGIN, tq.MARGIN4) == (jq.MARGIN, jq.MARGIN4)
    assert tq.WEIGHT_NAMES == jq.WEIGHT_NAMES


@pytest.mark.parametrize("axis", [-2, -3])
def test_int8_calibrate_quantize_dequantize_match_jax(axis):
    x = kv(0)
    s_j, s_t = jq.calibrate(x, axis=axis), tq.calibrate(t(x), axis=axis)
    close(s_j, s_t, 1e-6)
    q_j = jq.quantize(x, s_j, axis=axis)
    q_t = tq.quantize(t(x), t(s_j), axis=axis)
    assert q_t.dtype == torch.int8
    same(q_j, q_t)
    close(jq.dequantize(q_j, s_j, axis=axis, dtype=jnp.float32),
          tq.dequantize(q_t, t(s_j), axis=axis, dtype=torch.float32), 1e-6)


def test_int8_saturates_and_rounds_half_to_even():
    """Values far past the calibrated range clip to +/-127; exact halves
    round to the even code, as jnp.round does."""
    x = np.array([[[1.0], [2.0]]], np.float32)
    s = np.full((1, 1), 0.5, np.float32)
    y = np.array([[[100.0], [-100.0], [0.25], [0.75], [1.25], [-0.25]]],
                 np.float32)
    same(jq.quantize(y, s), tq.quantize(t(y), t(s)))
    assert tq.quantize(t(y), t(s))[0, :, 0].tolist() == [127, -127, 0, 2, 2,
                                                         0]
    close(jq.calibrate(x), tq.calibrate(t(x)), 1e-6)


def test_pack_unpack_match_jax():
    codes = RNG(1).integers(0, 16, (3, 5, 8, 16)).astype(np.uint8)
    p_j, p_t = jq.pack4(codes), tq.pack4(t(codes))
    assert p_t.dtype == torch.uint8 and p_t.shape[-1] == 8
    same(p_j, p_t)
    # Planar: byte j holds channel j low and channel j + D/2 high.
    assert int(p_t[0, 0, 0, 3]) == int(codes[0, 0, 0, 3]) | (
        int(codes[0, 0, 0, 11]) << 4)
    same(jq.unpack4(p_j, jnp.uint8), tq.unpack4(p_t, torch.uint8))
    same(tq.unpack4(p_t, torch.uint8), codes)


@pytest.mark.parametrize("masked", [False, True])
def test_int4_calibrate_quantize_dequantize_match_jax(masked):
    x = kv(2, shift=1.0)
    valid = None
    if masked:
        valid = np.arange(32)[None, None, :] < np.array([20, 32])[:, None,
                                                                   None]
        valid = np.broadcast_to(valid, (2, 4, 32))
        x[0, :, 20:] = 1e6                     # junk slots, masked out
    s_j, o_j = jq.calibrate4(x, valid=valid)
    s_t, o_t = tq.calibrate4(t(x), valid=None if valid is None else t(valid))
    close(s_j, s_t, 1e-6)
    close(o_j, o_t, 1e-6)
    p_j = jq.quantize4(x, s_j, o_j)
    p_t = tq.quantize4(t(x), t(s_j), t(o_j))
    same(p_j, p_t)
    close(jq.dequantize4(p_j, s_j, o_j, dtype=jnp.float32),
          tq.dequantize4(p_t, t(s_j), t(o_j), dtype=torch.float32), 1e-6)


def test_int4_masked_calibration_with_no_valid_slot():
    """A row with no valid slot calibrates to a range around 0 (the JAX
    package's ``ok`` guard), not to +/- float32 max."""
    x = kv(3, shape=(1, 2, 4, 8))
    valid = np.zeros((1, 2, 4), bool)
    s_j, o_j = jq.calibrate4(x, valid=valid)
    s_t, o_t = tq.calibrate4(t(x), valid=t(valid))
    close(s_j, s_t, 1e-6)
    close(o_j, o_t, 1e-6)
    assert torch.isfinite(s_t).all() and float(s_t.max()) < 1e-5


@pytest.mark.parametrize("groups", [1, 2])
def test_fold_q_and_out_scale_match_jax(groups):
    rng = RNG(4)
    B, Hc, D = 2, 2, 16
    q = rng.standard_normal((B, Hc * groups, 1, D)).astype(np.float32)
    out = rng.standard_normal((B, Hc * groups, 1, D)).astype(np.float32)
    ks = rng.uniform(0.01, 0.1, (B, Hc, D)).astype(np.float32)
    vo = rng.standard_normal((B, Hc, D)).astype(np.float32)
    close(jq.fold_q_scale(q, ks), tq.fold_q_scale(t(q), t(ks)), 1e-6)
    close(jq.fold_out_scale(out, ks), tq.fold_out_scale(t(out), t(ks)), 1e-6)
    close(jq.fold_out_scale(out, ks, vo),
          tq.fold_out_scale(t(out), t(ks), t(vo)), 1e-6)
    # The scale is cast to q's dtype before the product.
    qb = torch.from_numpy(q).to(torch.bfloat16)
    got = tq.fold_q_scale(qb, t(ks))
    assert got.dtype == torch.bfloat16
    want = (qb.reshape(B, Hc, groups, D) * t(ks)[:, :, None].to(
        torch.bfloat16)).reshape(qb.shape)
    assert torch.equal(got, want)


@pytest.mark.parametrize("store", ["float32", "int8", "int4"])
def test_to_compute_and_einsums_match_jax(store):
    """to_compute, qk_einsum (float32 accumulation) and pv_einsum on the
    cache in its storage dtype, in both layouts the decode path uses."""
    rng = RNG(5)
    B, H, G, S, D = 2, 2, 3, 24, 16
    x = kv(6, shape=(B, H, S, D))
    if store == "int8":
        cache = np.asarray(jq.quantize(x, jq.calibrate(x)))
    elif store == "int4":
        s, o = jq.calibrate4(x)
        cache = np.asarray(jq.quantize4(x, s, o))
    else:
        cache = x
    q = rng.standard_normal((B, H, G, D)).astype(np.float32)
    probs = rng.uniform(0, 1, (B, H, G, S)).astype(np.float32)
    same(jq.to_compute(cache, jnp.float32),
         tq.to_compute(t(cache), torch.float32))
    spec_qk, spec_pv = "bhgd,bhsd->bhgs", "bhgs,bhsd->bhgd"
    close(jq.qk_einsum(spec_qk, q, cache, jnp.float32, jnp.float32),
          tq.qk_einsum(spec_qk, t(q), t(cache), torch.float32, torch.float32),
          1e-5)
    close(jq.pv_einsum(spec_pv, probs, cache, jnp.float32),
          tq.pv_einsum(spec_pv, t(probs), t(cache), torch.float32), 1e-5)


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8", "int4"])
def test_quantize_prefill_layer_matches_jax(kv_dtype):
    """int4 calibration masks to the valid slots [0, length); int8 takes
    every slot, junk included, as the JAX package does."""
    ck, cv = kv(7, shape=(2, 4, 32, 16)), kv(8, shape=(2, 4, 32, 16))
    ck[1, :, 20:] = 50.0                                  # junk past length
    length = np.array([32, 20], np.int32)
    pvalid = np.broadcast_to(length[:, None], (2, 4)).copy()
    got_j = jq.quantize_prefill_layer(kv_dtype, ck, cv, length, pvalid, 0)
    got_t = tq.quantize_prefill_layer(kv_dtype, t(ck), t(cv), t(length),
                                      t(pvalid), 0)
    same(got_j[0], got_t[0])
    same(got_j[1], got_t[1])
    for a, b in zip(got_j[2:], got_t[2:]):
        if kv_dtype == "bfloat16" or (kv_dtype == "int8" and b is None):
            assert b is None
        else:
            close(a, b, 1e-6)


def test_int8_scale_folding_algebra():
    """Attention on int8 codes with the K scale folded into q and the V
    scale into the output equals attention on the dequantized values."""
    rng = RNG(3)
    B, H, S, D = 2, 4, 64, 16
    k = torch.from_numpy((rng.standard_normal((B, H, S, D)) * 2.0)
                         .astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((B, H, S, D)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((B, H, 1, D)).astype(np.float32))
    ks, vs = tq.calibrate(k), tq.calibrate(v)
    ki, vi = tq.quantize(k, ks), tq.quantize(v, vs)
    length = torch.tensor([40, 64], dtype=torch.int32)
    mask = slot_mask(length, length[:, None].expand(B, H), 0, S)
    out_ref, probs_ref = decode_attention(
        q, tq.dequantize(ki, ks, dtype=torch.float32),
        tq.dequantize(vi, vs, dtype=torch.float32), mask)
    out_q, probs_q = decode_attention(tq.fold_q_scale(q, ks), ki, vi, mask)
    out_q = tq.fold_out_scale(out_q, vs)
    close(out_ref, out_q, 1e-5)
    close(probs_ref, probs_q, 1e-5)


def test_int4_zero_point_folding_algebra():
    """Attention on int4 codes with folded scales and offsets equals
    attention on the dequantized values: K's offset is a per-row constant
    of the logits, V's adds once because the probabilities sum to 1."""
    rng = RNG(3)
    B, H, S, D = 2, 4, 64, 16
    k = torch.from_numpy((rng.standard_normal((B, H, S, D)) * 2.0 + 0.7)
                         .astype(np.float32))
    v = torch.from_numpy((rng.standard_normal((B, H, S, D)) - 0.3)
                         .astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((B, H, 1, D)).astype(np.float32))
    length = torch.tensor([40, 64], dtype=torch.int32)
    mask = slot_mask(length, length[:, None].expand(B, H), 0, S)
    ks, ko = tq.calibrate4(k, valid=mask)
    vs, vo = tq.calibrate4(v, valid=mask)
    ki, vi = tq.quantize4(k, ks, ko), tq.quantize4(v, vs, vo)
    out_ref, probs_ref = decode_attention(
        q, tq.dequantize4(ki, ks, ko, dtype=torch.float32),
        tq.dequantize4(vi, vs, vo, dtype=torch.float32), mask)
    out_q, probs_q = decode_attention(tq.fold_q_scale(q, ks), ki, vi, mask)
    out_q = tq.fold_out_scale(out_q, vs, vo)
    close(probs_ref, probs_q, 1e-5)
    close(out_ref, out_q, 1e-5)


def _weights(seed, L=3, E=16, F=24):
    w = RNG(seed).normal(size=(L, E, F)).astype(np.float32)
    return {"layers": {n: w * (i + 1) for i, n in enumerate(jq.WEIGHT_NAMES)}}


def test_quantize_layer_weights_matches_jax():
    params = _weights(0)
    qj = jq.quantize_layer_weights(params)
    qt = tq.quantize_layer_weights(
        {"layers": {n: t(a) for n, a in params["layers"].items()}})
    for n in jq.WEIGHT_NAMES:
        assert qt["layers"][n].dtype == torch.int8
        same(qj["layers"][n], qt["layers"][n])
        close(qj["layers"][n + "_scale"], qt["layers"][n + "_scale"], 1e-6)


def test_wdot_int8_matches_jax():
    qj = jq.quantize_layer_weights(_weights(1))
    pnp = jax.tree_util.tree_map(np.asarray, qj)
    x = RNG(2).normal(size=(5, 16)).astype(np.float32)
    for l in range(3):
        pj = {n: a[l] for n, a in pnp["layers"].items()}
        pt = {n: t(a) for n, a in pj.items()}
        for n in jq.WEIGHT_NAMES:
            close(jcommon.wdot(jnp.asarray(x), pj, n),
                  tcommon.wdot(t(x), pt, n), 1e-5)
    # bf16 activations: the int8 weight converts to bf16.
    xb = t(x).to(torch.bfloat16)
    assert tcommon.wdot(xb, pt, "wo").dtype == torch.bfloat16


@pytest.mark.parametrize("int8", [False, True])
def test_materialize_lm_head_and_logits_match_jax(int8):
    """The materialized tied head (bf16/f32 or int8 with per-input-channel
    scales) through params_from_jax and _lm_logits, against the JAX
    package's."""
    spec = dataclasses.replace(TINY_LLAMA, tie_word_embeddings=True)
    tspec = dataclasses.replace(get_spec("tiny-llama"),
                                tie_word_embeddings=True)
    params = jllama.init_params(spec, jax.random.key(3), jnp.float32)
    pj = jq.materialize_lm_head(params, int8=int8)
    h = RNG(6).normal(size=(3, 64)).astype(np.float32)
    pt = params_from_jax(jax.tree_util.tree_map(np.asarray, pj),
                         device="cpu", dtype=torch.float32)
    if int8:
        assert pt["lm_head_t"].dtype == torch.int8
        assert pt["lm_head_t_scale"].dtype == torch.float32
    close(jllama._lm_logits(spec, pj, jnp.asarray(h)),
          tllama._lm_logits(tspec, pt, t(h)), 1e-5)
    # The port's own materialization equals the JAX package's.
    mt = tq.materialize_lm_head({"embed": t(np.asarray(params["embed"]))},
                                int8=int8)
    if int8:
        same(pj["lm_head_t"], mt["lm_head_t"])
        close(pj["lm_head_t_scale"], mt["lm_head_t_scale"], 1e-6)
    else:
        close(pj["lm_head_t"], mt["lm_head_t"], 0)
    untied = {"embed": t(np.zeros((4, 2), np.float32)),
              "lm_head": t(np.zeros((2, 4), np.float32))}
    assert tq.materialize_lm_head(untied) is untied


def test_params_from_jax_keeps_int8_and_scales():
    params = jllama.init_params(TINY_LLAMA, jax.random.key(0), jnp.float32)
    qj = jq.quantize_layer_weights(params)
    pt = params_from_jax(jax.tree_util.tree_map(np.asarray, qj),
                         device="cpu", dtype=torch.bfloat16)
    for n in jq.WEIGHT_NAMES:
        assert pt["layers"][n].dtype == torch.int8
        same(qj["layers"][n], pt["layers"][n])
        assert pt["layers"][n + "_scale"].dtype == torch.float32
        same(qj["layers"][n + "_scale"], pt["layers"][n + "_scale"])
    assert pt["layers"]["ln_attn"].dtype == torch.bfloat16
    assert pt["embed"].dtype == torch.bfloat16
