"""KV-cache and weight quantization: int8 and packed-int4 KV, int8 weights.

A copy of the JAX package's ``ops/quant.py`` in PyTorch, with the same
layouts and arithmetic (``torch.round`` rounds half to even, as
``jnp.round`` does; values are clipped before the integer cast).

Int8 KV: true_k = k_int8 * scale[..., None, :], one scale per (layer, batch
row, cache head, channel), calibrated once per request on the compressed
prefill cache with MARGIN headroom for later decode tokens (which saturate
at +/-127).  The scale folds into the query before the logit product and
into the attention output after the value product, so attention reads the
quantized cache with no per-slot dequantization, and the eviction gathers
move int8 values unchanged (scales have no slot axis).

Packed int4 KV: true_v = code * scale + off, codes in [0, 15], two per byte
(uint8 [..., D/2]) in a PLANAR layout: byte j holds channel j in the low
nibble and channel j + D/2 in the high nibble.  K's zero point adds a
constant to every logit of a row, which the softmax cancels; V's adds once
to the output because the probabilities sum to 1.  The products read each
nibble plane on its own (:func:`qk_einsum`, :func:`pv_einsum`); no
unpacked copy of the cache is made.

Weight-only int8: per output channel, dot(x, W)[f] = dot(x, W_i8)[f] * s[f]
(``ops/common.wdot``).  On the card the int8 weight is converted to the
activation dtype on every call, a full-size copy (PERF.md has its cost).
"""

from __future__ import annotations

from typing import Optional

import torch

from scope_tpu_torch.cache import slot_mask

# Headroom for decode-phase tokens exceeding the prefill calibration
# range before saturation.
MARGIN = 1.25
MARGIN4 = 1.25


def calibrate(x: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """Per-channel scale over the slot axis.  x: [..., S, D] -> [..., D]
    float32."""
    amax = x.float().abs().amax(dim=axis)
    return torch.clamp_min(amax * MARGIN, 1e-6) / 127.0


def quantize(x: torch.Tensor, scale: torch.Tensor, axis: int = -2
             ) -> torch.Tensor:
    """x: [..., S, D], scale: [..., D] -> int8 [..., S, D]."""
    s = scale.unsqueeze(axis)
    q = torch.round(x.float() / s)
    return q.clamp(-127, 127).to(torch.int8)


def dequantize(x_int: torch.Tensor, scale: torch.Tensor, axis: int = -2,
               dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    return (x_int.float() * scale.unsqueeze(axis)).to(dtype)


def pack4(codes: torch.Tensor) -> torch.Tensor:
    """codes [..., D] integer-valued in [0, 15] -> [..., D/2] uint8, planar:
    byte j holds channel j (low nibble) and channel j + D/2 (high)."""
    c = codes.to(torch.uint8)
    d2 = c.shape[-1] // 2
    return c[..., :d2] | (c[..., d2:] << 4)


def unpack4(packed: torch.Tensor, dtype: torch.dtype = torch.bfloat16
            ) -> torch.Tensor:
    """[..., D/2] uint8 -> [..., D] codes in [0, 15] as ``dtype``."""
    return torch.cat([(packed & 0xF).to(dtype), (packed >> 4).to(dtype)],
                     dim=-1)


def calibrate4(x: torch.Tensor, valid: Optional[torch.Tensor] = None,
               axis: int = -2):
    """Asymmetric per-channel range over the slot axis with MARGIN4
    headroom.  x: [..., S, D]; valid: bool [..., S] (junk slots left out: a
    min/max range is junk-sensitive, unlike the int8 amax).  Returns
    (scale, off), each [..., D] float32."""
    xf = x.float()
    if valid is not None:
        vm = valid.unsqueeze(-1)
        big = torch.finfo(torch.float32).max
        mn = torch.where(vm, xf, big).amin(dim=axis)
        mx = torch.where(vm, xf, -big).amax(dim=axis)
        ok = mx >= mn                       # any valid slot at all
        mn = torch.where(ok, mn, 0.0)
        mx = torch.where(ok, mx, 0.0)
    else:
        mn = xf.amin(dim=axis)
        mx = xf.amax(dim=axis)
    c = (mn + mx) * 0.5
    h = torch.clamp_min((mx - mn) * 0.5 * MARGIN4, 1e-6)
    return (2.0 * h) / 15.0, c - h


def quantize4(x: torch.Tensor, scale: torch.Tensor, off: torch.Tensor,
              axis: int = -2) -> torch.Tensor:
    """x [..., S, D] -> packed uint8 [..., S, D/2]; out-of-range decode
    values saturate at code 0 / 15."""
    s = scale.unsqueeze(axis)
    o = off.unsqueeze(axis)
    codes = torch.round((x.float() - o) / s).clamp(0, 15)
    return pack4(codes)


def dequantize4(packed: torch.Tensor, scale: torch.Tensor, off: torch.Tensor,
                axis: int = -2, dtype: torch.dtype = torch.bfloat16
                ) -> torch.Tensor:
    codes = unpack4(packed, torch.float32)
    return (codes * scale.unsqueeze(axis) + off.unsqueeze(axis)).to(dtype)


def fold_q_scale(q: torch.Tensor, k_scale: torch.Tensor) -> torch.Tensor:
    """Fold the per-channel K scale into q, so attention reads quantized K
    with no per-slot dequantization: q.k = sum_d (q_d * s_d) * kint_d.
    q: [B, Hq, 1, D]; k_scale: [B, Hc, D] (Hc divides Hq).  The scale is
    cast to q's dtype before the product, as in the JAX package."""
    B, Hq, _, D = q.shape
    Hc = k_scale.shape[1]
    return (q.reshape(B, Hc, Hq // Hc, D)
            * k_scale[:, :, None, :].to(q.dtype)).reshape(B, Hq, 1, D)


def fold_out_scale(out: torch.Tensor, v_scale: torch.Tensor,
                   v_off: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fold the per-channel V scale (and int4's V zero point, exact because
    the probabilities sum to 1) into the attention output.
    out: [B, Hq, 1, D]; v_scale / v_off: [B, Hc, D]."""
    B, Hq, _, D = out.shape
    Hc = v_scale.shape[1]
    og = out.reshape(B, Hc, Hq // Hc, D) * v_scale[:, :, None, :].to(out.dtype)
    if v_off is not None:
        og = og + v_off[:, :, None, :].to(out.dtype)
    return og.reshape(B, Hq, 1, D)


def to_compute(x: torch.Tensor, cd: torch.dtype) -> torch.Tensor:
    """Cache values -> attention compute dtype: bf16/f32 convert, int8
    converts, packed-int4 unpacks to codes (the caller folds scales and
    offsets).  For the decode products use :func:`qk_einsum` /
    :func:`pv_einsum`, which never unpack a whole cache."""
    if x.dtype == torch.uint8:
        return unpack4(x, cd)
    return x.to(cd)


def qk_einsum(spec: str, q: torch.Tensor, k_cache: torch.Tensor,
              cd: torch.dtype, acc: Optional[torch.dtype] = None
              ) -> torch.Tensor:
    """``einsum(spec, q, K)`` with K in its storage dtype.

    ``acc`` (float32 for the logits) is the dtype the product accumulates
    in; the operands are converted to it (bf16 and int8 values, and int4
    codes, are exact in float32, so this equals a ``cd`` product with
    float32 accumulation).  Packed int4 contracts each nibble plane with
    its half of q and adds the two partial products."""
    dt = acc or cd
    if k_cache.dtype == torch.uint8:
        D2 = k_cache.shape[-1]
        lo = (k_cache & 0xF).to(dt)
        hi = (k_cache >> 4).to(dt)
        return (torch.einsum(spec, q[..., :D2].to(dt), lo)
                + torch.einsum(spec, q[..., D2:].to(dt), hi))
    return torch.einsum(spec, q.to(dt), to_compute(k_cache, dt))


def pv_einsum(spec: str, probs: torch.Tensor, v_cache: torch.Tensor,
              cd: torch.dtype) -> torch.Tensor:
    """``einsum(spec, probs, V)`` in ``cd`` with V in its storage dtype.
    Packed int4 runs one product per nibble plane and concatenates the two
    channel halves of the small output."""
    if v_cache.dtype == torch.uint8:
        lo = (v_cache & 0xF).to(cd)
        hi = (v_cache >> 4).to(cd)
        return torch.cat([torch.einsum(spec, probs, lo),
                          torch.einsum(spec, probs, hi)], dim=-1)
    return torch.einsum(spec, probs, to_compute(v_cache, cd))


def quantize_prefill_layer(kv_dtype: str, ck: torch.Tensor, cv: torch.Tensor,
                           length: torch.Tensor, pvalid: torch.Tensor,
                           gap: int):
    """Quantize one layer's compressed prefill cache.  ck / cv:
    [B, H, S, D].  Returns (ck', cv', k_scale, v_scale, k_off, v_off), None
    where the dtype has no such leaf.  int4 calibration masks to the valid
    slots: the compression gathers leave junk in dead slots."""
    if kv_dtype == "int8":
        ks, vs = calibrate(ck), calibrate(cv)
        return quantize(ck, ks), quantize(cv, vs), ks, vs, None, None
    if kv_dtype == "int4":
        mask = slot_mask(length, pvalid, gap, ck.shape[2])       # [B, H, S]
        ks, ko = calibrate4(ck, valid=mask)
        vs, vo = calibrate4(cv, valid=mask)
        return (quantize4(ck, ks, ko), quantize4(cv, vs, vo), ks, vs, ko, vo)
    return ck, cv, None, None, None, None


# ---------------------------------------------------------------------------
# Weight-only int8 (per output channel)
# ---------------------------------------------------------------------------

WEIGHT_NAMES = ("wqkv", "wo", "w_gate", "w_up", "w_down")


def quantize_layer_weights(params, names=WEIGHT_NAMES):
    """Weight-only per-output-channel int8 for the stacked layer weights:
    w [L, E, F] -> int8 [L, E, F] plus float32 scale [L, F] under
    ``name + "_scale"``.  The embedding and the head stay as they are."""
    layers = dict(params["layers"])
    for n in names:
        w = layers[n].float()                                  # [L, E, F]
        s = torch.clamp_min(w.abs().amax(dim=1), 1e-8) / 127.0
        q = torch.round(w / s[:, None, :]).clamp(-127, 127)
        layers[n] = q.to(torch.int8)
        layers[n + "_scale"] = s                               # [L, F]
    return {**params, "layers": layers}


def materialize_lm_head(params, int8: bool = True):
    """Store the tied head in matmul orientation, once: ``lm_head_t``
    [E, V].  With int8 the scale is per INPUT channel (s[e]), folded into h
    before the product (``llama._lm_logits``); per-vocabulary scales would
    reorder logits.  No-op for untied heads."""
    if "lm_head" in params or "lm_head_t" in params:
        return params
    w = params["embed"].float().transpose(0, 1)                # [E, V]
    if not int8:
        return {**params,
                "lm_head_t": w.to(params["embed"].dtype).contiguous()}
    s = torch.clamp_min(w.abs().amax(dim=1), 1e-8) / 127.0      # [E]
    q = torch.round(w / s[:, None]).clamp(-127, 127).to(torch.int8)
    return {**params, "lm_head_t": q.contiguous(), "lm_head_t_scale": s}
