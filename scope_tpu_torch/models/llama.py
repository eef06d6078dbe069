"""Llama-family decoder in PyTorch with SCOPE compression integrated.

The port of the JAX package's ``models/llama.py``: ``prefill`` (every
layer: fused qkv + RoPE, GQA expansion, prefill attention with eviction
score capture through the Hopper kernels, output projection + MLP, then
prefill compression; Quest's page metadata after the last layer),
``decode_step`` (per layer: append the token, attend, then compress as
``compress_mode`` says; Quest attends its selected pages,
``compression/quest.py``) and ``decode_steps`` (n hot steps with the
token kept on the device).

Semantics kept from the reference forward:
- RoPE is applied before caching; evicted caches keep original phases.
- With ``evict_per_qhead`` the cache is GQA-expanded before the update, so
  eviction is per query head; otherwise per kv head with group-summed
  scores.
- Prefill attention runs over the full uncompressed keys; only the stored
  cache is compressed.
- Decode attention runs over the appended, not-yet-compressed cache; the
  compressed result is what the next step sees.
- Softmax runs in float32.

Layouts match the JAX package at the public functions: parameters are a
dict with layer weights stacked on a leading [L] axis and the fused
``wqkv`` columns grouped by kv head (each kv head's G query heads, then
its k, then its v); the cache is [L, B, H, S_max, D].  Layers and decode
steps are Python loops where JAX had ``lax.scan``; decode updates the
cache in place.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from scope_tpu_torch.cache import KVCache, init_cache, slot_mask
from scope_tpu_torch.compression import quest
from scope_tpu_torch.compression.policies import compress_prefill
from scope_tpu_torch.compression.schedulers import (DecodeCaps, SchedState,
                                                    block_rewrite, force_pseg,
                                                    gather_block,
                                                    schedule_decision,
                                                    static_keep_cap,
                                                    write_block)
from scope_tpu_torch.config import CompressionConfig, EngineConfig, ModelSpec
from scope_tpu_torch.device import resolve_device
from scope_tpu_torch.ops.attention import (NEG_INF, decode_attention,
                                           prefill_attention)
from scope_tpu_torch.ops import quant
from scope_tpu_torch.ops.common import (apply_rope, mlp, repeat_kv, rms_norm,
                                        rope_cos_sin, rope_inv_freq, wdot)

Params = Dict[str, Any]


def _dtype(name: str) -> torch.dtype:
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    if name not in dtypes:
        raise NotImplementedError(f"dtype {name!r} is not ported yet")
    return dtypes[name]


def _check_supported(spec: ModelSpec, comp: CompressionConfig) -> None:
    """Refuse what the port does not run yet, naming the ROADMAP item that
    brings it."""
    if (spec.sliding_window is not None or spec.attention_bias
            or comp.mistral_window_parity):
        raise NotImplementedError(
            f"{spec.arch} features (sliding window, mistral_window_parity, "
            f"qkv bias) are not ported yet (ROADMAP §1 item 13, Mistral and "
            f"Qwen2)")


# --------------------------------------------------------------------------
# parameters
# --------------------------------------------------------------------------

def init_params(spec: ModelSpec, generator: Optional[torch.Generator] = None,
                dtype: torch.dtype = torch.bfloat16, device="cuda"
                ) -> Params:
    """Random init with HF-like scales (for tests and benchmarks).

    ``generator`` must live on ``device``; None seeds a fresh one with 0.
    Same layout as the JAX package's ``init_params``, not the same numbers
    (tests carry one numpy weight set into both with ``params_from_jax``).
    """
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    L, E = spec.num_layers, spec.hidden_size
    Hq, Hkv, D = spec.num_heads, spec.num_kv_heads, spec.head_dim
    I = spec.intermediate_size
    G = spec.num_kv_groups

    def dense(shape, fan_in):
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=dev)
        return (x * (1.0 / math.sqrt(fan_in))).to(dtype)

    def ones(shape):
        return torch.ones(shape, dtype=dtype, device=dev)

    params = {
        "embed": dense((spec.vocab_size, E), E),
        "final_norm": ones((E,)),
        "layers": {
            "ln_attn": ones((L, E)),
            "ln_mlp": ones((L, E)),
            "wqkv": dense((L, E, Hkv * (G + 2) * D), E),
            "wo": dense((L, Hq * D, E), Hq * D),
            "w_gate": dense((L, E, I), E),
            "w_up": dense((L, E, I), E),
            "w_down": dense((L, I, E), I),
        },
    }
    if not spec.tie_word_embeddings:
        params["lm_head"] = dense((E, spec.vocab_size), E)
    return params


def _lm_logits(spec: ModelSpec, params: Params, h: torch.Tensor
               ) -> torch.Tensor:
    if "lm_head_t" in params:
        # The head stored in matmul orientation (quant.materialize_lm_head);
        # int8 carries a per-input-channel scale, folded into h.
        wt = params["lm_head_t"]
        if wt.dtype == torch.int8:
            h = h * params["lm_head_t_scale"].to(h.dtype)
            return h @ wt.to(h.dtype)
        return h @ wt
    if spec.tie_word_embeddings:
        return h @ params["embed"].transpose(0, 1)
    return h @ params["lm_head"]


# --------------------------------------------------------------------------
# shapes / derived statics
# --------------------------------------------------------------------------

class ModelStatics(NamedTuple):
    cache_heads: int          # H stored in the cache
    capacity: int
    caps: DecodeCaps


def derive_statics(spec: ModelSpec, comp: CompressionConfig,
                   ecfg: EngineConfig) -> ModelStatics:
    cache_heads = spec.num_heads if comp.evict_per_qhead else spec.num_kv_heads
    capacity = ecfg.cache_capacity(comp)
    caps = DecodeCaps(keep_cap=static_keep_cap(comp, ecfg.max_new_tokens),
                      capacity=capacity)
    return ModelStatics(cache_heads, capacity, caps)


def _group_scores(scores: Optional[torch.Tensor], groups: int
                  ) -> Optional[torch.Tensor]:
    """Aggregate per-query-head scores to per-KV-head (sum over group)."""
    if scores is None:
        return None
    B, Hq, S = scores.shape
    return scores.reshape(B, Hq // groups, groups, S).sum(dim=2)


def _split_qkv(spec: ModelSpec, qkv: torch.Tensor):
    """[B, S, Hkv*(G+2)*D] -> q [B,Hq,S,D], k, v [B,Hkv,S,D]."""
    B, S = qkv.shape[:2]
    Hq, Hkv, D = spec.num_heads, spec.num_kv_heads, spec.head_dim
    G = spec.num_kv_groups
    qkv = qkv.reshape(B, S, Hkv, G + 2, D)
    q = qkv[:, :, :, :G].reshape(B, S, Hq, D).transpose(1, 2)
    k = qkv[:, :, :, G].transpose(1, 2)
    v = qkv[:, :, :, G + 1].transpose(1, 2)
    return q, k, v


def layer_qkv(spec: ModelSpec, p, x: torch.Tensor, cos: torch.Tensor,
              sin: torch.Tensor):
    """Input norm + fused qkv projection + RoPE for one layer.

    x: [B, S, E].  Returns (q [B,Hq,S,D], k [B,Hkv,S,D], v [B,Hkv,S,D]),
    roped, NOT GQA-expanded."""
    h = rms_norm(x, p["ln_attn"], spec.rms_norm_eps)
    q, k, v = _split_qkv(spec, wdot(h, p, "wqkv"))
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def layer_post(spec: ModelSpec, p, x: torch.Tensor, out: torch.Tensor
               ) -> torch.Tensor:
    """Output projection + residual + MLP block.  out: [B, Hq, S, D]."""
    B, S = x.shape[:2]
    out = out.transpose(1, 2).reshape(B, S, -1)
    x = x + wdot(out, p, "wo")
    h2 = rms_norm(x, p["ln_mlp"], spec.rms_norm_eps)
    return x + mlp(h2, p)


def _layer(params: Params, l: int) -> Dict[str, torch.Tensor]:
    return {name: arr[l] for name, arr in params["layers"].items()}


# --------------------------------------------------------------------------
# prefill
# --------------------------------------------------------------------------

@torch.inference_mode()
def prefill(spec: ModelSpec, comp: CompressionConfig, ecfg: EngineConfig,
            params: Params, tokens: torch.Tensor, true_len: torch.Tensor
            ) -> Tuple[torch.Tensor, KVCache, SchedState]:
    """Process the (right-padded) prompt.  tokens: [B, S] int on the
    parameters' device; true_len: [B].  Returns (last-token logits [B, V],
    compressed cache, fresh scheduler state)."""
    _check_supported(spec, comp)
    st = derive_statics(spec, comp, ecfg)
    B, S = tokens.shape
    L = spec.num_layers
    D = spec.head_dim
    G = spec.num_kv_groups
    dtype = _dtype(ecfg.dtype)
    dev = params["embed"].device
    tl = true_len.to(device=dev, dtype=torch.int32)
    need_all = comp.method in ("h2o", "pyramidkv")
    need_win = comp.method == "snapkv"

    inv_freq = rope_inv_freq(D, spec.rope_theta, spec.rope_scaling, dev)
    positions = torch.arange(S, device=dev).expand(B, S)
    cos, sin = rope_cos_sin(positions, inv_freq)

    x = params["embed"][tokens.to(dev).long()].to(dtype)
    gap = comp.headwise_max_budget if comp.method == "headwise" else 0
    cache = init_cache(L, B, st.cache_heads, st.capacity, D, dtype, dev,
                       kv_dtype=ecfg.kv_dtype, prefill_gap=gap)
    cache.prompt_len = tl.clone()
    for l in range(L):
        p = _layer(params, l)
        q, k, v = layer_qkv(spec, p, x, cos, sin)
        k_full = repeat_kv(k, G)
        v_full = repeat_kv(v, G)
        out, scores = prefill_attention(
            q, k_full, v_full, tl, window_size=comp.window_size,
            need_colsum_all=need_all, need_colsum_window=need_win,
            sliding_window=spec.sliding_window)
        x = layer_post(spec, p, x, out)
        if comp.evict_per_qhead:
            ck, cv, sc = k_full, v_full, scores
        else:
            ck, cv = k, v
            sc = scores._replace(
                colsum_all=_group_scores(scores.colsum_all, G),
                colsum_window=_group_scores(scores.colsum_window, G))
        store_prefill_layer(ecfg, cache, l, compress_prefill(
            comp, l, L, ck, cv, q, sc, tl, st.capacity))

    if comp.method == "quest":
        cache = quest.build_page_metadata(comp, cache, tl)

    x = rms_norm(x, params["final_norm"], spec.rms_norm_eps)
    # Logits at the last real token of each row.
    last = (tl.long() - 1).clamp(0, S - 1)
    h_last = x[torch.arange(B, device=dev), last]
    logits = _lm_logits(spec, params, h_last)
    return logits, cache, SchedState.init(dev)


def store_prefill_layer(ecfg: EngineConfig, cache: KVCache, l: int,
                        res) -> None:
    """Write layer l's compressed prefill (a ``PrefillResult``) into the
    cache.  int8 / int4: calibrate and quantize this layer before it is
    stored, so no full-precision cache of all layers is ever held."""
    ck, cv, ks, vs, ko, vo = quant.quantize_prefill_layer(
        ecfg.kv_dtype, res.cache_k, res.cache_v, res.length, res.pvalid,
        cache.prefill_gap)
    cache.k[l] = ck
    cache.v[l] = cv
    cache.length[l] = res.length
    cache.pvalid[l] = res.pvalid
    for buf, val in ((cache.k_scale, ks), (cache.v_scale, vs),
                     (cache.k_off, ko), (cache.v_off, vo)):
        if buf is not None:
            buf[l] = val


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------

def _grouped_decode_attention(q: torch.Tensor, cache_k: torch.Tensor,
                              cache_v: torch.Tensor, mask: torch.Tensor,
                              groups: int, need_probs: bool = True
                              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """GQA decode attention without expanding the cache (kv-head layout).

    q: [B, Hq, 1, D]; cache: [B, Hkv, S, D] in its storage dtype (int8 and
    packed int4 read through ``quant.qk_einsum`` / ``pv_einsum``); mask:
    [B, Hkv, S].  Returns (out [B, Hq, 1, D], probs [B, Hkv, S] summed over
    each kv head's query group, the per-kv-head eviction scores; None
    unless need_probs)."""
    B, Hq, _, D = q.shape
    Hkv = cache_k.shape[1]
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, Hkv, groups, D)
    cd = cache_k.dtype if cache_k.dtype.is_floating_point else q.dtype
    logits = quant.qk_einsum("bhgd,bhsd->bhgs", qg, cache_k, cd,
                             torch.float32)
    logits = logits * scale
    logits = torch.where(mask[:, :, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = quant.pv_einsum("bhgs,bhsd->bhgd", probs.to(cd), cache_v, cd)
    return out.reshape(B, Hq, 1, D), (probs.sum(dim=2) if need_probs
                                      else None)


def _layer_tail(spec: ModelSpec, p, x: torch.Tensor, out: torch.Tensor
                ) -> torch.Tensor:
    """A decode layer's output projection, residual and MLP block: out
    [B, Hq, 1, D] -> the next layer's input [B, 1, E]."""
    B = out.shape[0]
    x = x + wdot(out.transpose(1, 2).reshape(B, 1, -1), p, "wo")
    return x + mlp(rms_norm(x, p["ln_mlp"], spec.rms_norm_eps), p)


COMPRESS_MODES = ("cond", "off", "force")


@torch.inference_mode()
def decode_step(spec: ModelSpec, comp: CompressionConfig, ecfg: EngineConfig,
                params: Params, token: torch.Tensor, vpos: torch.Tensor,
                cache: KVCache, state: SchedState,
                compress_mode: str = "cond",
                force_n_keep: Optional[torch.Tensor] = None,
                force_row_gate: Optional[torch.Tensor] = None,
                attn_cap: Optional[int] = None,
                quest_dec_cap: Optional[int] = None
                ) -> Tuple[torch.Tensor, KVCache, SchedState]:
    """One decode step.  token: [B] (the token being fed); vpos: [B] its
    virtual position (true_len + step).  Returns (next-token logits [B, V],
    cache, state); the cache's k/v/length are updated in place.

    compress_mode:
    - "cond": the scheduler's gates are evaluated per layer on the device
      and the block rewrite runs when a row fires; deciding that costs one
      host sync per layer (``schedulers.block_rewrite``).  The JAX
      package's ``lax.cond`` path.
    - "off": no compression logic and no eviction probabilities: append in
      place, attend over the first ``attn_cap`` slots (a host-chosen
      length bucket; None = all).  No host sync.
    - "force": the rewrite at ``schedulers.force_pseg`` keeping
      ``force_n_keep`` tokens on the rows of ``force_row_gate`` (every row
      when None): both [B] (every layer alike) or [L, B] (per-layer fire
      masks, pyramidkv's layered mirror); the device is not asked whether
      to fire.
    "off" and "force" are the host-scheduled decode of
    ``engine/host_loop.py`` and ``engine/serving.py``.

    Quest (``compression/quest.py``) attends its selected prompt pages and
    the decode region, whose view ``quest_dec_cap`` bounds (a host bucket;
    None = max_new_tokens + 1); ``attn_cap`` bounds its dense layers' view.
    Its rewrite is at each row's prompt_len.

    With an int8 / int4 cache the token is quantized with its row's
    prefill-calibrated scales before it is stored, the K scale is folded
    into q and the V scale (and int4's V offset) into the attention output.

    A row whose length has reached the capacity (an idle serving slot,
    whose tokens are discarded) appends into the last slot, as the JAX
    package's clamped update does; the rows in use never get there."""
    _check_supported(spec, comp)
    if compress_mode not in COMPRESS_MODES:
        raise ValueError(f"compress_mode {compress_mode!r} is not one of "
                         f"{COMPRESS_MODES}")
    metric = comp.decoding_metric
    st = derive_statics(spec, comp, ecfg)
    if attn_cap is not None:
        attn_cap = min(attn_cap, st.capacity)
        st = st._replace(caps=st.caps._replace(capacity=attn_cap))
    B = token.shape[0]
    L = spec.num_layers
    D = spec.head_dim
    Hc = st.cache_heads
    G = spec.num_kv_groups
    cap = attn_cap or cache.capacity       # the slots attention reads
    dev = params["embed"].device
    vpos = vpos.to(dev)

    inv_freq = rope_inv_freq(D, spec.rope_theta, spec.rope_scaling, dev)
    cos, sin = rope_cos_sin(vpos[:, None], inv_freq)          # [B, 1, D]
    x = params["embed"][token.to(dev).long()[:, None]].to(_dtype(ecfg.dtype))
    b_idx = torch.arange(B, device=dev)[:, None]
    h_idx = torch.arange(Hc, device=dev)[None, :]
    need_probs = metric != "none" and compress_mode != "off"
    if compress_mode == "force" and need_probs:
        pseg, positional = force_pseg(comp, B, cache.prompt_len)
        gates = (torch.ones((B,), dtype=torch.bool, device=dev)
                 if force_row_gate is None
                 else force_row_gate.to(device=dev, dtype=torch.bool))
        keeps = force_n_keep.to(device=dev, dtype=torch.int32)
    int4 = ecfg.kv_dtype == "int4"
    quantized = int4 or ecfg.kv_dtype == "int8"
    dec_cap = min(quest_dec_cap or ecfg.max_new_tokens + 1,
                  ecfg.max_new_tokens + 1)

    for l in range(L):
        p = _layer(params, l)
        h = rms_norm(x, p["ln_attn"], spec.rms_norm_eps)
        q, k, v = _split_qkv(spec, wdot(h, p, "wqkv"))
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        if comp.evict_per_qhead:
            k = repeat_kv(k, G)
            v = repeat_kv(v, G)
        if quantized:
            ks_l, vs_l = cache.k_scale[l], cache.v_scale[l]     # [B, Hc, D]
            if int4:
                k = quant.quantize4(k, ks_l, cache.k_off[l])
                v = quant.quantize4(v, vs_l, cache.v_off[l])
            else:
                k = quant.quantize(k, ks_l)
                v = quant.quantize(v, vs_l)
            q = quant.fold_q_scale(q, ks_l)

        # In-place append at (l, b, :, length[b], :).
        length = cache.length[l]
        pos = length.long().clamp(max=cache.capacity - 1)[:, None]
        cache.k[l, b_idx, h_idx, pos] = k[:, :, 0, :]
        cache.v[l, b_idx, h_idx, pos] = v[:, :, 0, :]
        length = length + 1
        cache.length[l] = length

        if comp.method == "quest":
            fg = fk = None
            if compress_mode == "force" and need_probs:
                fg = gates[l] if gates.dim() == 2 else gates
                fk = keeps[l] if keeps.dim() == 2 else keeps
            out, state = quest.quest_decode_layer(
                comp, st.caps, state, q, cache, l, L, dec_cap=dec_cap,
                groups=1 if comp.evict_per_qhead else G,
                compress_mode=compress_mode, force_row_gate=fg,
                force_n_keep=fk, tot_cap=attn_cap or 0)
            if comp.quest_decode_pages > 0:
                quest.update_decode_page_metadata(comp, cache, l)
            if quantized:
                out = quant.fold_out_scale(out, vs_l,
                                           cache.v_off[l] if int4 else None)
            x = _layer_tail(spec, p, x, out)
            continue

        ck_l, cv_l = cache.k[l, :, :, :cap], cache.v[l, :, :, :cap]
        mask = slot_mask(length, cache.pvalid[l], cache.prefill_gap, cap)
        if comp.evict_per_qhead:
            out, probs = decode_attention(q, ck_l, cv_l, mask)
        else:
            out, probs = _grouped_decode_attention(q, ck_l, cv_l, mask, G,
                                                   need_probs)
        if quantized:
            out = quant.fold_out_scale(out, vs_l,
                                       cache.v_off[l] if int4 else None)

        if need_probs and compress_mode == "force":
            row_gate = gates[l] if gates.dim() == 2 else gates
            n_keep = keeps[l] if keeps.dim() == 2 else keeps
            kblk, vblk, new_len = gather_block(
                comp, st.caps, probs, ck_l, cv_l, length, pseg, n_keep,
                row_gate, positional)
            write_block(cache.k, l, pseg, kblk)
            write_block(cache.v, l, pseg, vblk)
            cache.length[l] = new_len
        elif need_probs:                                 # cond
            row_gate, n_keep, pseg, positional, state = schedule_decision(
                comp, st.caps, state, length, cache.prompt_len, l, L)
            kblk, vblk, new_len = block_rewrite(
                comp, st.caps, probs, ck_l, cv_l, length, pseg, n_keep,
                row_gate, positional)
            if kblk is not None:
                write_block(cache.k, l, pseg, kblk)
                write_block(cache.v, l, pseg, vblk)
                cache.length[l] = new_len

        x = _layer_tail(spec, p, x, out)

    x = rms_norm(x, params["final_norm"], spec.rms_norm_eps)
    logits = _lm_logits(spec, params, x[:, 0])
    return logits, cache, state


@torch.inference_mode()
def decode_steps(spec: ModelSpec, comp: CompressionConfig,
                 ecfg: EngineConfig, params: Params, token: torch.Tensor,
                 vpos: torch.Tensor, cache: KVCache, state: SchedState,
                 n_steps: int, attn_cap: Optional[int] = None,
                 quest_dec_cap: Optional[int] = None
                 ) -> Tuple[torch.Tensor, KVCache, SchedState]:
    """``n_steps`` greedy hot steps (``compress_mode="off"``), each
    step's token kept on the device as the next step's input.  Only valid
    where no compression fires; the host plans such stretches
    (``HostScheduler.hot_run_length``); ``attn_cap`` and
    ``quest_dec_cap`` are :func:`decode_step`'s.  Returns (tokens
    [B, n_steps] int32, the last one the next step's input, cache, state).
    The JAX package's in-chunk staging ring is not ported: it dodges a TPU
    buffer copy that in-place writes do not make here."""
    vpos = vpos.to(params["embed"].device)
    toks = []
    for i in range(n_steps):
        logits, cache, state = decode_step(
            spec, comp, ecfg, params, token, vpos + i, cache, state,
            compress_mode="off", attn_cap=attn_cap,
            quest_dec_cap=quest_dec_cap)
        token = torch.argmax(logits, dim=-1).to(torch.int32)
        toks.append(token)
    return torch.stack(toks, dim=1), cache, state
