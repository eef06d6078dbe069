"""Quest: query-aware page selection over an uncompressed prefill cache.

A port of the JAX package's ``compression/quest.py`` (XLA ops there, torch
ops here).  Prefill keeps every prompt token; each decode step scores the
prompt's ``chunk_size``-token pages with the sign-trick bound
sum_d max(q_d * page_min_d, q_d * page_max_d), attends over the top pages
(the last real page always among them) plus the decode region, and
compresses the decode region with the none / fixed / linear / jump
metrics.  Layers below ``quest_skip_layers`` attend densely, never
compress and never advance the scheduler counters, so a jump wave spans
two steps.

As in the JAX package, attention runs over [selected pages | decode
region] (the reference selects pages and then attends the full cache),
and the page metadata is built once after prefill instead of every step;
the selected pages are the same.  Selected pages are concatenated in rank
order (score descending, index ascending, as ``lax.top_k`` orders them),
which sets the summation order of the attention products.

The port updates the stacked [L, ...] cache in place: the decode-region
rewrite writes each row's block at its own ``prompt_len``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from scope_tpu_torch.cache import KVCache
from scope_tpu_torch.compression.policies import topk_indices
from scope_tpu_torch.compression.schedulers import (DecodeCaps, SchedState,
                                                    block_rewrite,
                                                    gather_block,
                                                    write_block)
from scope_tpu_torch.config import CompressionConfig
from scope_tpu_torch.ops import quant
from scope_tpu_torch.ops.attention import NEG_INF


def num_pages(max_prompt_len: int, chunk: int) -> int:
    return -(-max_prompt_len // chunk)


def _extremes(dtype: torch.dtype) -> Tuple[object, object]:
    """The (empty-page min, empty-page max) fill values of ``dtype``, as the
    JAX package computes them: the type's largest value and its negation
    in the type.  float32's max rounds to inf in bf16, so a bf16 cache's
    empty pages hold +-inf; uint8 (int4 codes) keeps the wrap of -255,
    which is 1."""
    if dtype == torch.uint8:
        return 255, 1
    if dtype == torch.int8:
        return 127, -127
    big = torch.tensor(torch.finfo(torch.float32).max).to(dtype).item()
    return big, -big


def build_page_metadata(comp: CompressionConfig, cache: KVCache,
                        true_len: torch.Tensor) -> KVCache:
    """Per-page min / max keys over the prefill region: pages cover slots
    [0, NP * chunk), NP = capacity // chunk, and only slots below each
    row's true_len count.  cache.k: [L, B, H, cap, Ds].  An int8 cache
    keeps int8 extremes (positive per-channel scales, folded into q, select
    the same pages); int4 keeps unpacked uint8 codes at full head_dim."""
    chunk = comp.chunk_size
    L, B, H, cap, _ = cache.k.shape
    NP = cap // chunk
    k = cache.k[:, :, :, :NP * chunk, :]
    if k.dtype == torch.uint8:
        k = quant.unpack4(k, torch.uint8)
    D = k.shape[-1]
    k = k.reshape(L, B, H, NP, chunk, D)
    slot = torch.arange(NP * chunk, device=k.device).reshape(NP, chunk)
    tl = true_len.to(device=k.device)
    real = (slot[None] < tl[:, None, None])[None, :, None, :, :, None]
    big, neg_big = _extremes(k.dtype)
    page_min = torch.where(real, k, torch.tensor(big, dtype=k.dtype,
                                                 device=k.device)).amin(4)
    page_max = torch.where(real, k, torch.tensor(neg_big, dtype=k.dtype,
                                                 device=k.device)).amax(4)
    return cache.replace(page_min=page_min, page_max=page_max)


def update_decode_page_metadata(comp: CompressionConfig, cache: KVCache,
                                l: int) -> None:
    """Fold the token just appended to layer ``l`` (slot length - 1 of each
    row) into its page's min / max, in place: the incremental counterpart
    of :func:`build_page_metadata` for the decode region
    (``quest_decode_pages > 0``).  Pages are absolute over the capacity,
    so the page holding the prompt / decode boundary mixes both segments;
    attention's token-validity mask keeps them apart.  int4 folds unpacked
    codes.  A row past the capacity (an idle serving slot) folds into the
    last slot's page, as the JAX package's clamped slice does."""
    chunk = comp.chunk_size
    ck = cache.k[l]                                   # [B, Hc, cap, Ds]
    B, _, cap, _ = ck.shape
    NP = cache.page_min.shape[3]
    dev = ck.device
    b_idx = torch.arange(B, device=dev)
    slot = (cache.length[l].long() - 1).clamp(0, cap - 1)
    k_new = ck[b_idx, :, slot]                        # [B, Hc, Ds]
    if k_new.dtype == torch.uint8:
        k_new = quant.unpack4(k_new, torch.uint8)
    pg = (slot // chunk).clamp(max=NP - 1)
    pm, pM = cache.page_min[l], cache.page_max[l]    # [B, Hc, NP, D] views
    pm[b_idx, :, pg] = torch.minimum(pm[b_idx, :, pg], k_new)
    pM[b_idx, :, pg] = torch.maximum(pM[b_idx, :, pg], k_new)


def page_scores(q: torch.Tensor, page_min: torch.Tensor,
                page_max: torch.Tensor) -> torch.Tensor:
    """The sign-trick bound: q [B, Hc, G, D], page_min / page_max
    [B, Hc, NP, D] -> [B, Hc, NP] float32, summed over the query group.
    Empty pages may score NaN or -inf (0 * inf in a bf16 cache); callers
    mask them with ``torch.where``, never with a multiply."""
    contrib = torch.where(q[:, :, :, None, :] > 0,
                          page_max[:, :, None, :, :],
                          page_min[:, :, None, :, :])
    per_head = torch.einsum("bhgd,bhgpd->bhgp", q.float(), contrib.float())
    return per_head.sum(dim=2)


def _pad_last(x: torch.Tensor, value) -> torch.Tensor:
    """x [B, Hc, n] with one ``value`` column appended."""
    return torch.cat([x, torch.full(x.shape[:2] + (1,), value, dtype=x.dtype,
                                    device=x.device)], dim=-1)


def _select(comp: CompressionConfig, qg: torch.Tensor, page_min, page_max,
            prompt_len: torch.Tensor, length: torch.Tensor, dec_cap: int,
            NP: int) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Slots to attend and their validity, [B, Hc, SELP*chunk + n_dec]:
    the top SELP - 1 prompt pages with the last real page forced in, then
    the decode region (the dense dec_cap-wide slice, or its top pages with
    ``quest_decode_pages``).  Returns (idx, valid, SELP * chunk)."""
    B, Hc = qg.shape[:2]
    dev = qg.device
    chunk = comp.chunk_size
    P = comp.max_capacity_prompt
    pl = prompt_len.long()
    ln = length.long()
    SELP = max(1, min(P, NP * chunk) // chunk)
    page_sc = page_scores(qg, page_min, page_max)             # [B, Hc, NP]
    np_real = (pl + chunk - 1) // chunk
    last_page = (np_real - 1).clamp(min=0)
    p_idx = torch.arange(NP, device=dev)
    n_pages = torch.minimum(torch.minimum(pl, torch.full_like(pl, P))
                            // chunk, np_real)                # [B] incl last
    masked = torch.where(p_idx[None, None, :] < last_page[:, None, None],
                         page_sc, NEG_INF)
    sel = topk_indices(masked, SELP - 1)                      # [B, Hc, SELP-1]
    j = torch.arange(SELP, device=dev)
    is_last_slot = j[None, None, :] == (n_pages - 1)[:, None, None]
    sel_pages = torch.where(is_last_slot, last_page[:, None, None],
                            _pad_last(sel, 0))
    page_valid = j[None, None, :] < n_pages[:, None, None]
    off = torch.arange(chunk, device=dev)
    tok = sel_pages[..., None] * chunk + off                  # [B,Hc,SELP,ch]
    tok_idx = tok.reshape(B, Hc, SELP * chunk)
    tok_valid = (page_valid[..., None]
                 & (tok < pl[:, None, None, None])).reshape(B, Hc,
                                                            SELP * chunk)

    SELD = comp.quest_decode_pages
    if SELD > 0:
        # The decode region's pages scored with the same bound (metadata
        # folded at append time), its top SELD - 1 plus its last page.
        dpage0 = pl // chunk
        last_dp = torch.maximum((ln - 1) // chunk, dpage0)
        in_region = ((p_idx[None, None, :] >= dpage0[:, None, None])
                     & (p_idx[None, None, :] < last_dp[:, None, None]))
        dmask = torch.where(in_region, page_sc, NEG_INF)
        dsel = topk_indices(dmask, SELD - 1)
        dsc = torch.gather(dmask, 2, dsel)
        pvalid_d = _pad_last(dsc > NEG_INF / 2, True)
        dsel_pages = torch.cat([dsel, last_dp[:, None, None].expand(
            B, Hc, 1)], dim=-1)                               # [B, Hc, SELD]
        dtok = dsel_pages[..., None] * chunk + off
        dec_idx = dtok.reshape(B, Hc, SELD * chunk)
        dec_valid = (pvalid_d[..., None]
                     & (dtok >= pl[:, None, None, None])
                     & (dtok < ln[:, None, None, None])
                     ).reshape(B, Hc, SELD * chunk)
    else:
        dec_idx = pl[:, None, None] + torch.arange(dec_cap, device=dev)
        dec_valid = (dec_idx < ln[:, None, None]).expand(B, Hc, dec_cap)
        dec_idx = dec_idx.expand(B, Hc, dec_cap)
    return (torch.cat([tok_idx, dec_idx], dim=-1),
            torch.cat([tok_valid, dec_valid], dim=-1), SELP * chunk)


def _attend(qg: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
            valid: torch.Tensor, idx: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention of qg [B, Hc, G, D] over ck / cv [B, Hc, S, Ds] (gathered
    at idx [B, Hc, S'] when given) under valid [B, Hc, S'].  Quantized
    caches compute in q's dtype (the K scale is already folded into q;
    the caller folds the V scale into the output).  Returns (out
    [B, Hc, G, D], probs [B, Hc, S'] summed over the group)."""
    if idx is not None:
        gidx = idx[..., None].expand(*idx.shape, ck.shape[-1])
        ck = torch.gather(ck, 2, gidx)
        cv = torch.gather(cv, 2, gidx)
    cd = cv.dtype if cv.dtype.is_floating_point else qg.dtype
    logits = quant.qk_einsum("bhgd,bhsd->bhgs", qg, ck, cd, torch.float32)
    logits = logits * (1.0 / math.sqrt(qg.shape[-1]))
    logits = torch.where(valid[:, :, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = quant.pv_einsum("bhgs,bhsd->bhgd", probs.to(cd), cv, cd)
    return out, probs.sum(dim=2)


def quest_decode_layer(
    comp: CompressionConfig, caps: DecodeCaps, state: SchedState,
    q: torch.Tensor, cache: KVCache, l: int, num_layers: int, *,
    dec_cap: int, groups: int = 1, compress_mode: str = "cond",
    force_row_gate: Optional[torch.Tensor] = None,
    force_n_keep: Optional[torch.Tensor] = None, tot_cap: int = 0,
) -> Tuple[torch.Tensor, SchedState]:
    """Quest's decode for layer ``l`` of the stacked cache, after the
    step's token was appended (``cache.length[l]`` counts it).

    q: [B, Hq, 1, D] roped (K scale folded in for a quantized cache).
    Returns (out [B, Hq, 1, D], state); the decode-region rewrite, when a
    row fires, is written into ``cache`` in place at each row's
    ``prompt_len``.  compress_mode: "cond" (the device's counters; asking
    whether a row fires costs one host sync), "off" (a hot step: page
    selection and attention only) or "force" (the host's [B] gates and
    keep counts).  ``dec_cap`` bounds the decode-region view (a host
    bucket); ``tot_cap`` > 0 bounds the dense layers' full-cache view."""
    ck, cv = cache.k[l], cache.v[l]
    length = cache.length[l]
    prompt_len = cache.prompt_len
    B, Hq, _, D = q.shape
    Hc, cap = ck.shape[1], ck.shape[2]
    ck_r, cv_r = ((ck[:, :, :tot_cap], cv[:, :, :tot_cap])
                  if tot_cap and tot_cap < cap else (ck, cv))
    cap_r = ck_r.shape[2]
    qg = q.reshape(B, Hc, groups, D)
    metric = comp.decoding_metric
    r = comp.decoding_recent_size

    if l < comp.quest_skip_layers:
        # Dense layers: full attention over the valid slots; no rewrite,
        # no counter moves (the reference returns before touching them).
        slot = torch.arange(cap_r, device=q.device)
        valid = (slot[None, :] < length[:, None])[:, None, :].expand(
            B, Hc, cap_r)
        out, _ = _attend(qg, ck_r, cv_r, valid)
        return out.reshape(B, Hq, 1, D), state

    dk_len = length - prompt_len
    use_counters = compress_mode == "cond" and metric != "none"
    if use_counters and metric in ("linear", "jump"):
        thresh = comp.delta * num_layers
        w_t = r + torch.div(state.step, thresh, rounding_mode="floor")
        state = state.replace(step=state.step + 1)
    else:
        w_t = comp.decoding_window_size

    idx, valid, n_sel = _select(comp, qg, cache.page_min[l],
                                cache.page_max[l], prompt_len, length,
                                dec_cap, cache.page_min.shape[3])
    out, probs = _attend(qg, ck_r, cv_r, valid, idx.clamp(0, cap_r - 1))
    out = out.reshape(B, Hq, 1, D)
    if metric == "none" or compress_mode == "off":
        return out, state

    if compress_mode == "force":
        row_gate, n_keep = force_row_gate, force_n_keep
    else:
        # Gates are relative to the decode region.
        row_gate = dk_len >= w_t
        if metric == "jump":
            thresh = comp.delta * num_layers
            # Scalar counters: one stream, any-row gate; per-row counters
            # ([B]): each row runs its own wave.
            per_row = state.jump_step.dim() == 1
            gate = row_gate if per_row else row_gate.any()
            counting = gate & (state.jump_step < thresh)
            wave = gate & (state.jump_step >= thresh)
            js = state.jump_step + counting.to(torch.int32)
            jl = state.jump_layer + wave.to(torch.int32)
            finished = jl >= num_layers
            zero = torch.zeros_like(js)
            state = state.replace(jump_step=torch.where(finished, zero, js),
                                  jump_layer=torch.where(finished, zero, jl))
            row_gate = row_gate & wave
        n_keep = torch.as_tensor(w_t - r, device=q.device).clamp(
            0, caps.keep_cap).to(torch.int32).expand(B)
        n_keep = torch.minimum(n_keep, (dk_len - r).clamp(min=0))

    # The decode region's probabilities at their absolute slots, so the
    # block rewrite applies with pseg = prompt_len; a region that would
    # run past the capacity is shifted back, as a clamped
    # dynamic_update_slice places it.
    dec_probs = probs[:, :, n_sel:]
    n_dec = dec_probs.shape[2]
    start = prompt_len.long().clamp(0, cap - n_dec)
    dest = (start[:, None] + torch.arange(n_dec, device=q.device))
    probs_abs = torch.zeros((B, Hc, cap), dtype=torch.float32,
                            device=q.device)
    probs_abs.scatter_(2, dest[:, None, :].expand(B, Hc, n_dec), dec_probs)
    pseg = prompt_len.to(torch.int32)
    if compress_mode == "force":
        kblk, vblk, new_len = gather_block(
            comp, caps, probs_abs, ck, cv, length, pseg, n_keep.to(
                torch.int32), row_gate)
    else:
        kblk, vblk, new_len = block_rewrite(
            comp, caps, probs_abs, ck, cv, length, pseg, n_keep.to(
                torch.int32), row_gate)
    if kblk is not None:
        write_block(cache.k, l, pseg, kblk)
        write_block(cache.v, l, pseg, vblk)
        cache.length[l] = new_len
    return out, state
