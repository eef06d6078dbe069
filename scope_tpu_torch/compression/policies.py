"""Prefill-phase KV compression policies.

Each policy turns (full prefill K/V, eviction scores, true prompt length)
into a destination->source slot map plus length bookkeeping; one gather
then writes the compacted cache, as in the JAX package: H2O (cumulative
attention), SnapKV (pooled observation-window scores), StreamingLLM
(positional sinks + recent), PyramidKV (layer-decayed budgets over H2O
scores), headwise (``compression/headwise.py``) and the no-eviction
passthrough of fullkv, allkv and Quest (which selects pages at decode,
``compression/quest.py``).

Top-k ties are ordered as ``lax.top_k`` orders them: score descending,
then index ascending (a stable descending sort), so the kept sets match
the JAX package's exactly, SnapKV's maxpool plateaus included.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import torch

from scope_tpu_torch.config import CompressionConfig
from scope_tpu_torch.ops.attention import NEG_INF, PrefillScores, pool_scores


class PrefillResult(NamedTuple):
    cache_k: torch.Tensor    # [B, H, capacity, D]
    cache_v: torch.Tensor    # [B, H, capacity, D]
    length: torch.Tensor     # [B] int32 physical length
    pvalid: torch.Tensor     # [B, H] int32 per-head valid prefill count


def topk_indices(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest scores along the last axis, ordered as
    ``lax.top_k`` orders them: score descending, ties by index ascending."""
    return torch.sort(scores, dim=-1, descending=True,
                      stable=True).indices[..., :k]


def _pad_to_capacity(x: torch.Tensor, capacity: int) -> torch.Tensor:
    """Zero-pad the slot axis of [B, H, S, D] to capacity."""
    S = x.shape[2]
    if S == capacity:
        return x
    if S < capacity:
        return torch.nn.functional.pad(x, (0, 0, 0, capacity - S))
    raise ValueError(
        f"prefill length {S} exceeds cache capacity {capacity}; increase "
        f"EngineConfig.max_prompt_len / cache_capacity")


def _gather_slots(x: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """x [B, H, S, D] gathered at src [B, H, N] along the slot axis."""
    idx = src[..., None].expand(*src.shape, x.shape[-1])
    return torch.gather(x, 2, idx)


def _passthrough(k, v, true_len, capacity) -> PrefillResult:
    B, H = k.shape[:2]
    tl = true_len.to(torch.int32)
    return PrefillResult(_pad_to_capacity(k, capacity),
                         _pad_to_capacity(v, capacity), tl,
                         tl[:, None].expand(B, H))


def _topk_tail_map(scores: torch.Tensor, n_keep_static: int,
                   n_keep: Union[int, torch.Tensor], tail_start: torch.Tensor,
                   tail_len: int, capacity: int):
    """dest->src map: [top-n_keep by score | tail window | slot 0 junk].

    scores: [B, H, S_pad] float32, NEG_INF at ineligible keys; n_keep: an
    int or [B, 1] counts, at most the static top-k size n_keep_static;
    tail_start: [B] = true_len - tail_len.  Returns (src [B, H, capacity]
    int64, new_len [B, H] = n_keep + tail_len)."""
    B, H, S_pad = scores.shape
    dev = scores.device
    topk = topk_indices(scores, n_keep_static)                   # [B, H, K]
    d = torch.arange(capacity, device=dev)
    nk = torch.as_tensor(n_keep, device=dev).long().expand(B, 1)[:, :, None]
    in_keep = d < nk
    in_tail = (d >= nk) & (d < nk + tail_len)
    src_keep = topk[..., d.clamp(max=n_keep_static - 1)]         # [B, H, cap]
    src_tail = tail_start[:, None, None].long() + (d - nk)
    src = torch.where(in_keep, src_keep,
                      torch.where(in_tail, src_tail, torch.zeros_like(d)))
    new_len = (nk[..., 0] + tail_len).expand(B, H)
    return src.clamp(0, S_pad - 1), new_len


def _identity_or(src: torch.Tensor, new_len: torch.Tensor,
                 gate_no_compress: torch.Tensor, true_len: torch.Tensor,
                 capacity: int):
    """The identity map (no compression) on the rows where the gate
    holds."""
    d = torch.arange(capacity, device=src.device)
    g = gate_no_compress[:, None]
    return (torch.where(g[..., None], d, src),
            torch.where(g, true_len[:, None].long(), new_len))


def compress_prefill(comp: CompressionConfig, layer_idx: int,
                     num_layers: int, k: torch.Tensor, v: torch.Tensor,
                     q: torch.Tensor, scores: PrefillScores,
                     true_len: torch.Tensor, capacity: int) -> PrefillResult:
    """Dispatch on comp.method.  k/v: [B, H, S_pad, D] roped,
    GQA-expanded (per-query-head eviction, q [B, H, S_pad, D]) or per KV
    head with group-summed scores (q keeps all query heads)."""
    B, H, S_pad, D = k.shape
    method = comp.method
    if method in ("fullkv", "allkv", "quest"):
        # No prefill eviction.
        return _passthrough(k, v, true_len, capacity)
    tl = true_len.to(device=k.device, dtype=torch.int32)
    if method == "headwise":
        from scope_tpu_torch.compression.headwise import headwise_prefill_map
        src, pvalid = headwise_prefill_map(comp, q, k, tl, capacity,
                                           layer_idx)
        # Decode tokens append at the reserved segment's end, uniformly
        # across heads; per-head validity lives in pvalid.
        length = torch.full_like(tl, comp.headwise_max_budget)
        return PrefillResult(_gather_slots(k, src), _gather_slots(v, src),
                             length, pvalid)

    P = comp.max_capacity_prompt
    w = comp.window_size
    if S_pad <= P:
        # The compression branch is statically unreachable.
        return _passthrough(k, v, true_len, capacity)

    kv_idx = torch.arange(S_pad, device=k.device)
    region = (kv_idx[None, :] < (tl - w)[:, None])[:, None, :]  # [B, 1, S_pad]
    tail_start = tl - w
    if method == "h2o":
        # Cumulative attention over all queries.
        s = torch.where(region, scores.colsum_all, NEG_INF)
        src, new_len = _topk_tail_map(s, P - w, P - w, tail_start, w,
                                      capacity)
    elif method == "snapkv":
        # Observation-window column sums, pooled over the key axis.
        s0 = torch.where(region, scores.colsum_window, 0.0)
        s = pool_scores(s0, comp.kernel_size, comp.pooling)
        s = torch.where(region, s, NEG_INF)
        src, new_len = _topk_tail_map(s, P - w, P - w, tail_start, w,
                                      capacity)
    elif method == "streamingllm":
        # Positional: the first P - w sinks + the last w, as the top-k of
        # -index so it shares _topk_tail_map.
        s = torch.where(region, -kv_idx.float(), NEG_INF).expand(B, H, S_pad)
        n_keep = torch.clamp(tl - w, max=P - w)[:, None]
        src, new_len = _topk_tail_map(s, P - w, n_keep, tail_start, w,
                                      capacity)
    elif method == "pyramidkv":
        # PyramidInfer-mode budgets with the full-query scoring variant.
        min_num = (P - w) // comp.beta
        max_num = (P - w) * 2 - min_num
        over = max_num >= tl - w                                 # [B]
        max_num_d = torch.where(over, tl - w, max_num)
        steps = torch.div(
            max_num_d - torch.where(over, (P - w) * 2 - max_num_d, min_num),
            num_layers, rounding_mode="floor")
        budget_l = max_num_d - layer_idx * steps
        # The mid branch keeps the top P (not P - w: a reference quirk),
        # the deep branch keeps budget_l.
        mid = tl < (P - w) * 2
        n_keep = torch.where(mid, P, budget_l)
        n_keep = torch.minimum(n_keep.clamp(min=0), tl - w)[:, None]
        s = torch.where(region, scores.colsum_all, NEG_INF)
        src, new_len = _topk_tail_map(s, min(2 * (P - w), S_pad), n_keep,
                                      tail_start, w, capacity)
    else:
        raise ValueError(f"unknown prefill method {method!r}")

    # Rows whose prompt is shorter than P keep everything (identity map).
    src, new_len = _identity_or(src, new_len, tl < P, tl, capacity)
    # Identity slots past S_pad read zero padding.
    ck = _gather_slots(_pad_to_capacity(k, max(capacity, S_pad)), src)
    cv = _gather_slots(_pad_to_capacity(v, max(capacity, S_pad)), src)
    pvalid = new_len.to(torch.int32)
    return PrefillResult(ck, cv, pvalid[:, 0].contiguous(), pvalid)
