"""Prefill-phase KV compression policies.

Each policy turns (full prefill K/V, eviction scores, true prompt length)
into a destination->source slot map plus length bookkeeping; one gather
then writes the compacted cache, as in the JAX package.  Ported so far:
H2O (cumulative attention) and the no-eviction passthrough of
fullkv/allkv.

Top-k ties are ordered as ``lax.top_k`` orders them: score descending,
then index ascending (a stable descending sort), so the kept sets match
the JAX package's exactly.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from scope_tpu_torch.config import CompressionConfig
from scope_tpu_torch.ops.attention import NEG_INF, PrefillScores

_NOT_PORTED = ("snapkv", "pyramidkv", "streamingllm", "quest", "headwise")


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


def _topk_tail_map(scores: torch.Tensor, n_keep: int,
                   tail_start: torch.Tensor, tail_len: int, capacity: int):
    """dest->src map: [top-n_keep by score | tail window | slot 0 junk].

    scores: [B, H, S_pad] float32, NEG_INF at ineligible keys;
    tail_start: [B] = true_len - tail_len.  Returns (src [B, H, capacity]
    int64, new_len = n_keep + tail_len)."""
    B, H, S_pad = scores.shape
    topk = topk_indices(scores, n_keep)                          # [B, H, K]
    d = torch.arange(capacity, device=scores.device)
    in_keep = d < n_keep
    in_tail = (d >= n_keep) & (d < n_keep + tail_len)
    src_keep = topk[..., d.clamp(max=n_keep - 1)]                # [B, H, cap]
    src_tail = (tail_start[:, None, None].long() + (d - n_keep))
    src = torch.where(in_keep, src_keep,
                      torch.where(in_tail, src_tail, torch.zeros_like(d)))
    return src.clamp(0, S_pad - 1), n_keep + tail_len


def compress_prefill(comp: CompressionConfig, layer_idx: int,
                     num_layers: int, k: torch.Tensor, v: torch.Tensor,
                     q: torch.Tensor, scores: PrefillScores,
                     true_len: torch.Tensor, capacity: int) -> PrefillResult:
    """Dispatch on comp.method.  k/v/q: [B, H, S_pad, D] roped,
    GQA-expanded (per-query-head eviction) or per-KV-head with
    group-aggregated scores."""
    B, H, S_pad, D = k.shape
    method = comp.method
    if method in _NOT_PORTED:
        raise NotImplementedError(
            f"prefill method {method!r} is not ported yet (ROADMAP §1 "
            f"item 13)")
    if method in ("fullkv", "allkv"):
        # No prefill eviction.
        return _passthrough(k, v, true_len, capacity)
    if method != "h2o":
        raise ValueError(f"unknown prefill method {method!r}")

    P = comp.max_capacity_prompt
    w = comp.window_size
    if S_pad <= P:
        # The compression branch is statically unreachable.
        return _passthrough(k, v, true_len, capacity)

    tl = true_len.to(device=k.device, dtype=torch.int32)
    kv_idx = torch.arange(S_pad, device=k.device)
    region = kv_idx[None, :] < (tl - w)[:, None]                 # [B, S_pad]
    # H2O: cumulative attention over all queries.
    s = torch.where(region[:, None, :], scores.colsum_all, NEG_INF)
    src, new_len = _topk_tail_map(s, P - w, tl - w, w, capacity)

    # Rows whose prompt is shorter than P keep everything (identity map).
    gate = tl < P                                                # [B]
    d = torch.arange(capacity, device=k.device)
    src = torch.where(gate[:, None, None], d, src)
    length = torch.where(gate, tl, new_len).to(torch.int32)
    # Identity slots past S_pad read zero padding.
    ck = _gather_slots(_pad_to_capacity(k, max(capacity, S_pad)), src)
    cv = _gather_slots(_pad_to_capacity(v, max(capacity, S_pad)), src)
    return PrefillResult(ck, cv, length, length[:, None].expand(B, H))
