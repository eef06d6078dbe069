"""Attention paths: prefill attention with fused eviction-score capture,
and masked decode attention over the static slotted cache.

Prefill reaches the two hand-written Hopper kernels of
:mod:`scope_tpu_torch.ops.flash_prefill` for CUDA tensors (their plain
versions for CPU tensors), and so does :func:`prefill_scores_only`, the
scores of chunked prefill's finalize pass.  SnapKV's observation-window scores
(:func:`_window_colsum`), their pooling (:func:`pool_scores`) and decode
attention are plain torch ops, as they are XLA ops in the JAX package;
decode attention's probabilities double as the decode eviction scores.

Score semantics follow the JAX package exactly, including the reference's
quirk of applying a causal mask only to the trailing ``w x w`` block of the
scoring softmax: earlier queries attend to *future* keys in the score pass.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from scope_tpu_torch.ops.flash_prefill import (NEG_INF, colsum_scores,
                                               flash_prefill)
from scope_tpu_torch.ops.quant import pv_einsum, qk_einsum


class PrefillScores(NamedTuple):
    """Per-key accumulated eviction scores from the prefill pass."""

    # Column sums of the full-query scoring softmax (H2O / PyramidKV
    # semantics).  float32 [B, H, S].
    colsum_all: Optional[torch.Tensor]
    # Column sums over only the last-w query rows (SnapKV semantics).
    # float32 [B, H, S].
    colsum_window: Optional[torch.Tensor]


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      true_len: torch.Tensor, *, window_size: int,
                      need_colsum_all: bool = False,
                      need_colsum_window: bool = False,
                      sliding_window: Optional[int] = None
                      ) -> Tuple[torch.Tensor, PrefillScores]:
    """Causal attention over the full (uncompressed) prompt + score capture.

    q, k, v: [B, H, S, D] (roped, GQA-expanded).  true_len: [B] int count of
    real (non-pad) tokens; prompts are right-padded to S.  CUDA tensors run
    the ``flash_prefill`` kernel (and ``colsum_scores`` when
    ``need_colsum_all``); CPU tensors run their plain versions.  Returns
    (out [B, H, S, D], PrefillScores).
    """
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out, m2, l2 = flash_prefill(q, k, v, true_len, window_size=window_size,
                                need_scores=need_colsum_all,
                                sliding_window=sliding_window)
    colsum_all = colsum_window = None
    if need_colsum_all:
        colsum_all = colsum_scores(q, k, true_len, m2, l2,
                                   window_size=window_size)
    if need_colsum_window:
        colsum_window = _window_colsum(q, k, true_len, window_size,
                                       1.0 / math.sqrt(q.shape[-1]))
    return out, PrefillScores(colsum_all=colsum_all,
                              colsum_window=colsum_window)


def prefill_scores_only(q: torch.Tensor, k: torch.Tensor,
                        true_len: torch.Tensor, *, window_size: int,
                        need_colsum_all: bool = False,
                        need_colsum_window: bool = False,
                        q_block: int = 256) -> PrefillScores:
    """The eviction scores of :func:`prefill_attention` without its output:
    chunked prefill's finalize pass, where every key exists.  The scoring
    softmax lets earlier queries see later keys (the reference's quirk), so
    it cannot run chunk by chunk.  q, k: [B, H, S, D] roped.

    CUDA tensors: ``colsum_all`` from the scored ``flash_prefill`` (its
    attention output, over V = K, is discarded) and ``colsum_scores``, the
    monolithic prefill's scoring pair.  CPU tensors: the JAX package's
    blocked form (``q_block`` query rows at a time, a float32 softmax per
    block, block sums added in order).  SnapKV's ``colsum_window`` is
    :func:`_window_colsum` on both."""
    B, H, S, D = q.shape
    w = window_size
    scale = 1.0 / math.sqrt(D)
    colsum_all = colsum_window = None
    if need_colsum_all and q.device.type == "cpu":
        colsum_all = _blocked_colsum(q, k, true_len, w, scale, q_block)
    elif need_colsum_all:
        q, k = q.contiguous(), k.contiguous()
        _, m2, l2 = flash_prefill(q, k, k, true_len, window_size=w,
                                  need_scores=True)
        colsum_all = colsum_scores(q, k, true_len, m2, l2, window_size=w)
    if need_colsum_window:
        colsum_window = _window_colsum(q, k, true_len, w, scale)
    return PrefillScores(colsum_all=colsum_all, colsum_window=colsum_window)


def _blocked_colsum(q: torch.Tensor, k: torch.Tensor, true_len: torch.Tensor,
                    w: int, scale: float, q_block: int) -> torch.Tensor:
    """H2O column sums, ``q_block`` query rows at a time, as the JAX
    package's ``prefill_scores_only`` sums them: [B, H, S] float32."""
    B, H, S, D = q.shape
    dev = q.device
    q_block = min(q_block, S)
    while S % q_block:
        q_block //= 2
    kv_idx = torch.arange(S, device=dev)
    tl = true_len.to(device=dev, dtype=torch.long)[:, None, None]
    key_real = kv_idx[None, None, :] < tl                        # [B, 1, S]
    colsum = torch.zeros((B, H, S), dtype=torch.float32, device=dev)
    kf = k.float()
    for q0 in range(0, S, q_block):
        q_idx = q0 + torch.arange(q_block, device=dev)
        logits = torch.einsum("bhqd,bhkd->bhqk",
                              q[:, :, q0:q0 + q_block].float(), kf) * scale
        in_tail = ((q_idx[None, :, None] >= tl - w)
                   & (kv_idx[None, None, :] >= tl - w)
                   & (kv_idx[None, None, :] > q_idx[None, :, None]))
        score_mask = key_real & ~in_tail                          # [B, qb, S]
        probs = torch.softmax(torch.where(score_mask[:, None], logits,
                                          NEG_INF), dim=-1)
        row_real = (q_idx[None, :] < tl[:, :, 0])[:, None, :, None]
        colsum = colsum + (probs * row_real).sum(dim=2)
    return colsum


def _window_colsum(q: torch.Tensor, k: torch.Tensor, true_len: torch.Tensor,
                   w: int, scale: float) -> torch.Tensor:
    """SnapKV observation-window scores: the float32 softmax of the last w
    real query rows over the keys (causal, pad keys masked), summed over
    those rows.  q, k: [B, H, S, D] -> [B, H, S] float32."""
    B, H, S, D = q.shape
    dev = q.device
    tl = true_len.to(device=dev, dtype=torch.long)
    kv_idx = torch.arange(S, device=dev)
    # The last w real queries of each (right-padded) row.
    row_pos = (tl[:, None] - w + torch.arange(w, device=dev)).clamp(0, S - 1)
    q_win = torch.gather(q, 2, row_pos[:, None, :, None].expand(B, H, w, D))
    logits = torch.einsum("bhqd,bhkd->bhqk", q_win.float(), k.float()) * scale
    # Causal in absolute positions, pad keys masked: for the last w rows
    # this is the reference's w x w tail mask.
    mask = (kv_idx <= row_pos[:, :, None]) & (kv_idx < tl[:, None, None])
    logits = torch.where(mask[:, None], logits, NEG_INF)
    return torch.softmax(logits, dim=-1).sum(dim=2)


def pool_scores(scores: torch.Tensor, kernel_size: int, pooling: str
                ) -> torch.Tensor:
    """1-D pooling over the key axis of [B, H, S] scores with stride 1 and
    padding kernel_size // 2: ``avg_pool1d`` semantics (the sum divided by
    kernel_size, zero pads included) or ``max_pool1d``'s, where the pads
    never win (scores are non-negative softmax sums).  The window is
    reduced left to right, one shifted slice at a time."""
    pad = kernel_size // 2
    if pooling == "avgpool":
        x, combine = F.pad(scores, (pad, pad)), torch.add
    elif pooling == "maxpool":
        x, combine = F.pad(scores, (pad, pad), value=NEG_INF), torch.maximum
    else:
        raise ValueError(f"pooling {pooling!r} not supported")
    n = x.shape[-1] - kernel_size + 1
    out = x[..., :n]
    for j in range(1, kernel_size):
        out = combine(out, x[..., j:j + n])
    return out / kernel_size if pooling == "avgpool" else out


def decode_attention(q: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, slot_mask: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token attention over the slotted cache.

    q: [B, H, 1, D]; cache_k/v: [B, H, S_max, D] (int8, or packed int4
    [..., D/2], with their scales already folded into q by the caller);
    slot_mask: [B, H, S_max] bool (True = valid slot).  Returns (out
    [B, H, 1, D] in the compute dtype: the cache's, or q's for a quantized
    cache; probs [B, H, S_max] float32): the probabilities double as the
    compression scores.  Logits and softmax are float32 (bf16 products and
    integer codes are exact in float32), the PV product runs in the
    compute dtype.
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    cd = cache_k.dtype if cache_k.dtype.is_floating_point else q.dtype
    logits = qk_einsum("bhqd,bhsd->bhqs", q, cache_k, cd, torch.float32)
    logits = logits * scale
    logits = torch.where(slot_mask[:, :, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = pv_einsum("bhqs,bhsd->bhqd", probs.to(cd), cache_v, cd)
    return out, probs[:, :, 0, :]
