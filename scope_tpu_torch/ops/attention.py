"""Attention paths: prefill attention with fused H2O score capture, and
masked decode attention over the static slotted cache.

Prefill reaches the two hand-written Hopper kernels of
:mod:`scope_tpu_torch.ops.flash_prefill` for CUDA tensors (their plain
versions for CPU tensors).  Decode attention is plain torch ops, as it is
XLA einsums in the JAX package: its probabilities double as the decode
eviction scores.

Score semantics follow the JAX package exactly, including the reference's
quirk of applying a causal mask only to the trailing ``w x w`` block of the
scoring softmax: earlier queries attend to *future* keys in the score pass.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from scope_tpu_torch.ops.flash_prefill import (NEG_INF, colsum_scores,
                                               flash_prefill)
from scope_tpu_torch.ops.quant import pv_einsum, qk_einsum


class PrefillScores(NamedTuple):
    """Per-key accumulated eviction scores from the prefill pass."""

    # Column sums of the full-query scoring softmax (H2O semantics).
    # float32 [B, H, S].
    colsum_all: Optional[torch.Tensor]
    # SnapKV's observation-window column sums; not ported yet (None).
    colsum_window: Optional[torch.Tensor]


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      true_len: torch.Tensor, *, window_size: int,
                      need_colsum_all: bool = False,
                      sliding_window: Optional[int] = None
                      ) -> Tuple[torch.Tensor, PrefillScores]:
    """Causal attention over the full (uncompressed) prompt + score capture.

    q, k, v: [B, H, S, D] (roped, GQA-expanded).  true_len: [B] int count of
    real (non-pad) tokens; prompts are right-padded to S.  CUDA tensors run
    the ``flash_prefill`` and ``colsum_scores`` kernels; CPU tensors run
    their plain versions.  Returns (out [B, H, S, D], PrefillScores).
    """
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out, m2, l2 = flash_prefill(q, k, v, true_len, window_size=window_size,
                                need_scores=need_colsum_all,
                                sliding_window=sliding_window)
    colsum_all = None
    if need_colsum_all:
        colsum_all = colsum_scores(q, k, true_len, m2, l2,
                                   window_size=window_size)
    return out, PrefillScores(colsum_all=colsum_all, colsum_window=None)


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
