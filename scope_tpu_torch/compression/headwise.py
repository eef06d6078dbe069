"""Headwise: per-head adaptive prefill budgets from attention coverage.

A copy of the JAX package's ``compression/headwise.py``:

- budget_h = the number of tokens whose sorted last-query attention mass
  reaches coverage gamma, clamped to [min_budget, min(max_budget,
  true_len)];
- eviction keeps the top-budget_h tokens per head by last-query attention;
- layers below ``HEADWISE_SKIP_LAYERS`` are not compressed, up to the
  reserved segment.

Cache layout: the prefill segment is a reserved ``gap`` of
``headwise_max_budget`` slots; head h keeps its tokens compacted in
[0, budget_h) and decode tokens append at ``gap`` uniformly across heads
(:func:`scope_tpu_torch.cache.slot_mask`).

Per-kv-head eviction (``evict_per_qhead=False``), which the JAX package
cannot run here (its last-query product needs as many key heads as query
heads), averages each kv head's group of query heads into one
distribution and budgets that (ROADMAP §3).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from scope_tpu_torch.compression.policies import topk_indices
from scope_tpu_torch.config import CompressionConfig
from scope_tpu_torch.ops.attention import NEG_INF

HEADWISE_SKIP_LAYERS = 3   # layers 0..2 are not compressed


def coverage_budget(probs: torch.Tensor, gamma: float) -> torch.Tensor:
    """probs: [B, H, S] last-query attention row -> [B, H] int32 budget:
    1 + #{sorted-descending cumulative sum <= gamma}."""
    sorted_desc = torch.sort(probs, dim=-1, descending=True).values
    csum = torch.cumsum(sorted_desc, dim=-1)
    return ((csum <= gamma).sum(dim=-1) + 1).to(torch.int32)


def headwise_prefill_map(comp: CompressionConfig, q: torch.Tensor,
                         k: torch.Tensor, true_len: torch.Tensor,
                         capacity: int, layer_idx: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-head dest->src map of headwise prefill eviction.

    q: [B, Hq, S, D], k: [B, Hk, S, D] (roped; Hq a multiple of Hk).
    Returns (src [B, Hk, capacity] int64, pvalid [B, Hk] int32 per-head
    kept count)."""
    B, Hq, S, D = q.shape
    Hk = k.shape[1]
    gap = comp.headwise_max_budget
    dev = q.device
    tl = true_len.to(device=dev, dtype=torch.long)
    real = torch.arange(S, device=dev) < tl[:, None]                 # [B, S]

    # The last real query row of each batch row.
    last = (tl - 1).clamp(0, S - 1)
    q_last = torch.gather(q, 2, last[:, None, None, None].expand(B, Hq, 1, D))
    qg = q_last.reshape(B, Hk, Hq // Hk, D).float()
    logits = torch.einsum("bhgd,bhkd->bhgk", qg, k.float()) / math.sqrt(D)
    logits = torch.where(real[:, None, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).mean(dim=2)               # [B,Hk,S]

    budget = coverage_budget(probs, comp.headwise_gamma)
    budget = budget.clamp(comp.headwise_min_budget, gap)
    budget = torch.minimum(budget, tl[:, None].to(torch.int32))
    if layer_idx < HEADWISE_SKIP_LAYERS:
        # Early layers keep everything that fits in the reserved segment.
        budget = tl.clamp(max=gap).to(torch.int32)[:, None].expand(B, Hk)

    k_static = min(gap, S)
    topk = topk_indices(torch.where(real[:, None, :], probs, NEG_INF),
                        k_static)                                   # [B,Hk,ks]
    d = torch.arange(capacity, device=dev)
    src = torch.where(d < budget[..., None], topk[..., d.clamp(max=k_static - 1)],
                      torch.zeros_like(d))
    return src.clamp(0, S - 1), budget.contiguous()
