"""Static-shape slotted KV cache.

A fixed-capacity buffer per layer plus explicit length bookkeeping, laid
out as in the JAX package: slots [0, length) are valid and ordered
[compacted prefill | kept decode | recent window].  ``pvalid`` tracks a
per-head valid count inside the prefill segment; it only diverges from the
uniform length for the headwise method, which is not ported yet.

Unlike the JAX package's immutable arrays, the port updates ``k``/``v``
and ``length`` in place during decode (appends and block rewrites), which
saves a full-buffer copy per step.  bf16/f32 only: Quest pages and
quantization scales come in later slices.  The JAX package's staging ring
and lazy eviction (``alive`` mask, ``compact_lazy``) are not ported: they
dodge TPU costs, a buffer copy per in-place update and a slow row gather,
that the port's in-place CUDA writes and gathers do not pay (ROADMAP §1
items 9 and 11).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch


@dataclass
class KVCache:
    k: torch.Tensor                     # [L, B, H, S_max, D]
    v: torch.Tensor                     # [L, B, H, S_max, D]
    length: torch.Tensor                # [L, B] int32, physical filled length
    # Per-head valid count within the prefill segment [0, prefill_gap).
    pvalid: torch.Tensor                # [L, B, H] int32
    # Size of the reserved prefill segment: 0 for contiguous-layout methods.
    prefill_gap: int = 0
    # Recorded true prompt length (allkv gates).
    prompt_len: Optional[torch.Tensor] = None   # [B] int32

    @property
    def capacity(self) -> int:
        return self.k.shape[3]

    def replace(self, **kw) -> "KVCache":
        return dataclasses.replace(self, **kw)


def init_cache(num_layers: int, batch: int, num_heads: int, capacity: int,
               head_dim: int, dtype: torch.dtype, device=None) -> KVCache:
    if dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(
            f"cache dtype {dtype} is not ported yet (quantized KV: ROADMAP "
            f"§1 item 10)")
    shape = (num_layers, batch, num_heads, capacity, head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        length=torch.zeros((num_layers, batch), dtype=torch.int32,
                           device=device),
        pvalid=torch.zeros((num_layers, batch, num_heads), dtype=torch.int32,
                           device=device),
        prompt_len=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def slot_mask(length: torch.Tensor, pvalid: torch.Tensor, prefill_gap: int,
              capacity: int) -> torch.Tensor:
    """Validity mask per slot, per head.  length [B], pvalid [B, H] ->
    [B, H, S_max] bool."""
    idx = torch.arange(capacity, device=length.device)
    if prefill_gap == 0:
        valid = idx[None, :] < length[:, None]                  # [B, S]
        return valid[:, None, :].expand(pvalid.shape + (capacity,))
    in_prefill = idx[None, None, :] < pvalid[:, :, None]
    in_decode = ((idx[None, None, :] >= prefill_gap)
                 & (idx[None, :] < length[:, None])[:, None, :])
    return in_prefill | in_decode
