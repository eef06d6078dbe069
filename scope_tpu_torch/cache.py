"""Static-shape slotted KV cache.

A fixed-capacity buffer per layer plus explicit length bookkeeping, laid
out as in the JAX package: slots [0, length) are valid and ordered
[compacted prefill | kept decode | recent window].  ``pvalid`` tracks a
per-head valid count inside the prefill segment; it only diverges from the
uniform length for the headwise method, whose prefill segment is a reserved
``prefill_gap`` of slots with decode tokens appended after it.

Unlike the JAX package's immutable arrays, the port updates ``k``/``v``
and ``length`` in place during decode (appends and block rewrites), which
saves a full-buffer copy per step.  The cache stores bf16/f32 values,
int8 values (``k_scale`` / ``v_scale`` per layer, row, head and channel)
or packed int4 codes (uint8, two per byte, with ``k_off`` / ``v_off``
zero points as well); ``ops/quant.py`` has the layouts.  Quest keeps the
per-page key extremes ``page_min`` / ``page_max``
(``compression/quest.py``): stored values for bf16/f32 and int8 caches,
unpacked codes (uint8, full head_dim) for int4.  The JAX package's
staging ring and lazy eviction (``alive`` mask, ``compact_lazy``) are not
ported: they dodge TPU costs, a buffer copy per in-place update and a
slow row gather, that the port's in-place CUDA writes and gathers do not
pay (ROADMAP §1 items 9 and 11).
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
    # Quantized caches: per-channel scales [L, B, H, D] float32 (int8 and
    # int4) and zero points (int4 only); None for bf16/f32 caches.
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None
    k_off: Optional[torch.Tensor] = None
    v_off: Optional[torch.Tensor] = None
    # Quest page metadata: per-channel min / max key of each chunk_size-slot
    # page, NP = capacity // chunk_size pages.  None for other methods.
    page_min: Optional[torch.Tensor] = None     # [L, B, H, NP, D]
    page_max: Optional[torch.Tensor] = None     # [L, B, H, NP, D]

    @property
    def capacity(self) -> int:
        return self.k.shape[3]

    def replace(self, **kw) -> "KVCache":
        return dataclasses.replace(self, **kw)


def init_cache(num_layers: int, batch: int, num_heads: int, capacity: int,
               head_dim: int, dtype: torch.dtype, device=None,
               kv_dtype: str = "bfloat16", prefill_gap: int = 0,
               num_pages: int = 0) -> KVCache:
    """An empty cache.  ``dtype`` is the compute dtype (bf16 or f32), which
    the cache stores unless ``kv_dtype`` is "int8" (int8 [..., D]) or
    "int4" (uint8 [..., D/2]); quantized caches start with unit scales and
    zero offsets.  ``prefill_gap``: the reserved prefill segment (headwise's
    ``headwise_max_budget``; 0 for the contiguous layout).  ``num_pages`` >
    0 adds Quest's page metadata, zeroed, in the stored dtype (uint8 codes
    at full head_dim for int4)."""
    if dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(f"compute dtype {dtype} is not supported")
    int8, int4 = kv_dtype == "int8", kv_dtype == "int4"
    store = torch.int8 if int8 else (torch.uint8 if int4 else dtype)
    dstore = head_dim // 2 if int4 else head_dim   # two codes per byte
    shape = (num_layers, batch, num_heads, capacity, dstore)
    sshape = (num_layers, batch, num_heads, head_dim)

    def ones():
        return torch.ones(sshape, dtype=torch.float32, device=device)

    def zeros():
        return torch.zeros(sshape, dtype=torch.float32, device=device)

    def pages():
        if not num_pages:
            return None
        return torch.zeros((num_layers, batch, num_heads, num_pages,
                            head_dim), dtype=store, device=device)
    return KVCache(
        k=torch.zeros(shape, dtype=store, device=device),
        v=torch.zeros(shape, dtype=store, device=device),
        length=torch.zeros((num_layers, batch), dtype=torch.int32,
                           device=device),
        pvalid=torch.zeros((num_layers, batch, num_heads), dtype=torch.int32,
                           device=device),
        prefill_gap=prefill_gap,
        prompt_len=torch.zeros((batch,), dtype=torch.int32, device=device),
        k_scale=ones() if int8 or int4 else None,
        v_scale=ones() if int8 or int4 else None,
        k_off=zeros() if int4 else None,
        v_off=zeros() if int4 else None,
        page_min=pages(),
        page_max=pages(),
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
