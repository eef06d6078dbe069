"""Chunked (incremental) prefill.

Runs the prompt through the model in fixed-size chunks instead of one
pass.  The serving engine uses it for chunked admission: an admission's
prefill advances one C-token chunk between decode steps, so a long prompt
stalls the running requests by one chunk at a time instead of a whole
prefill.

Each chunk runs every layer for its C positions, appends its roped K/V
(and Q, for the methods that score: h2o, pyramidkv, snapkv, headwise) to
per-layer staging buffers and attends its C queries over the staged keys
through ``prefill_attention``: on the card the same ``flash_prefill``
kernel (``need_scores=False``) that the monolithic prefill runs, its
queries placed at their rows of an S-row buffer and its true_len cut to
c0 + C.  Causal rows depend only on their own query and the keys before
them, so the chunk's rows get the monolithic prefill's attention.
The compression runs once, in :meth:`ChunkedPrefiller.finish`, over the
whole prompt: the reference's scoring softmax lets every query see later
keys, so scores cannot accumulate chunk by chunk.  The finalize pass scores
the staged Q against the staged K with
:func:`scope_tpu_torch.ops.attention.prefill_scores_only` (on the card the
scored ``flash_prefill`` and ``colsum_scores`` kernels), compresses and
quantizes each layer as ``llama.prefill`` does, and builds Quest's page
metadata.

A port of the JAX package's ``models/chunked_prefill.py``, where chunk
attention and the monolithic prefill are both XLA einsums; here both are
the kernel, so chunked prefill's tokens and cache follow the monolithic
prefill's (tests/test_torch_chunked_prefill.py).  Each chunk's kernel call
computes the rows before c0 again and discards them: a causal attention
over c0 + C rows per layer.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from scope_tpu_torch.cache import KVCache, init_cache
from scope_tpu_torch.compression import quest
from scope_tpu_torch.compression.policies import compress_prefill
from scope_tpu_torch.compression.schedulers import SchedState
from scope_tpu_torch.config import CompressionConfig, EngineConfig, ModelSpec
from scope_tpu_torch.models import llama
from scope_tpu_torch.ops.attention import (PrefillScores, prefill_attention,
                                           prefill_scores_only)
from scope_tpu_torch.ops.common import (repeat_kv, rms_norm, rope_cos_sin,
                                        rope_inv_freq)


def _needs_staged_q(comp: CompressionConfig) -> bool:
    return comp.method in ("h2o", "pyramidkv", "snapkv", "headwise")


class ChunkedPrefiller:
    """Incremental prefill for one configuration: :meth:`start` a prompt,
    :meth:`advance` it one chunk at a time until it reports done, then
    :meth:`finish` it.  Calling the object runs all three."""

    def __init__(self, spec: ModelSpec, comp: CompressionConfig,
                 ecfg: EngineConfig, chunk_size: int = 512):
        llama._check_supported(spec, comp)
        if spec.sliding_window is not None:
            raise NotImplementedError(
                "chunked prefill with a sliding window comes with Mistral "
                "(ROADMAP §1 item 13, PR 7)")
        self.spec, self.comp, self.ecfg = spec, comp, ecfg
        self.chunk_size = chunk_size
        self.need_q = _needs_staged_q(comp)

    def chunk_layout(self, S: int) -> int:
        """The chunk length for a prompt bucket of S: chunk_size, halved
        until it divides S."""
        C = min(self.chunk_size, S)
        while S % C:
            C //= 2
        return C

    @torch.inference_mode()
    def start(self, tokens: torch.Tensor, true_len: torch.Tensor) -> dict:
        """Begin a prefill of tokens [B, S] (right-padded, on the
        parameters' device) with true_len [B]; returns its state."""
        spec, comp = self.spec, self.comp
        B, S = tokens.shape
        L, D, E = spec.num_layers, spec.head_dim, spec.hidden_size
        Hc = spec.num_heads if comp.evict_per_qhead else spec.num_kv_heads
        dtype = llama._dtype(self.ecfg.dtype)
        dev = tokens.device
        tl = true_len.to(device=dev, dtype=torch.int32)

        def buf(H):
            return torch.zeros((L, B, H, S, D), dtype=dtype, device=dev)
        return {
            "tokens": tokens, "true_len": tl,
            "tmax": int(np.max(true_len.cpu().numpy())),
            "c0": 0, "C": self.chunk_layout(S), "S": S,
            "kbuf": buf(Hc), "vbuf": buf(Hc),
            "qbuf": buf(spec.num_heads) if self.need_q else None,
            "h_last": torch.zeros((B, E), dtype=dtype, device=dev),
        }

    @torch.inference_mode()
    def advance(self, params, st: dict) -> bool:
        """Run one chunk; returns True while more chunks remain.  Chunks
        past every row's true_len are skipped."""
        c0, C, S = st["c0"], st["C"], st["S"]
        if c0 >= min(S, st["tmax"]):
            return False
        self._chunk(params, st)
        st["c0"] = c0 + C
        return st["c0"] < min(S, st["tmax"])

    def _chunk(self, params, st: dict) -> None:
        """All layers for positions [c0, c0 + C): stage roped K/V (and Q),
        attend the chunk's queries over the staged keys, and keep the final
        hidden state of each row's last real token."""
        spec, comp = self.spec, self.comp
        c0, C = st["c0"], st["C"]
        tl = st["true_len"]
        G = spec.num_kv_groups
        D = spec.head_dim
        dev = tl.device
        B = tl.shape[0]
        inv_freq = rope_inv_freq(D, spec.rope_theta, spec.rope_scaling, dev)
        pos = c0 + torch.arange(C, device=dev)
        cos, sin = rope_cos_sin(pos.expand(B, C), inv_freq)
        # Rows past c0 + C are not computed; keys past it are masked, as
        # causality masks them for the chunk's rows.
        tl_c = tl.clamp(max=c0 + C)
        x = params["embed"][st["tokens"][:, c0:c0 + C].long()].to(
            st["kbuf"].dtype)
        for l in range(spec.num_layers):
            p = llama._layer(params, l)
            q, k, v = llama.layer_qkv(spec, p, x, cos, sin)
            if comp.evict_per_qhead:
                k, v = repeat_kv(k, G), repeat_kv(v, G)
            st["kbuf"][l, :, :, c0:c0 + C] = k
            st["vbuf"][l, :, :, c0:c0 + C] = v
            if self.need_q:
                st["qbuf"][l, :, :, c0:c0 + C] = q
            k_att, v_att = st["kbuf"][l], st["vbuf"][l]
            if not comp.evict_per_qhead:
                k_att, v_att = repeat_kv(k_att, G), repeat_kv(v_att, G)
            q_rows = torch.zeros_like(k_att)
            q_rows[:, :, c0:c0 + C] = q
            out, _ = prefill_attention(q_rows, k_att, v_att, tl_c,
                                       window_size=comp.window_size)
            x = llama.layer_post(spec, p, x, out[:, :, c0:c0 + C])
        last = tl.long() - 1
        in_chunk = (last >= c0) & (last < c0 + C)
        idx = (last - c0).clamp(0, C - 1)
        h_c = x[torch.arange(B, device=dev), idx]
        st["h_last"] = torch.where(in_chunk[:, None], h_c, st["h_last"])

    @torch.inference_mode()
    def finish(self, params, st: dict
               ) -> Tuple[torch.Tensor, KVCache, SchedState]:
        """Score the staged prompt, compress and quantize each layer into a
        fresh cache, build Quest's pages: ``llama.prefill``'s compression
        tail.  Returns (last-token logits [B, V], cache, scheduler
        state)."""
        spec, comp, ecfg = self.spec, self.comp, self.ecfg
        st_ = llama.derive_statics(spec, comp, ecfg)
        L, G = spec.num_layers, spec.num_kv_groups
        tl = st["true_len"]
        B = tl.shape[0]
        dev = tl.device
        need_all = comp.method in ("h2o", "pyramidkv")
        need_win = comp.method == "snapkv"
        gap = comp.headwise_max_budget if comp.method == "headwise" else 0
        cache = init_cache(L, B, st_.cache_heads, st_.capacity,
                           spec.head_dim, st["kbuf"].dtype, dev,
                           kv_dtype=ecfg.kv_dtype, prefill_gap=gap)
        cache.prompt_len = tl.clone()
        for l in range(L):
            kb, vb = st["kbuf"][l], st["vbuf"][l]
            qb = st["qbuf"][l] if self.need_q else kb
            sc = PrefillScores(None, None)
            if need_all or need_win:
                k_sc = kb if comp.evict_per_qhead else repeat_kv(kb, G)
                sc = prefill_scores_only(
                    qb, k_sc, tl, window_size=comp.window_size,
                    need_colsum_all=need_all, need_colsum_window=need_win)
                if not comp.evict_per_qhead:
                    sc = sc._replace(
                        colsum_all=llama._group_scores(sc.colsum_all, G),
                        colsum_window=llama._group_scores(sc.colsum_window,
                                                          G))
            llama.store_prefill_layer(ecfg, cache, l, compress_prefill(
                comp, l, L, kb, vb, qb, sc, tl, st_.capacity))
        if comp.method == "quest":
            cache = quest.build_page_metadata(comp, cache, tl)
        h = rms_norm(st["h_last"], params["final_norm"], spec.rms_norm_eps)
        return llama._lm_logits(spec, params, h), cache, SchedState.init(dev)

    def __call__(self, params, tokens: torch.Tensor, true_len: torch.Tensor
                 ) -> Tuple[torch.Tensor, KVCache, SchedState]:
        st = self.start(tokens, true_len)
        while self.advance(params, st):
            pass
        return self.finish(params, st)


def prefill_chunked(spec: ModelSpec, comp: CompressionConfig,
                    ecfg: EngineConfig, params, tokens: torch.Tensor,
                    true_len: torch.Tensor, chunk_size: int = 512
                    ) -> Tuple[torch.Tensor, KVCache, SchedState]:
    """``llama.prefill``'s result, computed chunk by chunk."""
    return ChunkedPrefiller(spec, comp, ecfg, chunk_size)(params, tokens,
                                                          true_len)
