"""Host-orchestrated decode loop.

The host mirrors the (deterministic) SCOPE gates and counters
(``compression/host_sched.py``) and runs per step either the hot step
(``decode_step(compress_mode="off")``: no scheduler, no eviction
probabilities, no host sync) or the force step (an unconditional rewrite
keeping the host's count).  Fire-free stretches may run as one
``decode_steps`` chunk.  Token-identical to cond mode
(tests/test_torch_host_sched.py, tests/test_torch_layered_host.py).
PyramidKV's layers keep different prefill counts, so its mirror
(``LayeredHostScheduler``) tracks every layer's length and a force step
gets [L, B] gates: only the layers that fire rewrite.  Quest's mirror
(``QuestHostScheduler``) is per layer too (its skip layers never fire), and
its hot steps bound the decode-region view with a bucket ladder of their
own (``dec_bucket_for``).  The serving engine
(``engine/serving.py``) drives the same three programs (:meth:`step_off`,
:meth:`step_force` with per-row gates, :meth:`step_chunk`) from per-slot
mirrors.  The JAX package's lazy eviction and its host-run compaction are
not ported (ROADMAP §1 item 11).

The JAX package jit-compiles one program per (length bucket, chunk size);
here a "program" is the call with that ``attn_cap`` / ``n_steps``.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple, Union

import numpy as np
import torch

from scope_tpu_torch.cache import KVCache
from scope_tpu_torch.compression.host_sched import (HostScheduler,
                                                    LayeredHostScheduler,
                                                    QuestHostScheduler,
                                                    host_schedulable,
                                                    host_schedulable_layered)
from scope_tpu_torch.compression.schedulers import SchedState
from scope_tpu_torch.config import CompressionConfig, EngineConfig, ModelSpec
from scope_tpu_torch.device import resolve_device
from scope_tpu_torch.models import llama


class HostScheduledDecoder:
    """Decode steps planned on the host for one configuration; each
    request gets its own mirror from :meth:`new_scheduler`."""

    def __init__(self, spec: ModelSpec, comp: CompressionConfig,
                 ecfg: EngineConfig):
        llama._check_supported(spec, comp)
        self.layered = host_schedulable_layered(comp)
        self.quest = comp.method == "quest"
        if not (host_schedulable(comp) or self.layered):
            raise ValueError(
                f"{comp.method}+{comp.decoding_metric} needs the device "
                f"scheduler; use decode_step(compress_mode='cond')")
        self.spec, self.comp, self.ecfg = spec, comp, ecfg
        st = llama.derive_statics(spec, comp, ecfg)
        self.capacity = st.capacity
        self._keep_cap = min(st.caps.keep_cap, st.capacity)
        # Length buckets: hot steps attend over the smallest bucket that
        # covers the cache length, so a cache far below capacity (a short
        # prompt, or fullkv early on) does not pay full-capacity attention.
        self.buckets = _ladder(self.capacity)
        # Quest's decode region grows from 0 toward max_new_tokens: its own
        # ladder, so early steps attend a small slice of it.
        self.dec_buckets = _ladder(ecfg.max_new_tokens + 1)

    def bucket_for(self, needed: int) -> int:
        """The slots a hot step attends over when the cache holds
        ``needed``."""
        return _fit(self.buckets, needed)

    def dec_bucket_for(self, needed: int) -> Optional[int]:
        """Quest's decode-region view when the longest region holds
        ``needed`` tokens (None for other methods).  With
        ``quest_decode_pages`` attention reads the selected pages whatever
        the region's length, so one bucket serves every step."""
        if not self.quest:
            return None
        if self.comp.quest_decode_pages > 0:
            return self.dec_buckets[0]
        return _fit(self.dec_buckets, needed)

    def _dec_bucket(self, sched, ahead: int = 0) -> Optional[int]:
        return (self.dec_bucket_for(sched.dec_len + ahead) if self.quest
                else None)

    def new_scheduler(self, prompt_len: int,
                      prompt_pad: Optional[int] = None
                      ) -> Union[HostScheduler, LayeredHostScheduler,
                                 QuestHostScheduler]:
        """A mirror for one request of ``prompt_len`` tokens, padded to
        ``prompt_pad`` (default: its bucket), which decides whether
        pyramidkv's prefill compressed."""
        comp = self.comp
        if self.layered:
            pad = (prompt_pad if prompt_pad is not None
                   else self.ecfg.bucket_for(prompt_len))
            return LayeredHostScheduler(comp, self.spec.num_layers,
                                        prompt_len, pad, self._keep_cap,
                                        self.capacity)
        if self.quest:
            return QuestHostScheduler(comp, self.spec.num_layers,
                                      prompt_len, self._keep_cap)
        if comp.method in ("fullkv", "allkv"):
            kept = prompt_len
        else:
            kept = min(comp.max_capacity_prompt, prompt_len)
        return HostScheduler(comp, self.spec.num_layers, prompt_len, kept,
                             self._keep_cap, capacity=self.capacity)

    def step_off(self, params, tok: torch.Tensor, vpos: torch.Tensor,
                 cache: KVCache, state: SchedState, attn_cap: int,
                 dec_cap: Optional[int] = None
                 ) -> Tuple[torch.Tensor, KVCache, SchedState]:
        """The hot step: append and attend over the first ``attn_cap``
        slots (Quest: its dense layers; its decode region over ``dec_cap``),
        no compression.  Returns (logits [B, V], cache, state)."""
        return llama.decode_step(self.spec, self.comp, self.ecfg, params,
                                 tok, vpos, cache, state, compress_mode="off",
                                 attn_cap=attn_cap, quest_dec_cap=dec_cap)

    def step_force(self, params, tok: torch.Tensor, vpos: torch.Tensor,
                   cache: KVCache, state: SchedState, n_keep, row_gate=None
                   ) -> Tuple[torch.Tensor, KVCache, SchedState]:
        """The force step over the whole capacity: the rows of ``row_gate``
        (all when None) rewrite keeping ``n_keep`` tokens, both [B] or, per
        layer, [L, B].  Both may be host arrays: they go to the device
        without a host sync."""
        dev = tok.device
        n_keep = _to_device(n_keep, torch.int32, dev)
        if row_gate is not None:
            row_gate = _to_device(row_gate, torch.bool, dev)
        return llama.decode_step(self.spec, self.comp, self.ecfg, params,
                                 tok, vpos, cache, state,
                                 compress_mode="force", force_n_keep=n_keep,
                                 force_row_gate=row_gate)

    def step_chunk(self, params, tok: torch.Tensor, vpos: torch.Tensor,
                   cache: KVCache, state: SchedState, n: int, attn_cap: int,
                   dec_cap: Optional[int] = None
                   ) -> Tuple[torch.Tensor, KVCache, SchedState]:
        """``n`` greedy hot steps over the first ``attn_cap`` slots (and
        Quest's ``dec_cap``), the tokens kept on the device.  Returns
        (tokens [B, n], cache, state)."""
        return llama.decode_steps(self.spec, self.comp, self.ecfg, params,
                                  tok, vpos, cache, state, n_steps=n,
                                  attn_cap=attn_cap, quest_dec_cap=dec_cap)

    def step(self, sched, params, tok: torch.Tensor, vpos: torch.Tensor,
             cache: KVCache, state: SchedState
             ) -> Tuple[torch.Tensor, KVCache, SchedState]:
        """One decode step: the force step where the mirror fires (on the
        firing layers only, for a layered or Quest mirror), else the hot
        step at the bucket of the longest layer.  Returns (logits [B, V],
        cache, state)."""
        plan = sched.plan_step()
        B = tok.shape[0]
        per_layer = self.layered or self.quest
        if per_layer and plan.fire_any:
            gate = np.repeat(np.asarray(plan.fire, bool)[:, None], B, axis=1)
            n_keep = np.repeat(np.asarray(plan.n_keep, np.int32)[:, None], B,
                               axis=1)
            return self.step_force(params, tok, vpos, cache, state, n_keep,
                                   gate)
        if not per_layer and plan.fire:
            return self.step_force(params, tok, vpos, cache, state,
                                   np.full((B,), plan.n_keep, np.int32))
        return self.step_off(params, tok, vpos, cache, state,
                             self.bucket_for(sched.length),
                             self._dec_bucket(sched))

    def step_auto(self, sched, params, tok: torch.Tensor,
                  vpos: torch.Tensor, cache: KVCache, state: SchedState
                  ) -> Tuple[torch.Tensor, KVCache, SchedState]:
        """Advance 1..max(chunk sizes) decode steps, running a fire-free
        stretch as one ``decode_steps`` chunk (``ecfg.decode_chunk_sizes``,
        largest first; empty = always per step).  Returns (tokens [B, k]
        on the device, cache, state); the LAST column is the next step's
        input token."""
        sizes = sorted((s for s in self.ecfg.decode_chunk_sizes if s > 1),
                       reverse=True)
        if sizes:
            run = sched.hot_run_length(sizes[0])
            for n in sizes:
                if n <= run:
                    toks, cache, state = self.step_chunk(
                        params, tok, vpos, cache, state, n,
                        self.bucket_for(sched.length + n),
                        self._dec_bucket(sched, n))
                    sched.advance_hot(n)
                    return toks, cache, state
        logits, cache, state = self.step(sched, params, tok, vpos, cache,
                                         state)
        return (torch.argmax(logits, dim=-1).to(torch.int32)[:, None], cache,
                state)


def _ladder(top: int) -> Tuple[int, ...]:
    """Buckets 512, 1024, ... below ``top``, then ``top``."""
    out, b = [], 512
    while b < top:
        out.append(b)
        b *= 2
    return tuple(out) + (top,)


def _fit(buckets: Tuple[int, ...], needed: int) -> int:
    """The smallest bucket that holds ``needed`` (the last if none does)."""
    return next((b for b in buckets if needed <= b), buckets[-1])


def _to_device(x, dtype: torch.dtype, dev: torch.device) -> torch.Tensor:
    """A host array or a tensor as ``dtype`` on ``dev``; a host array is
    staged in pinned memory and copied without waiting (non_blocking), so
    no host sync is made (a copy from pageable memory may wait for the
    stream)."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x)).to(dtype=dtype)
        if dev.type == "cuda":
            x = x.pin_memory()
    return x.to(dtype=dtype).to(dev, non_blocking=True)


@torch.inference_mode()
def host_generate(spec: ModelSpec, comp: CompressionConfig,
                  ecfg: EngineConfig, params, tokens: np.ndarray,
                  true_len: np.ndarray, max_new: int,
                  eos_ids: Tuple[int, ...] = (), device="cuda"
                  ) -> Tuple[np.ndarray, dict]:
    """Greedy generation with host scheduling; batch rows must share one
    prompt length (the host mirrors a single length stream).

    Returns (tokens [B, n] int32, stats): ``ttft_s``, ``tpot_s`` (tokens
    of one chunk share its end time), and, for checking the mirror, its
    final per-layer ``mirror_lengths`` (and their largest,
    ``mirror_length``) beside the cache's per-layer ``cache_length`` after
    ``decode_steps`` steps (a last chunk may run past ``max_new``)."""
    if len(set(int(t) for t in true_len)) != 1:
        raise ValueError("host scheduling needs uniform prompt lengths")
    dev = resolve_device(device)
    dec = HostScheduledDecoder(spec, comp, ecfg)
    t0 = time.perf_counter()
    tl = torch.as_tensor(np.asarray(true_len), dtype=torch.int32, device=dev)
    logits, cache, state = llama.prefill(
        spec, comp, ecfg, params,
        torch.as_tensor(np.asarray(tokens), device=dev), tl)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    out = [tok.cpu().numpy()]
    timestamps = [time.perf_counter()]
    sched = dec.new_scheduler(int(true_len[0]),
                              prompt_pad=np.asarray(tokens).shape[1])
    eos = list(set(int(e) for e in eos_ids))
    done = np.isin(out[0], eos)
    s = 0
    while len(out) < max_new and not done.all():
        toks, cache, state = dec.step_auto(sched, params, tok, tl + s,
                                           cache, state)
        arr = toks.cpu().numpy()                          # [B, k]
        t_now = time.perf_counter()
        for j in range(arr.shape[1]):
            if len(out) >= max_new or done.all():
                break
            timestamps.append(t_now)
            out.append(arr[:, j])
            done |= np.isin(arr[:, j], eos)
        tok = toks[:, -1]
        s += arr.shape[1]
    stats = {
        "ttft_s": timestamps[0] - t0,
        "tpot_s": [timestamps[i] - (timestamps[i - 1] if i else t0)
                   for i in range(len(timestamps))],
        "mirror_length": sched.length,
        "mirror_lengths": list(getattr(sched, "lengths",
                                       [sched.length] * spec.num_layers)),
        "cache_length": cache.length[:, 0].tolist(),
        "decode_steps": s,
    }
    return np.stack(out, axis=1), stats

