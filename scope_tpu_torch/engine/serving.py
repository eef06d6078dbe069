"""Continuous-batching serving engine.

The reference runs requests one at a time (eval_batch_size=1,
run_longgenbench.py:296).  This engine keeps a fixed pool of decode slots
busy: the native slot scheduler (``native/scheduler.cpp``) owns admission
and lifecycle, each admitted request is prefilled alone (B = 1, the prompt
in its bucket, through the two prefill kernels) and its cache row is
written into the pool, and all slots decode together, one batched step per
engine step.

Compression, two ways.  Where the host can mirror the gates
(``host_sched.host_schedulable``: fullkv, allkv, h2o, snapkv, streamingllm,
Quest and their method metrics), every slot has its own host mirror
(``compression/host_sched.HostScheduler``, or ``QuestHostScheduler`` per
layer), so each request fires on its own length and counters, as it would
alone.  A step where some slot fires is a force step whose per-row gate
holds exactly the firing slots ([L, B] for Quest: only the firing layers
of those slots); any other step is the hot step at the length bucket of
the longest live slot, and Quest's decode-region bucket of the longest
region (or a multi-step chunk of them when every slot is fire-free).
Elsewhere (pyramidkv, whose lengths differ per layer, and headwise) every
step runs ``decode_step``'s cond mode over the pool, the device's gates
with per-row ``SchedState`` counters (linear / jump), reset at each
admission.  Idle slots decode too; their tokens are dropped and their row
is rewritten at the next admission.

Chunked admission (``prefill_chunk=C``): an admitted prompt is
prefilled by ``models/chunked_prefill.ChunkedPrefiller``, one C-token
chunk per engine step, oldest admission first, so a long prompt delays
the running requests' decode by one chunk per step instead of a whole
prefill.  Its row joins the pool when its finalize pass has run.

Token fetches are pipelined: each dispatch starts a non-blocking copy of
its tokens to pinned host memory and records an event, and the host reads
a dispatch only after up to ``pipeline_depth`` newer ones are queued, so
the read overlaps the device's work.  EOS and budget detection lag by as
many dispatches; results are identical at every depth.

A port of the JAX package's ``engine/serving.py``.  Not ported yet, and
refused with the ROADMAP item that brings them: the sliding window and
qkv bias (item 13, Mistral and Qwen2) and meshes (item 15).  The staging
ring and lazy eviction are left out on purpose (items 9 and 11).
"""

from __future__ import annotations

import copy
import logging
import pickle
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from scope_tpu_torch.cache import KVCache, init_cache
from scope_tpu_torch.compression.host_sched import (HostScheduler,
                                                    host_schedulable)
from scope_tpu_torch.compression.schedulers import SchedState
from scope_tpu_torch.config import CompressionConfig, EngineConfig, ModelSpec
from scope_tpu_torch.device import resolve_device
from scope_tpu_torch.engine.generate import sample_logits_rowwise
from scope_tpu_torch.engine.host_loop import HostScheduledDecoder
from scope_tpu_torch.models import llama
from scope_tpu_torch.models.chunked_prefill import ChunkedPrefiller
from scope_tpu_torch.native import SlotScheduler

_CACHE_FIELDS = ("k", "v", "length", "pvalid", "prompt_len", "k_scale",
                 "v_scale", "k_off", "v_off", "page_min", "page_max")
# The cache fields a B = 1 prefill row carries into its pool slot.
_ROW_FIELDS = tuple(n for n in _CACHE_FIELDS if n != "prompt_len")


@dataclass
class _SlotState:
    request_id: int = -1
    prompt_len: int = 0
    max_new: int = 0
    tokens: List[int] = field(default_factory=list)
    active: bool = False
    # Tokens dispatched to the device (the prefill's first token included),
    # >= len(tokens) while fetches are in flight (pipeline_depth > 0).
    dispatched: int = 0


class ServingEngine:
    def __init__(self, spec: ModelSpec, comp: CompressionConfig,
                 ecfg: EngineConfig, params, max_slots: int = 4,
                 eos_ids: Tuple[int, ...] = (),
                 token_budget: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 max_top_k: int = 64,
                 pipeline_depth: int = 1,
                 mesh=None, device="cuda"):
        ok_metric = comp.decoding_metric in ("none", "fixed", "linear",
                                             "jump")
        # Method-specific metrics pair only with their own method.
        ok_metric = ok_metric or (comp.method, comp.decoding_metric) in (
            ("h2o", "h2o"), ("streamingllm", "slm"),
            ("pyramidkv", "pyramidinfer"))
        if not ok_metric:
            raise ValueError(
                f"serving does not support method={comp.method!r} with "
                f"decoding_metric={comp.decoding_metric!r}")
        if mesh is not None:
            raise NotImplementedError(
                "distributed serving comes with parallel/ (ROADMAP §1 item "
                "15)")
        llama._check_supported(spec, comp)
        self.spec, self.comp, self.ecfg = spec, comp, ecfg
        self.params = params
        self.device = resolve_device(device)
        self.max_slots = max_slots
        self.eos_ids = set(int(e) for e in eos_ids)
        self.sched = SlotScheduler(
            max_slots,
            token_budget or max_slots * (ecfg.max_prompt_len
                                         + ecfg.max_new_tokens))
        # Host mode where the gates can be mirrored per slot; otherwise the
        # device-cond path (_cond_decode).
        self._host_mode = host_schedulable(comp)
        self._hdec = (HostScheduledDecoder(spec, comp, ecfg)
                      if self._host_mode else None)
        self._quest = comp.method == "quest"
        self._slot_scheds: List[Optional[HostScheduler]] = [None] * max_slots
        # Chunked admission: admitted prompts waiting for their prefill,
        # oldest first, each advanced one chunk per engine step.
        self._chunker = (ChunkedPrefiller(spec, comp, ecfg,
                                          chunk_size=prefill_chunk)
                         if prefill_chunk is not None else None)
        self._pending_prefills: List[dict] = []
        st = llama.derive_statics(spec, comp, ecfg)
        self.cache: KVCache = init_cache(
            spec.num_layers, max_slots, st.cache_heads, st.capacity,
            spec.head_dim, llama._dtype(ecfg.dtype), self.device,
            kv_dtype=ecfg.kv_dtype,
            # Headwise's reserved prefill segment: the pool carries the
            # gap each admission's prefill cache has.
            prefill_gap=(comp.headwise_max_budget
                         if comp.method == "headwise" else 0),
            num_pages=(st.capacity // comp.chunk_size if self._quest
                       else 0))
        # Per-slot counters: each slot an independent linear / jump stream
        # (read by the device-cond path; host-scheduled decode reads none).
        self._per_row_state = comp.decoding_metric in ("linear", "jump")
        self.state = SchedState.init(
            self.device, batch=max_slots if self._per_row_state else 0)
        self.slots = [_SlotState() for _ in range(max_slots)]
        self.vpos = np.zeros(max_slots, np.int64)
        self.pipeline_depth = max(0, int(pipeline_depth))
        # The next step's input tokens, on the device: each dispatch's last
        # column, or an admission's first token.
        self._tok_dev = torch.zeros((max_slots,), dtype=torch.int32,
                                    device=self.device)
        # In flight: (tokens [B, k] on the host, the event after their copy
        # or None on the CPU, [(slot, request id)] active at dispatch).
        self._inflight: List[Tuple[torch.Tensor, Optional[torch.cuda.Event],
                                   List[Tuple[int, int]]]] = []
        self._pending_prompts: Dict[int, np.ndarray] = {}
        self.results: Dict[int, List[int]] = {}
        # Per-request latency: request_metrics[rid] = {queue_s, ttft_s,
        # tpot_s, total_s, n_tokens}.  TTFT counts from submit, queueing
        # included; TPOT is the mean interval over the fetched tokens.
        self.request_metrics: Dict[int, dict] = {}
        self._submit_ts: Dict[int, float] = {}
        self._admit_ts: Dict[int, float] = {}
        # Per-request sampling (greedy when temperature <= 0, the default).
        self.max_top_k = max_top_k
        self._samp: Dict[int, Tuple[float, int, float, int]] = {}
        self._samp_t = np.zeros(max_slots, np.float32)
        self._samp_k = np.zeros(max_slots, np.int32)
        self._samp_p = np.ones(max_slots, np.float32)
        self._samp_seed = np.zeros(max_slots, np.int64)

    # ------------------------------------------------------------------
    def submit(self, prompt_ids: np.ndarray, max_new: int,
               temperature: float = 0.0, top_k: int = 0,
               top_p: float = 1.0, seed: int = 0) -> int:
        """Queue a request; returns its id.

        temperature <= 0 decodes greedily.  top_k = 0 with top_p = 1
        samples the whole vocabulary; restricted rows draw among the
        ``max_top_k`` highest logits, and a top_k above that bound grows it
        (next power of two) instead of truncating the tail."""
        if not 0 < len(prompt_ids) <= self.ecfg.max_prompt_len:
            raise ValueError(f"prompt of {len(prompt_ids)} tokens; this "
                             f"engine takes 1 to {self.ecfg.max_prompt_len}")
        if max_new < 1:
            raise ValueError(f"max_new must be at least 1, not {max_new}")
        if top_k > self.max_top_k:
            new_cap = 1 << (int(top_k) - 1).bit_length()
            logging.getLogger(__name__).info(
                "growing sampler max_top_k %d -> %d for top_k=%d",
                self.max_top_k, new_cap, top_k)
            self.max_top_k = new_cap
        rid = self.sched.submit(len(prompt_ids), max_new)
        if rid < 0:
            raise RuntimeError("scheduler queue full")
        self._pending_prompts[rid] = np.asarray(prompt_ids, np.int32)
        self._submit_ts[rid] = time.perf_counter()
        if temperature > 0.0:
            self._samp[rid] = (temperature, top_k, top_p, seed)
        return rid

    def _sample(self, logits: torch.Tensor, seeds, counters, t, k, p
                ) -> torch.Tensor:
        any_unrestricted = bool(np.any((t > 0.0) & (k <= 0) & (p >= 1.0)))
        return sample_logits_rowwise(logits, seeds, counters, t, k, p,
                                     max_top_k=self.max_top_k,
                                     any_unrestricted=any_unrestricted)

    def _first_token(self, logits: torch.Tensor, rid: int, n_ids: int
                     ) -> int:
        t, k, p, seed = self._samp.get(rid, (0.0, 0, 1.0, 0))
        if t <= 0.0:
            return int(torch.argmax(logits, dim=-1)[0])
        tok = self._sample(logits, np.array([seed]), np.array([n_ids]),
                           np.array([t], np.float32), np.array([k]),
                           np.array([p], np.float32))
        return int(tok[0])

    # ------------------------------------------------------------------
    def _insert_row(self, slot: int, row: KVCache, tok0: int,
                    prompt_len: int):
        """Write a B = 1 prefill cache into the pool's row ``slot``, in
        place: K/V, lengths, pvalid, scales, offsets and Quest's pages."""
        c = self.cache
        for name in _ROW_FIELDS:
            dst = getattr(c, name)
            if dst is not None:
                dst[:, slot] = getattr(row, name)[:, 0]
        c.prompt_len[slot] = prompt_len
        self._tok_dev[slot] = tok0
        self.vpos[slot] = prompt_len
        if self._per_row_state:
            self.state = self.state.reset_row(slot)
        if self._host_mode:
            self._slot_scheds[slot] = self._hdec.new_scheduler(prompt_len)

    def _admit(self) -> bool:
        admitted = False
        while True:
            adm = self.sched.admit()
            if adm is None:
                return admitted
            slot, rid, prompt_len, max_new = adm
            # Queue wait ends here (slot granted); the prefill that follows
            # counts toward TTFT, not queueing.
            self._admit_ts[rid] = time.perf_counter()
            ids = self._pending_prompts.pop(rid)
            if self._chunker is not None:
                self._pending_prefills.append(
                    {"slot": slot, "rid": rid, "prompt_len": prompt_len,
                     "max_new": max_new, "ids": ids})
                admitted = True
                continue
            logits, row, _ = llama.prefill(self.spec, self.comp, self.ecfg,
                                           self.params, *self._prompt(ids))
            tok0 = self._first_token(logits, rid, len(ids))
            self._start_slot(slot, row, tok0, rid, prompt_len, max_new,
                             len(ids))
            admitted = True

    def _prompt(self, ids: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
        """(tokens [1, bucket], true_len [1]) on the device."""
        toks = np.zeros((1, self.ecfg.bucket_for(len(ids))), np.int32)
        toks[0, :len(ids)] = ids
        return (torch.from_numpy(toks).to(self.device),
                torch.tensor([len(ids)], dtype=torch.int32,
                             device=self.device))

    def _advance_prefill(self) -> bool:
        """Run one chunk of the oldest pending admission, starting its
        prefill (and its staging buffers) at its first chunk; its row joins
        the pool once its prefill is done.  Returns whether a chunk ran."""
        if not self._pending_prefills:
            return False
        p = self._pending_prefills[0]
        if "st" not in p:
            p["st"] = self._chunker.start(*self._prompt(p["ids"]))
        if not self._chunker.advance(self.params, p["st"]):
            logits, row, _ = self._chunker.finish(self.params, p["st"])
            n_ids = len(p["ids"])
            tok0 = self._first_token(logits, p["rid"], n_ids)
            self._pending_prefills.pop(0)
            self._start_slot(p["slot"], row, tok0, p["rid"],
                             p["prompt_len"], p["max_new"], n_ids)
        return True

    def _start_slot(self, slot, row, tok0, rid, prompt_len, max_new, n_ids):
        self._insert_row(slot, row, tok0, n_ids)
        now = time.perf_counter()
        t0 = self._submit_ts.get(rid, now)
        # The first token is host-visible here; queueing ended at _admit.
        self.request_metrics[rid] = {
            "queue_s": self._admit_ts.pop(rid, now) - t0,
            "ttft_s": now - t0}
        (self._samp_t[slot], self._samp_k[slot], self._samp_p[slot],
         self._samp_seed[slot]) = self._samp.get(rid, (0.0, 0, 1.0, 0))
        s = self.slots[slot]
        s.request_id, s.prompt_len, s.max_new = rid, prompt_len, max_new
        s.tokens = [tok0]
        s.dispatched = 1
        s.active = True
        if tok0 in self.eos_ids or max_new <= 1:
            self._finish(slot)

    def _finish(self, slot: int):
        s = self.slots[slot]
        self.results[s.request_id] = list(s.tokens)
        m = self.request_metrics.get(s.request_id)
        if m is not None:
            now = time.perf_counter()
            t0 = self._submit_ts.pop(s.request_id, now)
            # Clamped: a finish replayed after restore() can see clock
            # bases from before the recovery.
            m["total_s"] = max(now - t0, m["ttft_s"])
            m["n_tokens"] = len(s.tokens)
            m["tpot_s"] = ((m["total_s"] - m["ttft_s"])
                           / max(len(s.tokens) - 1, 1))
        self.sched.finish(slot)
        self._samp.pop(s.request_id, None)
        self._samp_t[slot] = 0.0
        s.active = False
        s.request_id = -1

    # ------------------------------------------------------------------
    def _host_decode(self, tok: torch.Tensor, vpos: torch.Tensor):
        """One step from the per-slot mirrors: the force step gated to the
        firing slots ([L, B] for Quest, whose plans fire per layer), or the
        hot step at the longest live slot's bucket."""
        shape = ((self.spec.num_layers, self.max_slots) if self._quest
                 else (self.max_slots,))
        n_keep = np.zeros(shape, np.int32)
        gate = np.zeros(shape, bool)
        needed = dec_needed = 1
        for slot, s in enumerate(self.slots):
            if not s.active:
                continue
            sched = self._slot_scheds[slot]
            plan = sched.plan_step()
            if self._quest:
                gate[:, slot] = plan.fire
                n_keep[:, slot] = plan.n_keep
                dec_needed = max(dec_needed, sched.dec_len)
            elif plan.fire:
                gate[slot] = True
                n_keep[slot] = plan.n_keep
            needed = max(needed, sched.length)
        if gate.any():
            return self._hdec.step_force(self.params, tok, vpos, self.cache,
                                         self.state, n_keep, gate)
        return self._hdec.step_off(self.params, tok, vpos, self.cache,
                                   self.state, self._hdec.bucket_for(needed),
                                   self._hdec.dec_bucket_for(dec_needed))

    def _cond_decode(self, tok: torch.Tensor, vpos: torch.Tensor):
        """One step of ``decode_step``'s cond mode over the pool: the
        device's gates, per-row counters.  Deciding whether a layer fires
        reads the device once per layer (``schedulers.block_rewrite``), as
        ``generate`` does; only configurations the host cannot mirror come
        here, so the dispatch's no-sync property holds in host mode only."""
        return llama.decode_step(self.spec, self.comp, self.ecfg,
                                 self.params, tok, vpos, self.cache,
                                 self.state)

    def _plan_chunk(self) -> int:
        """The largest chunk size n such that every active slot is fire-free
        for the next n steps and none reaches its budget inside them; 0 =
        one step.  No chunks on the device-cond path, while admissions wait
        or prefill (a chunk would delay them) or while a row samples
        (chunks decode greedily)."""
        sizes = sorted((n for n in self.ecfg.decode_chunk_sizes if n > 1),
                       reverse=True)
        if (not self._host_mode or not sizes or self.sched.queued > 0
                or self._pending_prefills or np.any(self._samp_t > 0.0)):
            return 0
        live = [i for i, s in enumerate(self.slots) if s.active]
        run = min(self._slot_scheds[i].hot_run_length(sizes[0])
                  for i in live)
        run = min(run, *(self.slots[i].max_new - self.slots[i].dispatched
                         for i in live))
        return next((n for n in sizes if n <= run), 0)

    def _dispatch(self):
        """Queue one decode step (or one hot chunk) for every slot and
        start the copy of its tokens to the host.  No host sync unless a
        row samples."""
        live = [i for i, s in enumerate(self.slots) if s.active]
        snap = [(i, self.slots[i].request_id) for i in live]
        tok = self._tok_dev
        vpos = torch.from_numpy(self.vpos.astype(np.int32)).to(
            self.device, non_blocking=True)
        n = self._plan_chunk()
        if n:
            needed = max(self._slot_scheds[i].length + n for i in live)
            dec_cap = (self._hdec.dec_bucket_for(max(
                self._slot_scheds[i].dec_len + n for i in live))
                if self._quest else None)
            toks_dev, self.cache, self.state = self._hdec.step_chunk(
                self.params, tok, vpos, self.cache, self.state, n,
                self._hdec.bucket_for(needed), dec_cap)
            for i in live:
                self._slot_scheds[i].advance_hot(n)
        else:
            n = 1
            decode = self._host_decode if self._host_mode else \
                self._cond_decode
            logits, self.cache, self.state = decode(tok, vpos)
            if np.any(self._samp_t > 0.0):
                toks_dev = self._sample(
                    logits, self._samp_seed, self.vpos + 1, self._samp_t,
                    self._samp_k, self._samp_p)[:, None]
            else:
                toks_dev = torch.argmax(logits, dim=-1).to(
                    torch.int32)[:, None]
        self._tok_dev = toks_dev[:, -1].clone()
        for i in live:
            self.slots[i].dispatched += n
            self.vpos[i] += n
        if toks_dev.is_cuda:
            host = torch.empty(toks_dev.shape, dtype=toks_dev.dtype,
                               pin_memory=True)
            host.copy_(toks_dev, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        else:
            host, event = toks_dev, None
        self._inflight.append((host, event, snap))

    def _process_one(self) -> bool:
        """Apply the OLDEST in-flight dispatch's tokens: append, EOS and
        budget finishes.  Rows whose request ended (or whose slot was
        re-admitted) since that dispatch are skipped."""
        if not self._inflight:
            return False
        host, event, snap = self._inflight.pop(0)
        if event is not None:
            event.synchronize()
        nxt = host.numpy()                                   # [B, k]
        for j in range(nxt.shape[1]):
            for slot, rid in snap:
                s = self.slots[slot]
                if not s.active or s.request_id != rid:
                    continue
                tok_j = int(nxt[slot, j])
                s.tokens.append(tok_j)
                hit_cap = self.sched.step(slot)
                if (tok_j in self.eos_ids or hit_cap
                        or len(s.tokens) >= s.max_new):
                    self._finish(slot)
        return True

    @torch.inference_mode()
    def step(self) -> bool:
        """Admit what fits, run one chunk of a pending admission's prefill
        (chunked admission), dispatch one batched decode step (or one hot
        chunk, ``ecfg.decode_chunk_sizes``, when every slot is fire-free),
        then apply the dispatches older than ``pipeline_depth``.  Returns
        whether anything was done."""
        self._admit()
        prefilled = self._advance_prefill()
        if not any(s.active for s in self.slots):
            drained = False
            while self._inflight:
                drained = self._process_one() or drained
            return prefilled or drained
        self._dispatch()
        while len(self._inflight) > self.pipeline_depth:
            self._process_one()
        return True

    # ------------------------------------------------------------------
    # Fail-stop recovery: a host snapshot of the engine (device buffers
    # copied to the host, the host mirrors, the native scheduler's bytes);
    # on a failure, restore it and go on.  Completed requests keep their
    # results, requests in flight resume from the snapshot, and requests
    # submitted after it are replayed from their prompts (recover()).

    def snapshot(self) -> dict:
        """Host-side snapshot.  Drains in-flight fetches first so the host
        state is consistent with the device buffers."""
        while self._inflight:
            self._process_one()
        cache = {n: (getattr(self.cache, n).cpu().clone()
                     if getattr(self.cache, n) is not None else None)
                 for n in _CACHE_FIELDS}
        return {
            "cache": cache,
            "prefill_gap": self.cache.prefill_gap,
            "state": {n: getattr(self.state, n).cpu().clone()
                      for n in ("step", "jump_step", "jump_layer")},
            "tok_dev": self._tok_dev.cpu().clone(),
            "slots": copy.deepcopy(self.slots),
            "vpos": self.vpos.copy(),
            "results": {k: list(v) for k, v in self.results.items()},
            "samp": dict(self._samp),
            "samp_arrays": (self._samp_t.copy(), self._samp_k.copy(),
                            self._samp_p.copy(), self._samp_seed.copy()),
            "slot_scheds": pickle.dumps(self._slot_scheds),
            "native_sched": self.sched.snapshot(),
            "pending_prompts": {k: v.copy()
                                for k, v in self._pending_prompts.items()},
            "max_top_k": self.max_top_k,
            # Admissions waiting for (or in) their chunked prefill; one
            # under way restarts from its first chunk.
            "pending_prefills": [
                {k: (v.copy() if k == "ids" else v) for k, v in p.items()
                 if k != "st"} for p in self._pending_prefills],
            # Latency bookkeeping travels too: a replayed finish must not
            # recompute totals from a missing submit time.
            "request_metrics": copy.deepcopy(self.request_metrics),
            "submit_ts": dict(self._submit_ts),
            "admit_ts": dict(self._admit_ts),
        }

    def restore(self, snap: dict):
        """Rebuild the engine's state from :meth:`snapshot` (a fresh engine
        or this one)."""
        dev = self.device
        self.cache = KVCache(
            **{n: (t.to(dev) if t is not None else None)
               for n, t in snap["cache"].items()},
            prefill_gap=snap["prefill_gap"])
        self.state = SchedState(**{n: t.to(dev)
                                   for n, t in snap["state"].items()})
        self._tok_dev = snap["tok_dev"].to(dev)
        self.slots = copy.deepcopy(snap["slots"])
        self.vpos = snap["vpos"].copy()
        self.results = {k: list(v) for k, v in snap["results"].items()}
        self._samp = dict(snap["samp"])
        (self._samp_t, self._samp_k, self._samp_p,
         self._samp_seed) = [a.copy() for a in snap["samp_arrays"]]
        # Unpickles only what this engine's snapshot() wrote.
        self._slot_scheds = pickle.loads(snap["slot_scheds"])
        self.sched.restore(snap["native_sched"])
        self._pending_prompts = {k: v.copy()
                                 for k, v in snap["pending_prompts"].items()}
        self.max_top_k = snap["max_top_k"]
        self._pending_prefills = [
            {k: (v.copy() if k == "ids" else v) for k, v in p.items()}
            for p in snap["pending_prefills"]]
        self.request_metrics = copy.deepcopy(snap["request_metrics"])
        self._submit_ts = dict(snap["submit_ts"])
        self._admit_ts = dict(snap["admit_ts"])
        self._inflight = []

    def recover(self, snap: dict, resubmit: dict) -> Dict[int, int]:
        """Restore the snapshot, then replay the requests submitted after
        it (``resubmit``: rid -> (prompt_ids, max_new)).  Returns the new
        id of each replayed request."""
        self.restore(snap)
        return {old_rid: self.submit(np.asarray(ids), max_new)
                for old_rid, (ids, max_new) in resubmit.items()}

    def run(self, max_steps: int = 1_000_000, snapshot_every: int = 0,
            max_recoveries: int = 0) -> Dict[int, List[int]]:
        """Run until the queue and all slots drain.

        snapshot_every > 0 keeps a rolling snapshot every N steps; with
        max_recoveries > 0 a failing step restores the last snapshot and
        goes on (the steps since it are recomputed) instead of raising."""
        snap = None
        recoveries = 0
        steps = 0
        while steps < max_steps:
            if snapshot_every and steps % snapshot_every == 0:
                snap = self.snapshot()
            try:
                progressed = self.step()
            except Exception:
                if snap is None or recoveries >= max_recoveries:
                    raise
                recoveries += 1
                logging.getLogger(__name__).warning(
                    "serving step failed; restoring the last snapshot "
                    "(recovery %d/%d)", recoveries, max_recoveries,
                    exc_info=True)
                self.restore(snap)
                progressed = True
            if not progressed and self.sched.queued == 0:
                break
            steps += 1
        while self._inflight:
            self._process_one()
        return self.results
