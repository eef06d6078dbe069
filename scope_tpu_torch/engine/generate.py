"""Generation loops over the compression-aware model, and the samplers.

- :func:`generate` is the counterpart of the JAX package's
  ``generate_scan``: the same prefill, decode steps and eos / ``done_step``
  semantics, as a Python loop over ``decode_step``.
- :class:`StreamingGenerator` is a host loop with per-token wall-clock
  timestamps (TTFT / TPOT), for one request at a time.  Like the JAX
  package's, it takes the host-scheduled decoder (``engine/host_loop.py``:
  no per-layer host sync) for every method and metric whose gates the host
  can mirror, per layer for pyramidkv and Quest, and cond mode otherwise
  (headwise, allkv with the h2o metric).

The two decode paths give identical tokens (tests/test_torch_host_sched.py).
:func:`sample_logits` and :func:`sample_logits_rowwise` are the sampling
heads; the serving engine (``engine/serving.py``) draws per row.
"""

from __future__ import annotations

import time
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from scope_tpu_torch.compression.host_sched import (host_schedulable,
                                                    host_schedulable_layered)
from scope_tpu_torch.config import CompressionConfig, EngineConfig, ModelSpec
from scope_tpu_torch.device import resolve_device
from scope_tpu_torch.engine.host_loop import HostScheduledDecoder
from scope_tpu_torch.models import llama


class GenerateResult(NamedTuple):
    tokens: np.ndarray          # [B, max_new] generated ids (eos-padded)
    gen_lengths: np.ndarray     # [B] tokens up to and including eos
    ttft_s: float
    tpot_s: List[float]


def sample_logits(logits: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  temperature: float = 0.0, top_k: int = 0,
                  top_p: float = 1.0) -> torch.Tensor:
    """Greedy (temperature <= 0: the first maximum on ties, as
    ``jnp.argmax``) or temperature / top-k / top-p sampling, drawing from
    ``generator`` (a CPU ``torch.Generator``; the noise is copied to the
    logits' device).  The reference only decodes greedily (do_sample=False,
    run_longgenbench.py:236).  logits: [B, V] -> [B] int32."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits.float() / temperature
    if top_k and top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, -torch.inf, logits)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        csum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # Keep tokens until the cumulative mass exceeds top_p (at least 1).
        cutoff_idx = (csum < top_p).sum(dim=-1, keepdim=True)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = torch.where(logits < cutoff, -torch.inf, logits)
    u = torch.rand(logits.shape, generator=generator)
    return _gumbel_argmax(logits, u.to(logits.device, non_blocking=True))


def _gumbel_argmax(logits: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """A categorical draw from ``logits`` by the Gumbel-max trick, with
    uniform noise ``u`` in [0, 1) of the same shape."""
    g = -torch.log(-torch.log(u.clamp(min=1e-20, max=1.0 - 1e-7)))
    return torch.argmax(logits + g, dim=-1).to(torch.int32)


def _row_noise(seed: int, counter: int, width: int) -> torch.Tensor:
    """Uniform noise of one row's draw, keyed by (seed, position) alone, so
    a request draws the same tokens in whichever slot it sits, on the CPU
    and on the card alike."""
    # The CPU generator keeps 32 bits of its seed: mix (seed, counter)
    # into them rather than pack them side by side.
    key = np.random.SeedSequence([int(seed) & 0xFFFFFFFF,
                                  int(counter) & 0xFFFFFFFF])
    g = torch.Generator().manual_seed(int(key.generate_state(1)[0]))
    return torch.rand((width,), generator=g)


def sample_logits_rowwise(logits: torch.Tensor, seeds, counters,
                          temperature, top_k, top_p, max_top_k: int = 64,
                          any_unrestricted: bool = True) -> torch.Tensor:
    """Per-row sampling for continuous batching: each row carries its own
    (temperature, top_k, top_p, seed); rows with temperature <= 0 decode
    greedily.

    The per-row parameters and ``counters`` (the position being drawn) are
    host arrays of [B].  Sampled rows draw among their ``max_top_k``
    highest logits (a static width that keeps the top_k / top_p masks
    shape-stable; larger top_k values are clamped); with
    ``any_unrestricted``, rows with top_k = 0 and top_p >= 1 draw from the
    whole vocabulary instead.  Each draw uses a CPU ``torch.Generator``
    keyed by (seed, counter), so it is deterministic per (seed, position)
    and independent of the slot; it cannot equal the JAX package's
    threefry draws.  logits: [B, V] -> [B] int32 on logits' device."""
    temperature = np.array(temperature, np.float32)
    top_k = np.array(top_k, np.int64)
    top_p = np.array(top_p, np.float32)
    seeds, counters = np.asarray(seeds), np.asarray(counters)
    B, V = logits.shape
    dev = logits.device
    K = min(max_top_k, V)
    lg = logits.float()
    greedy = torch.argmax(lg, dim=-1).to(torch.int32)
    sampled_rows = temperature > 0.0
    if not sampled_rows.any():
        return greedy

    vals, idx = torch.topk(lg, K, dim=-1)                 # [B, K] descending
    t = torch.from_numpy(np.maximum(temperature, 1e-6)[:, None]).to(dev)
    v = vals / t
    j = torch.arange(K, device=dev)[None, :]
    k_eff = np.where(top_k > 0, np.minimum(top_k, K), K)[:, None]
    v = torch.where(j < torch.from_numpy(k_eff).to(dev), v, -torch.inf)
    csum = torch.cumsum(torch.softmax(v, dim=-1), dim=-1)
    # Keep candidates until the cumulative mass exceeds top_p (at least 1).
    cutoff = (csum < torch.from_numpy(top_p[:, None]).to(dev)).sum(
        dim=-1, keepdim=True)
    v = torch.where(j <= cutoff, v, -torch.inf)
    noise = torch.full((B, K), 0.5)            # greedy rows: never read
    unrestricted = sampled_rows & (top_k <= 0) & (top_p >= 1.0)
    if not any_unrestricted:
        unrestricted[:] = False
    for b in np.flatnonzero(sampled_rows & ~unrestricted):
        noise[b] = _row_noise(seeds[b], counters[b], K)
    choice = _gumbel_argmax(v, noise.to(dev, non_blocking=True))
    out = torch.gather(idx, 1, choice[:, None].long())[:, 0].to(torch.int32)
    for b in np.flatnonzero(unrestricted):
        row = lg[b] / float(max(temperature[b], 1e-6))
        out[b] = _gumbel_argmax(row, _row_noise(seeds[b], counters[b], V)
                                .to(dev, non_blocking=True))
    return torch.where(torch.from_numpy(sampled_rows).to(dev), out, greedy)


@torch.inference_mode()
def generate(spec: ModelSpec, comp: CompressionConfig, ecfg: EngineConfig,
             params, tokens, true_len, max_new: int, eos_id: int,
             device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy generation.  tokens: [B, S_pad] right-padded; true_len: [B].

    Returns (generated [B, max_new] int32, done_step [B] int32: one past
    the index of the first eos, or max_new).  Rows that hit eos keep
    feeding eos_id, as ``generate_scan`` does."""
    dev = resolve_device(device)
    tokens = torch.as_tensor(np.asarray(tokens), device=dev)
    true_len = torch.as_tensor(np.asarray(true_len), device=dev,
                               dtype=torch.int32)
    logits, cache, state = llama.prefill(spec, comp, ecfg, params, tokens,
                                         true_len)
    tok = sample_logits(logits)
    done = tok == eos_id
    out = [tok]
    for s in range(max_new - 1):
        logits, cache, state = llama.decode_step(
            spec, comp, ecfg, params, tok, true_len + s, cache, state)
        nxt = sample_logits(logits)
        nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
        done = done | (nxt == eos_id)
        tok = nxt
        out.append(tok)
    generated = torch.stack(out, dim=1)                       # [B, max_new]
    eos_mask = generated == eos_id
    first_eos = torch.argmax(eos_mask.to(torch.int32), dim=1)
    done_step = torch.where(eos_mask.any(dim=1), first_eos + 1,
                            torch.full_like(first_eos, max_new))
    return generated, done_step.to(torch.int32)


class StreamingGenerator:
    """Host-side decode loop with per-token timing (reference TTFT/TPOT)."""

    def __init__(self, spec: ModelSpec, comp: CompressionConfig,
                 ecfg: EngineConfig, params, eos_ids: Tuple[int, ...],
                 device="cuda"):
        self.spec, self.comp, self.ecfg = spec, comp, ecfg
        self.params = params
        self.eos_ids = set(int(e) for e in eos_ids)
        self.device = resolve_device(device)
        # Host-orchestrated scheduling where the gates are deterministic:
        # the hot step then carries no compression logic and no host sync.
        # None: the path this generator decodes on is cond mode.
        self.host_decoder = (
            HostScheduledDecoder(spec, comp, ecfg)
            if host_schedulable(comp) or host_schedulable_layered(comp)
            else None)

    @torch.inference_mode()
    def generate(self, tokens: np.ndarray, true_len: np.ndarray,
                 max_new: int) -> GenerateResult:
        if tokens.shape[0] != 1:
            raise ValueError("the streaming path is per-request (B = 1)")
        t0 = time.perf_counter()
        toks = torch.as_tensor(np.asarray(tokens), device=self.device)
        tl = torch.as_tensor(np.asarray(true_len), device=self.device,
                             dtype=torch.int32)
        logits, cache, state = llama.prefill(self.spec, self.comp, self.ecfg,
                                             self.params, toks, tl)
        tok = int(sample_logits(logits)[0])        # waits for the device
        timestamps = [time.perf_counter()]
        out = [tok]
        done = tok in self.eos_ids
        s = 0
        sched = (self.host_decoder.new_scheduler(int(true_len[0]),
                                                 prompt_pad=tokens.shape[1])
                 if self.host_decoder is not None else None)
        while not done and len(out) < max_new:
            tok_arr = torch.full((1,), tok, dtype=torch.int32,
                                 device=self.device)
            if sched is not None:
                logits, cache, state = self.host_decoder.step(
                    sched, self.params, tok_arr, tl + s, cache, state)
            else:
                logits, cache, state = llama.decode_step(
                    self.spec, self.comp, self.ecfg, self.params, tok_arr,
                    tl + s, cache, state)
            tok = int(sample_logits(logits)[0])
            timestamps.append(time.perf_counter())
            out.append(tok)
            done = tok in self.eos_ids
            s += 1
        ttft = timestamps[0] - t0
        tpot = [timestamps[i] - (timestamps[i - 1] if i else t0)
                for i in range(len(timestamps))]
        arr = np.full((1, max_new),
                      next(iter(self.eos_ids)) if self.eos_ids else 0,
                      np.int32)
        arr[0, :len(out)] = out
        return GenerateResult(tokens=arr, gen_lengths=np.array([len(out)]),
                              ttft_s=ttft, tpot_s=tpot)
