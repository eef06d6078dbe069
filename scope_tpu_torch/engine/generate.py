"""Greedy generation loops over the compression-aware model.

- :func:`generate` is the counterpart of the JAX package's
  ``generate_scan``: the same prefill, decode steps and eos / ``done_step``
  semantics, as a Python loop over ``decode_step``.
- :class:`StreamingGenerator` is a host loop with per-token wall-clock
  timestamps (TTFT / TPOT), for one request at a time.  Like the JAX
  package's, it takes the host-scheduled decoder (``engine/host_loop.py``:
  no per-layer host sync) for every method and metric whose gates the host
  can mirror, and cond mode otherwise.

The two decode paths give identical tokens (tests/test_torch_host_sched.py).
"""

from __future__ import annotations

import time
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from scope_tpu_torch.compression.host_sched import host_schedulable
from scope_tpu_torch.config import CompressionConfig, EngineConfig, ModelSpec
from scope_tpu_torch.device import resolve_device
from scope_tpu_torch.engine.host_loop import HostScheduledDecoder
from scope_tpu_torch.models import llama


class GenerateResult(NamedTuple):
    tokens: np.ndarray          # [B, max_new] generated ids (eos-padded)
    gen_lengths: np.ndarray     # [B] tokens up to and including eos
    ttft_s: float
    tpot_s: List[float]


def sample_logits(logits: torch.Tensor) -> torch.Tensor:
    """Greedy decoding: logits [B, V] -> [B] int32 (the first maximum on
    ties, as ``jnp.argmax``).  The reference only decodes greedily;
    sampling is a later slice (ROADMAP §1 item 12)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


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
        self.host_decoder = (HostScheduledDecoder(spec, comp, ecfg)
                             if host_schedulable(comp) else None)

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
        sched = (self.host_decoder.new_scheduler(int(true_len[0]))
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
