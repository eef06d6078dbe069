"""Where a decode step of the PyTorch port goes, on one CUDA card.

    python3 scripts/torch_decode_breakdown.py [--seed N]

Llama-3.2-1B at full width and depth with random bf16 weights, the
configuration of chip_smoke.py (H2O prefill of a 3000-token prompt in the
4096 bucket, SCOPE jump decode), for each eviction granularity, from the
same cache just after prefill:

- host time per step of the cond path (``decode_step`` reads each layer's
  scheduler gate on the host) against the same steps with the scheduler off
  (``decoding_metric="none"``: no scheduler, no per-layer sync);
- the host-scheduled path (``engine/host_loop.py``): its hot step at the
  length bucket the host picks, and the per-token cost of a 16-step
  ``decode_steps`` chunk;

all in windows of 16 steps that take turns, the order reversed every round
(median and quartiles: host times on a shared machine are noisy).  No wave
fires in these windows (the first fires at decode step 293).  Then:

- one force step, the first wave's (decode step 293), from a copy of the
  cache the host path left just before it (median of REPS);
- the device's busy share of cond steps and of hot steps under
  ``torch.profiler`` (device kernel time over wall time; the profiler's own
  overhead lowers it);
- where the host's length buckets act: a short prompt (SHORT tokens, per-kv-
  head eviction), whose cache stays far below the 2688-slot capacity, in
  hot steps at the host's bucket against the same steps over the whole
  capacity: host ms per step in windows that take turns, and device ms per
  step under the profiler.
"""

from __future__ import annotations

import argparse
import copy
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

STEPS = 16        # decode steps per timed window (one chunk of CHUNK)
ROUNDS = 6        # rounds of windows, each round every kind once
CHUNK = 16        # steps of one decode_steps chunk
REPS = 6          # force steps timed
FIRST_WAVE = 293  # decode step of the first jump wave
SHORT = 600       # real tokens of the short prompt (1024-token bucket)


def clone(snap):
    """A copy of (cache, state, token, position) that a run may change."""
    cache, state, tok, vpos = snap
    cache = cache.replace(
        k=cache.k.clone(), v=cache.v.clone(), length=cache.length.clone())
    return cache, state.replace(), tok, vpos


def run(spec, comp, ecfg, params, snap, steps):
    """Host ms per cond-mode decode step over ``steps`` steps from a copy
    of snap."""
    from scope_tpu_torch.models import llama
    cache, state, tok, vpos = clone(snap)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for i in range(steps):
        logits, cache, state = llama.decode_step(
            spec, comp, ecfg, params, tok, vpos + i, cache, state)
        tok = logits.argmax(-1).to(torch.int32)
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3 / steps


def run_host(spec, comp, ecfg, params, snap, steps, n_prompt, chunk=0):
    """Host ms per step over ``steps`` host-scheduled steps from a copy of
    snap: hot steps one at a time at the host's bucket, or, with chunk,
    ``decode_steps`` chunks of that many steps."""
    from scope_tpu_torch.engine.host_loop import HostScheduledDecoder
    dec = HostScheduledDecoder(spec, comp, ecfg.replace(
        decode_chunk_sizes=(chunk,) if chunk else ()))
    cache, state, tok, vpos = clone(snap)
    sched = dec.new_scheduler(n_prompt)
    torch.cuda.synchronize()
    t = time.perf_counter()
    s = 0
    while s < steps:
        out, cache, state = dec.step_auto(sched, params, tok, vpos + s,
                                          cache, state)
        tok, s = out[:, -1], s + out.shape[1]
    torch.cuda.synchronize()
    if chunk and s != steps:
        sys.exit(f"a window ran {s} steps, not chunks of {chunk}")
    return (time.perf_counter() - t) * 1e3 / s


def prepare(spec, comp, ecfg, params, toks, tl):
    """(cache, state, first token, position) just after prefill."""
    from scope_tpu_torch.models import llama
    tt = torch.as_tensor(toks, device="cuda")
    ttl = torch.as_tensor(tl, device="cuda")
    logits, cache, state = llama.prefill(spec, comp, ecfg, params, tt, ttl)
    return cache, state, logits.argmax(-1).to(torch.int32), ttl


def timed(spec, comp, ecfg, params, snap, n_prompt):
    """Host ms per step of each kind of window, taking turns."""
    off = comp.replace(decoding_metric="none")
    kinds = {
        "off": lambda n: run(spec, off, ecfg, params, snap, n),
        "cond": lambda n: run(spec, comp, ecfg, params, snap, n),
        "hot": lambda n: run_host(spec, comp, ecfg, params, snap, n,
                                  n_prompt),
        "chunk": lambda n: run_host(spec, comp, ecfg, params, snap, n,
                                    n_prompt, CHUNK),
    }
    for fn in kinds.values():                           # warm-up
        fn(CHUNK)
    out = {k: [] for k in kinds}
    for i in range(ROUNDS):
        for k in list(kinds)[::1 - 2 * (i % 2)]:
            out[k].append(kinds[k](STEPS))
    return out


def force_ms(spec, comp, ecfg, params, snap, n_prompt):
    """Host ms of the first wave's force step (all layers rewrite their
    block), each from a copy of the cache just before it."""
    from scope_tpu_torch.engine.host_loop import HostScheduledDecoder
    dec = HostScheduledDecoder(spec, comp, ecfg)
    cache, state, tok, vpos = clone(snap)
    sched = dec.new_scheduler(n_prompt)
    for s in range(FIRST_WAVE):
        logits, cache, state = dec.step(sched, params, tok, vpos + s, cache,
                                        state)
        tok = logits.argmax(-1).to(torch.int32)
    if sched.hot_run_length(1) != 0:
        sys.exit(f"decode step {FIRST_WAVE} does not fire")
    before = (cache, state, tok, vpos + FIRST_WAVE)
    times = []
    for _ in range(REPS + 1):                           # the first warms up
        c, st, tk, vp = clone(before)
        sc = copy.copy(sched)
        torch.cuda.synchronize()
        t = time.perf_counter()
        dec.step(sc, params, tk, vp, c, st)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        if sc.length >= sched.length + 1:
            sys.exit("the force step did not shrink the cache")
    return times[1:]


def profiled(window):
    """(device kernel ms per step, its share of the wall time) of one
    window under the profiler, or None where the profiler saw no device
    time; window() returns its host ms per step over STEPS steps."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_ms = window() * STEPS
    dev_us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    if dev_us <= 0:
        return None
    return dev_us / 1e3 / STEPS, dev_us / 1e3 / wall_ms


def busy_share(window):
    got = profiled(window)
    return "not measured" if got is None else f"{got[1]:.3f}"


def run_off(spec, comp, ecfg, params, snap, steps, attn_cap):
    """Host ms per hot step (``compress_mode="off"``) over ``steps`` steps
    from a copy of snap, attending over ``attn_cap`` slots (None: all)."""
    from scope_tpu_torch.models import llama
    cache, state, tok, vpos = clone(snap)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for i in range(steps):
        logits, cache, state = llama.decode_step(
            spec, comp, ecfg, params, tok, vpos + i, cache, state,
            compress_mode="off", attn_cap=attn_cap)
        tok = logits.argmax(-1).to(torch.int32)
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3 / steps


def buckets(spec, comp, ecfg, params, seed):
    """Hot steps of a SHORT-token prompt at the host's bucket against the
    whole capacity: (bucket, capacity, host ms per step of each kind's
    windows, device (ms per step, share) of each under the profiler)."""
    from scope_tpu_torch.engine.host_loop import HostScheduledDecoder
    S = ecfg.bucket_for(SHORT)
    toks = np.zeros((1, S), np.int32)
    toks[0, :SHORT] = np.random.default_rng(seed + 1).integers(
        1, spec.vocab_size, SHORT)
    tl = np.array([SHORT], np.int32)
    snap = prepare(spec, comp, ecfg, params, toks, tl)
    dec = HostScheduledDecoder(spec, comp, ecfg)
    sched = dec.new_scheduler(SHORT)
    if sched.hot_run_length(STEPS) != STEPS:
        sys.exit("the short prompt's first steps fire")
    bucket = dec.bucket_for(sched.length + STEPS)
    kinds = {"bucket": bucket, "full": None}
    for cap in kinds.values():                          # warm-up
        run_off(spec, comp, ecfg, params, snap, STEPS, cap)
    host = {k: [] for k in kinds}
    for i in range(ROUNDS):
        for k in list(kinds)[::1 - 2 * (i % 2)]:
            host[k].append(run_off(spec, comp, ecfg, params, snap, STEPS,
                                   kinds[k]))
    device = {k: profiled(lambda: run_off(spec, comp, ecfg, params, snap,
                                          STEPS, cap))
              for k, cap in kinds.items()}
    return bucket, dec.capacity, host, device


def stats(x):
    q1, med, q3 = np.percentile(x, [25, 50, 75])
    return med, f"{med:.2f} ms (quartiles {q1:.2f}-{q3:.2f})"


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script measures the port on a card")
    from chip_smoke import card_line, main_config
    from scope_tpu_torch.engine.host_loop import HostScheduledDecoder
    from scope_tpu_torch.models import llama
    card = card_line()
    print(card, flush=True)
    spec, comp, ecfg, n_prompt = main_config()
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    params = llama.init_params(spec, g, torch.bfloat16, device="cuda")
    S = ecfg.bucket_for(n_prompt)
    toks = np.zeros((1, S), np.int32)
    toks[0, :n_prompt] = np.random.default_rng(args.seed).integers(
        1, spec.vocab_size, n_prompt)
    tl = np.array([n_prompt], np.int32)
    comps = [comp.replace(evict_per_qhead=q) for q in (True, False)]
    snaps = [prepare(spec, c, ecfg, params, toks, tl) for c in comps]
    # Every timed window first: the profiler may slow later launches.
    times = [timed(spec, c, ecfg, params, sn, n_prompt)
             for c, sn in zip(comps, snaps)]
    forces = [force_ms(spec, c, ecfg, params, sn, n_prompt)
              for c, sn in zip(comps, snaps)]
    busy = [(busy_share(lambda: run(spec, c, ecfg, params, sn, STEPS)),
             busy_share(lambda: run_host(spec, c, ecfg, params, sn, STEPS,
                                         n_prompt)))
            for c, sn in zip(comps, snaps)]
    del snaps
    bucket_case = buckets(spec, comps[1], ecfg, params, args.seed)
    for c, t, f, (bc, bh) in zip(comps, times, forces, busy):
        (cm, ctext), (om, otext) = stats(t["cond"]), stats(t["off"])
        (hm, htext), (km, ktext) = stats(t["hot"]), stats(t["chunk"])
        dec = HostScheduledDecoder(spec, c, ecfg)
        bucket = dec.bucket_for(dec.new_scheduler(n_prompt).length + 1)
        name = f"{spec.name} evict_per_qhead={c.evict_per_qhead}"
        print(f"decode breakdown {name}, {ROUNDS} rounds of {STEPS}-step "
              f"windows: cond step {ctext}, scheduler off {otext}; scheduler "
              f"+ {spec.num_layers} host syncs {cm - om:.2f} ms per step "
              f"(median difference); device busy share of cond steps under "
              f"the profiler {bc}; card {card}", flush=True)
        print(f"host-scheduled decode {name}: hot step at the host's bucket "
              f"({bucket} of {dec.capacity} slots) {htext} = "
              f"{1e3 / hm:.1f} tok/s; per token of a {CHUNK}-step "
              f"decode_steps chunk {ktext} = {1e3 / km:.1f} tok/s; force "
              f"step at decode step {FIRST_WAVE} {stats(f)[1]} over {REPS}; "
              f"host syncs per hot or force step 0; device busy share of "
              f"hot steps under the profiler {bh}; card {card}", flush=True)

    bucket, cap, host, device = bucket_case

    def dev(k):
        return ("not measured" if device[k] is None else
                f"{device[k][0]:.3f} ms (busy share {device[k][1]:.3f})")
    print(f"length buckets {spec.name} evict_per_qhead=False, a {SHORT}-token "
          f"prompt (cache {SHORT + 1}..{SHORT + STEPS} slots): hot step at "
          f"the host's bucket ({bucket} slots) {stats(host['bucket'])[1]}, "
          f"over the whole capacity ({cap} slots) {stats(host['full'])[1]}; "
          f"device time per step under the profiler {dev('bucket')} against "
          f"{dev('full')}; card {card}", flush=True)


if __name__ == "__main__":
    main()
