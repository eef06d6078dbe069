"""Where a cond-mode decode step of the PyTorch port goes, on one CUDA card.

    python3 scripts/torch_decode_breakdown.py [--seed N]

Llama-3.2-1B at full width and depth with random bf16 weights, the
configuration of chip_smoke.py (H2O prefill of a 3000-token prompt in the
4096 bucket, SCOPE jump decode), for each eviction granularity:

- host time per step of the cond path (``decode_step`` reads each layer's
  scheduler gate on the host) against the same steps with the scheduler off
  (``decoding_metric="none"``: no scheduler, no per-layer sync), both from
  the same cache just after prefill, in alternating pairs of windows
  (median and quartiles: host times on a shared machine are noisy).  No
  wave fires in these windows (the first fires at decode step 293);
- the device's busy share of the cond steps under ``torch.profiler``
  (device kernel time over wall time; the profiler's own overhead lowers
  it).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

STEPS = 16        # decode steps per timed window
PAIRS = 6         # alternating (scheduler off, cond) pairs of windows


def run(spec, comp, ecfg, params, snap, steps):
    """Host ms per decode step over ``steps`` steps from a copy of snap."""
    from scope_tpu_torch.models import llama
    cache, state, tok, vpos = snap
    cache = cache.replace(k=cache.k.clone(), v=cache.v.clone(),
                          length=cache.length.clone())
    state = state.replace()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for i in range(steps):
        logits, cache, state = llama.decode_step(
            spec, comp, ecfg, params, tok, vpos + i, cache, state)
        tok = logits.argmax(-1).to(torch.int32)
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3 / steps


def prepare(spec, comp, ecfg, params, toks, tl):
    """(cache, state, first token, position) just after prefill."""
    from scope_tpu_torch.models import llama
    tt = torch.as_tensor(toks, device="cuda")
    ttl = torch.as_tensor(tl, device="cuda")
    logits, cache, state = llama.prefill(spec, comp, ecfg, params, tt, ttl)
    return cache, state, logits.argmax(-1).to(torch.int32), ttl


def timed(spec, comp, ecfg, params, snap):
    """Host ms per step of cond and scheduler-off windows, alternating."""
    off = comp.replace(decoding_metric="none")
    run(spec, comp, ecfg, params, snap, 2)              # warm-up
    run(spec, off, ecfg, params, snap, 2)
    cond_ms, off_ms = [], []
    for i in range(PAIRS):                              # off, cond, cond, off
        order = ((off, off_ms), (comp, cond_ms))
        for c, out in order[::1 - 2 * (i % 2)]:
            out.append(run(spec, c, ecfg, params, snap, STEPS))
    return cond_ms, off_ms


def busy_share(spec, comp, ecfg, params, snap):
    """Device kernel time over wall time of cond steps, under the profiler."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_ms = run(spec, comp, ecfg, params, snap, STEPS) * STEPS
    dev_us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    return f"{dev_us / 1e3 / wall_ms:.3f}" if dev_us > 0 else "not measured"


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
    from scope_tpu_torch.models import llama
    print(card_line(), flush=True)
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
    times = [timed(spec, c, ecfg, params, sn) for c, sn in zip(comps, snaps)]
    busy = [busy_share(spec, c, ecfg, params, sn)
            for c, sn in zip(comps, snaps)]
    for c, (cond_ms, off_ms), b in zip(comps, times, busy):
        (cm, ctext), (om, otext) = stats(cond_ms), stats(off_ms)
        print(f"decode breakdown {spec.name} evict_per_qhead="
              f"{c.evict_per_qhead}, {PAIRS} pairs of {STEPS}-step windows: "
              f"cond step {ctext}, scheduler off {otext}; scheduler + "
              f"{spec.num_layers} host syncs {cm - om:.2f} ms per step "
              f"(median difference); device busy share of cond steps under "
              f"the profiler {b}", flush=True)


if __name__ == "__main__":
    main()
