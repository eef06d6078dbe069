"""Where a warm prefill of the PyTorch port goes, on one CUDA card.

    python3 scripts/torch_prefill_breakdown.py [--seed N]

Llama-3.2-1B at full width and depth with random bf16 weights, the
configuration of chip_smoke.py (H2O prefill, P=2048, w=8, of a 3000-token
prompt in the 4096 bucket), for each eviction granularity:

- host time of a warm ``llama.prefill`` ending in a synchronise (median
  and quartiles of REPS runs after one warm-up);
- under ``torch.profiler``, one more prefill: device time by kernel, summed
  into the port's two prefill kernels (``flash_prefill``,
  ``colsum_scores``), matrix products, and everything else, beside the
  device's busy share (device kernel time over wall time; the profiler's
  own overhead lowers it).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REPS = 7
TOP = 12          # kernels listed by name


def prefill_ms(spec, comp, ecfg, params, tt, ttl):
    from scope_tpu_torch.models import llama
    torch.cuda.synchronize()
    t = time.perf_counter()
    llama.prefill(spec, comp, ecfg, params, tt, ttl)
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3


def group(name: str) -> str:
    """The part of the prefill a device kernel belongs to."""
    if "flash_prefill" in name:
        return "flash_prefill"
    if "colsum" in name:
        return "colsum_scores"
    if any(s in name.lower() for s in ("gemm", "xmma", "nvjet", "cutlass")):
        return "matrix products"
    return "other"


def profiled(spec, comp, ecfg, params, tt, ttl):
    """(wall ms, {kernel name: device ms}) of one profiled prefill."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = prefill_ms(spec, comp, ecfg, params, tt, ttl)
    dev = {e.key: e.self_device_time_total / 1e3 for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and e.self_device_time_total > 0}
    return wall, dev


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
    tt = torch.as_tensor(toks, device="cuda")
    ttl = torch.as_tensor([n_prompt], dtype=torch.int32, device="cuda")
    for per_qhead in (True, False):
        c = comp.replace(evict_per_qhead=per_qhead)
        prefill_ms(spec, c, ecfg, params, tt, ttl)              # warm-up
        ms = [prefill_ms(spec, c, ecfg, params, tt, ttl) for _ in range(REPS)]
        q1, med, q3 = np.percentile(ms, [25, 50, 75])
        wall, dev = profiled(spec, c, ecfg, params, tt, ttl)
        total = sum(dev.values())
        groups = {}
        for name, t in dev.items():
            groups[group(name)] = groups.get(group(name), 0.0) + t
        print(f"prefill breakdown {spec.name} evict_per_qhead={per_qhead}, "
              f"S={S}, true_len={n_prompt}: warm prefill {med:.2f} ms "
              f"(quartiles {q1:.2f}-{q3:.2f}, {REPS} runs); profiled run "
              f"{wall:.2f} ms wall, {total:.2f} ms device, busy share "
              f"{total / wall:.3f}; device ms by part: "
              + ", ".join(f"{k} {v:.2f}" for k, v in
                          sorted(groups.items(), key=lambda kv: -kv[1])),
              flush=True)
        for name, t in sorted(dev.items(), key=lambda kv: -kv[1])[:TOP]:
            print(f"  {t:8.3f} ms  {name[:100]}", flush=True)


if __name__ == "__main__":
    main()
