#!/usr/bin/env python3
"""Where does a bucketed bf16 decode step part from a whole-width one?

    python3 scripts/torch_bucket_check.py [--seed N] [--out FILE]

Needs one CUDA card; imports no JAX.  The host-scheduled hot step attends
over the smallest length bucket that covers the cache (and, for Quest, a
decode-region bucket), where cond mode attends over the whole capacity.
In bf16 the two widths sum the same products in another order.  For
pyramidkv per kv head (4090-token prompt, the deep branch) and Quest +
jump per kv head (3000 tokens), both at Llama-3.2-1B's published widths
with random bf16 weights and the main path's knobs, this script runs two
host-path streams from one prefill cache, fed the same tokens (the
whole-width stream's greedy ones): A at the buckets, B pinned to the whole
width.  It prints, as one JSON line per case:
- ``step0_rel``: the logits' norm-wise gap after one step from the very
  same cache: summation order alone;
- ``pre_fire_max_rel``: the largest gap before the first fire, where the
  caches differ only by the rounding of the tokens appended so far;
- ``fire_keep_agreement``: at the first fire, the share of kept decode
  slots (per layer and head) that A and B both keep: below 1 means the
  rounding flipped an eviction;
- ``post_fire_max_rel``: the largest gap from the first fire to the end;
- ``gap_steps``: the steps whose gap exceeds 1e-2 (the chip check's
  LOGIT_REL).
The card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from scope_tpu_torch import CompressionConfig, EngineConfig  # noqa: E402
from scope_tpu_torch.compression import schedulers  # noqa: E402
from scope_tpu_torch.engine.host_loop import \
    HostScheduledDecoder  # noqa: E402
from scope_tpu_torch.models import llama  # noqa: E402
from scope_tpu_torch.models.registry import get_spec  # noqa: E402

DEVICE = "cuda"
CASES = {
    # name: (method, prompt tokens, decode steps)
    "pyramidkv": ("pyramidkv", 4090, 240),
    "quest": ("quest", 3000, 320),
}


def configs(method):
    comp = CompressionConfig(method=method, decoding_metric="jump",
                             max_capacity_prompt=2048, window_size=8,
                             decoding_window_size=512,
                             decoding_recent_size=256, delta=30,
                             evict_per_qhead=False, chunk_size=16,
                             quest_skip_layers=2)
    return comp, EngineConfig(max_prompt_len=4096, max_new_tokens=7950)


def rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


def clone(cache):
    return cache.replace(**{n: (getattr(cache, n).clone()
                                if getattr(cache, n) is not None else None)
                            for n in ("k", "v", "length", "pvalid",
                                      "prompt_len", "page_min", "page_max")})


def run_case(name, seed):
    method, n_prompt, steps = CASES[name]
    spec = get_spec("llama-3.2-1b")
    comp, ecfg = configs(method)
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    params = llama.init_params(spec, g, torch.bfloat16, device=DEVICE)
    rng = np.random.default_rng(seed)
    toks = np.zeros((1, ecfg.bucket_for(n_prompt)), np.int32)
    toks[0, :n_prompt] = rng.integers(1, spec.vocab_size, n_prompt)
    tl = torch.tensor([n_prompt], dtype=torch.int32, device=DEVICE)
    logits, cache, state = llama.prefill(
        spec, comp, ecfg, params, torch.as_tensor(toks, device=DEVICE), tl)
    dec_a = HostScheduledDecoder(spec, comp, ecfg)
    dec_b = HostScheduledDecoder(spec, comp, ecfg)
    dec_b.buckets = (dec_b.capacity,)
    dec_b.dec_buckets = (ecfg.max_new_tokens + 1,)
    streams = {s: [d, d.new_scheduler(n_prompt, prompt_pad=toks.shape[1]),
                   clone(cache), state]
               for s, d in (("A", dec_a), ("B", dec_b))}
    del cache
    # Record each force step's kept-slot maps (block_map's src, with the
    # row gate and keep count of each layer call) per stream and step.
    kept, current = {"A": {}, "B": {}}, ["A", 0]
    block_map = schedulers.block_map

    def recording(comp_, caps, probs, length, pseg, n_keep, row_gate,
                  positional=False):
        src, new_len = block_map(comp_, caps, probs, length, pseg, n_keep,
                                 row_gate, positional)
        kept[current[0]].setdefault(current[1], []).append(
            (src.clone(), row_gate.clone(), n_keep.clone()))
        return src, new_len
    schedulers.block_map = recording
    tok = logits.argmax(-1).to(torch.int32)
    gaps, widths = [], []
    try:
        for s in range(steps):
            out = {}
            current[1] = s
            for sname in ("A", "B"):
                current[0] = sname
                dec, sched, c, st = streams[sname]
                lg, c, st = dec.step(sched, params, tok, tl + s, c, st)
                streams[sname][2:] = [c, st]
                out[sname] = lg[0]
            widths.append(dec_a.bucket_for(streams["A"][1].length))
            gaps.append(rel(out["A"], out["B"]))
            tok = out["B"].argmax(-1).to(torch.int32)[None]
    finally:
        schedulers.block_map = block_map
    torch.cuda.synchronize()
    # Kept-slot agreement at the first fire: per fired (layer, head), the
    # share of B's kept decode slots that A keeps too.
    fire_step = min(kept["A"]) if kept["A"] else None
    agree = []
    if fire_step is not None:
        for (sa, ga, na), (sb, _, nb) in zip(kept["A"][fire_step],
                                             kept["B"][fire_step]):
            if not bool(ga[0]):
                continue
            n = int(nb[0])
            for h in range(sa.shape[1]):
                a_set = set(sa[0, h, :n].tolist())
                b_set = set(sb[0, h, :n].tolist())
                agree.append(len(a_set & b_set) / max(len(b_set), 1))
    pre = gaps[:fire_step] if fire_step is not None else gaps
    post = gaps[fire_step:] if fire_step is not None else []
    return {
        "case": name, "method": method, "prompt": n_prompt, "steps": steps,
        "capacity": dec_a.capacity, "step0_rel": gaps[0],
        "step0_widths": [widths[0], dec_a.capacity],
        "pre_fire_max_rel": max(pre) if pre else None,
        "first_fire_step": fire_step,
        "fire_keep_agreement": (float(np.mean(agree)) if agree else None),
        "fire_keep_agreement_min": (float(np.min(agree)) if agree else None),
        "post_fire_max_rel": max(post) if post else None,
        "gap_steps": [s for s, x in enumerate(gaps) if x > 1e-2][:20],
        "max_rel": max(gaps), "argmax_step": int(np.argmax(gaps)),
        "force_steps": sorted(kept["A"])[:8],
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="also append the JSON lines to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device: this script measures the port on an NVIDIA "
              "card", file=sys.stderr)
        sys.exit(1)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    with torch.inference_mode():
        for name in CASES:
            res = dict(run_case(name, args.seed), card=card)
            line = json.dumps(res)
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")


if __name__ == "__main__":
    main()
