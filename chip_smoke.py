#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an NVIDIA H100.

    python3 chip_smoke.py [--seed N]

Needs one CUDA card and the repository around this file; imports no JAX.
Three phases, each fatal on failure:

1. build: compile every CUDA kernel of scope_tpu_torch from csrc/ with
   nvcc and the serving engine's slot scheduler with the host C++ compiler
   (one process per source, all started together).
2. kernels: hold each kernel against its plain PyTorch version on the
   card, at the head shapes of Llama-3.2-1B and Llama-3.1-8B, a ragged S,
   a sliding window and logits scaled by 8 (bf16 inputs, the plain version
   in float32 on the same values; then the kernels on those float32
   values, held tightly; pad rows of the bf16 route must read out = 0,
   m2 = 0, l2 = 1), flash_prefill's need_scores=False route too (the 1B
   shape and the window case; m2 = 0 and l2 = 1 in every row), and time
   kernel, plain version and, for flash_prefill,
   F.scaled_dot_product_attention over all rows and over the real rows,
   and chunked prefill's finalize scores (prefill_scores_only: the scored
   flash_prefill over V = K plus colsum_scores, held against and timed
   beside the blocked torch version), beside each kernel's bound (bytes,
   bf16 tensor-core operations or exps, whichever takes longest).  Each kernel's design (tensor-core products,
   asynchronous copies) is read from its SASS.
3. main path: a small model on the card (kernels) against the CPU (plain
   versions; cond mode and the host-scheduled path), then Llama-3.2-1B at
   full width and depth with random bf16 weights: H2O prefill (P=2048,
   w=8) of a 3000-token prompt in the 4096 bucket, then SCOPE jump decode
   (W=512, r=256, delta=30), with per-query-head and per-kv-head eviction:
   (a) 384 tokens through StreamingGenerator, which takes the
   host-scheduled decoder; (b) the cond-mode prefill / decode_step loop as
   the reference: per-layer lengths and waves identical to the host path's
   at every step, and the host path's logits, fed (b)'s tokens, within
   LOGIT_REL of (b)'s; (c) host_generate with chunked hot runs, its mirror
   and cache lengths equal to the per-step path's; (d) 300 steps of hot
   chunks and a force step under torch.cuda.set_sync_debug_mode("error");
   (e) the ServingEngine on the small model, card against CPU (3 slots, 5
   requests; float32 tokens identical, int8 KV + int8 weights compared);
   (f) the ServingEngine at 1B, per-kv-head eviction, 16 slots, 24
   requests of 2100-3000 tokens and 320-384 new tokens, with a bf16 cache
   and bf16 weights, then int8 KV and int8 weights: exact token counts, no
   non-finite logits, a force step gating only part of the live rows,
   mirror = cache length at every finish, first tokens equal to
   StreamingGenerator's; it prints aggregate tok/s, TTFT / TPOT, peak
   memory, the hot step's device busy share and the device cost of the
   quantized converts; (g) the other prefill methods: the small model on
   the card against the CPU (snapkv + jump and streamingllm + slm on the
   host path, pyramidkv + pyramidinfer and + jump on the layered host path
   and in cond mode, headwise + jump in cond mode on 4 layers, served
   pyramidkv + jump and snapkv + jump; tokens and per-layer lengths
   identical at every step), then 1B with per-kv-head eviction: snapkv,
   streamingllm (w = P/2) and headwise (cond mode only) at 3000 tokens,
   pyramidkv at 4090 (its deep branch) with both eviction granularities,
   each with jump decode for 384 tokens (host and cond per-layer lengths
   identical, teacher-forced logits within LOGIT_REL, pyramidkv's prefill
   lengths as pyramid_prefill_kept says and within capacity, headwise's
   per-head budgets in range), pyramidkv's layered host path under the
   sync check, and 12 requests on 8 slots served on the device-cond path
   (pyramidkv + jump); (h) Quest and chunked prefill: the small model on
   the card against the CPU (Quest + none / fixed / jump on the host path
   and in cond mode, the paged decode region, int8 KV, Quest served on 3
   slots, chunked prefill of h2o / snapkv / pyramidkv / quest against
   monolithic prefill, chunked admission against monolithic admission;
   tokens and per-layer lengths identical at every step), then 1B Quest +
   jump (16-token pages, 2 dense skip layers, capacity 12160) at 3000
   tokens with both eviction granularities (host and cond per-layer
   lengths identical, waves of two steps, teacher-forced logits within
   LOGIT_REL with the buckets pinned to the whole cache), its host path
   under the sync check, Quest served on 8 slots (12 requests of
   2100-3000 tokens, 128 new), and h2o + jump served with chunked
   admission (prefill_chunk=512) against monolithic admission (first
   tokens equal; TTFT and the longest gap between decode dispatches of
   both).  Every kernel launch counter is set to 0 just before each run
   and read just after (16 launches of flash_prefill per prefill or
   admission, and 16 of colsum_scores where the method ranks by
   cumulative attention: h2o, pyramidkv; a chunked prefill launches
   flash_prefill with need_scores=False 16 times per chunk, for its chunk
   attention, and both kernels 16 times in its finalize pass for those
   methods);
   each run prints its numbers beside the card's name and power limit,
   and each phase its seconds.

Prints the card's name and power limit, a {"kernels": [...]} line and, as
the last line, {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

HERE = os.path.dirname(os.path.abspath(__file__))

# Published dense peaks of one H100 SXM (NVIDIA data sheet, 700 W).
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# exps per SM per clock on the special-function units (MUFU.EX2) of sm_90.
EXPS_PER_SM_CLOCK = 16
# Query rows of one flash_prefill tile (csrc/mma.cuh ROWS): the attention
# side needs exps of its own only on the tile that crosses the diagonal.
TILE = 64
# SASS instructions that name a kernel's design, in the order printed.
DESIGN_OPS = (("HGMMA", "wgmma"), ("HMMA", "mma.sync"), ("UTMALDG", "TMA"),
              ("LDGSTS", "cp.async"), ("SYNCS", "mbarrier"))
W = 8                       # H2O prefill window of the main path
DEVICE = "cuda"


def sync() -> None:
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def exp_rate() -> float:
    """exps per second the card's special-function units can do: 16 per
    SM per clock at the maximum SM clock nvidia-smi reports."""
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return EXPS_PER_SM_CLOCK * sms * float(mhz) * 1e6


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device time of fn over iters calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

# name: (B, H, S, D, true_len, sliding_window, logit scale)
KERNEL_CASES = {
    "1b_heads": (2, 32, 4096, 64, (4096, 3001), None, 1.0),
    "8b_heads": (1, 32, 2048, 128, (1999,), None, 1.0),
    "ragged_s1000": (2, 8, 1000, 64, (1000, 913), None, 1.0),
    "window64": (1, 8, 2048, 64, (2048,), 64, 1.0),
    "logits_x8": (1, 8, 2048, 64, (1800,), None, 8.0),
    "main_path": (1, 32, 4096, 64, (3000,), None, 1.0),
}
# (rtol, atol) with bf16 inputs, the plain version in float32 on the same
# values.  out: the kernel rounds each probability to bf16 before PV (up
# to 2^-9 of each term) and writes bf16.  Where a few keys carry a row's
# weight (early rows, logits x8) and their values cancel, that rounding
# alone moves out by up to ~2.6e-3 against |out| ~ 2e-3, so atol cannot be
# much below 5e-3.  m2 / l2 / colsum: float32 sums in another order.
TOL = {"out": (2e-2, 5e-3), "m2": (1e-4, 1e-4), "l2": (1e-3, 1e-3),
       "colsum": (1e-3, 1e-3)}
# The tight check of the bf16 route: per real row, |out - ref| / |ref| over
# the row's D values.  Rounding p and out to bf16 gives a few 2^-9 at
# most, whatever the number of keys; a 64-key tile dropped or mis-masked
# moves a late row's out by ~8/sqrt(keys) of its norm, >= 0.1 at 4096 keys.
OUT_REL = 1e-2
# The float32 route (the FP32 FMA kernels, which float32 inputs reach) on
# the float32 values, where nothing is rounded and the sums differ only in
# order: rtol = atol for every output and OUT_REL, looser at logits x8 (as
# tests/test_torch_cuda_kernels.py).
TOL_F32 = {1.0: 2e-4, 8.0: 1e-3}
TOPK_MIN = 0.995
OUTPUTS = ("out", "m2", "l2", "colsum")
# The need_scores=False route (snapkv, streamingllm and headwise prefill):
# the attention side alone, held on these cases' inputs with the same
# tolerances; m2 must read 0 and l2 1 in every row.
UNSCORED_CASES = ("main_path", "window64")
UNSCORED = "flash_prefill[need_scores=0]"


def kernel_inputs(case, seed):
    B, H, S, D, tl, window, scale = KERNEL_CASES[case]
    g = torch.Generator(device=DEVICE).manual_seed(seed)

    def rnd(sc):
        return (torch.randn((B, H, S, D), generator=g, device=DEVICE) * sc
                ).to(torch.bfloat16)
    q, k, v = rnd(scale), rnd(scale), rnd(1.0)
    return q, k, v, torch.tensor(tl, dtype=torch.int32, device=DEVICE)


def topk_agreement(cs, ref, tl):
    """Worst kept-set agreement over (row, head): top half of
    [0, true_len - w) by the kernel's and the plain version's scores."""
    from scope_tpu_torch.compression.policies import topk_indices
    worst = 1.0
    for b, n in enumerate(tl):
        region = n - W
        kk = region // 2
        a = topk_indices(cs[b, :, :region], kk)
        r = topk_indices(ref[b, :, :region], kk)
        hit = torch.zeros((a.shape[0], region), dtype=torch.bool,
                          device=a.device)
        hit.scatter_(1, a, True)
        same = hit.gather(1, r).float().mean(dim=1)
        worst = min(worst, float(same.min()))
    return worst


def run_kernels(fp, q, k, v, ttl, window):
    out, m2, l2 = fp.flash_prefill(q, k, v, ttl, window_size=W,
                                   need_scores=True, sliding_window=window)
    return out, m2, l2, fp.colsum_scores(q, k, ttl, m2, l2, window_size=W)


def compare(what, got, ref, tl, tol, out_rel):
    """Fail unless |got - ref| <= atol + rtol * |ref| for every output
    (out / m2 / l2 over the real rows, colsum over all keys) and out's
    norm-wise relative error is at most out_rel in every real row.  Returns
    each output's max abs error, the least atol it needed at its rtol, and
    the largest relative errors of out (norm-wise per row) and l2."""
    err, need = {}, {}
    rel = {"out": 0.0, "l2": 0.0}
    for b, n in enumerate(tl):
        g_, r_ = got[0][b, :, :n].float(), ref[0][b, :, :n]
        row = (g_ - r_).norm(dim=-1) / r_.norm(dim=-1).clamp_min(1e-30)
        rel["out"] = max(rel["out"], float(row.max()))
        rel["l2"] = max(rel["l2"], float(
            ((got[2][b, :, :n] - ref[2][b, :, :n]).abs()
             / ref[2][b, :, :n].abs()).max()))
    for name, g, r in zip(OUTPUTS, got, ref):
        rtol, atol = tol[name]
        parts = ([(g, r)] if name == "colsum" else
                 [(g[b, :, :n], r[b, :, :n]) for b, n in enumerate(tl)])
        err[name] = need[name] = 0.0
        for g_, r_ in parts:
            g_ = g_.float()
            if not torch.isfinite(g_).all():
                fail(f"{what}: non-finite {name}")
            d = (g_ - r_).abs()
            err[name] = max(err[name], float(d.max()))
            need[name] = max(need[name], float((d - rtol * r_.abs()).max()))
        if need[name] > atol:
            fail(f"{what}: {name} off by up to {err[name]:.3g}; needs atol "
                 f"{need[name]:.3g} at rtol {rtol} (tolerance {atol}); out's "
                 f"norm-wise relative error {rel['out']:.3g}")
    if rel["out"] > out_rel:
        fail(f"{what}: out's norm-wise relative error {rel['out']:.3g} in a "
             f"row (tolerance {out_rel}); least atol needed {need['out']:.3g}"
             f" at rtol {tol['out'][0]} (tolerance {tol['out'][1]})")
    return err, need, rel


def fmt(d):
    return " ".join(f"{n}={d[n]:.3g}" for n in OUTPUTS if n in d)


def check_unscored(fp, case, q, k, v, ttl, qf, kf, vf):
    """flash_prefill with need_scores=False, bf16 then float32, against its
    plain version: out within the scored route's tolerances, m2 = 0 and
    l2 = 1 exactly in every row.  Returns the bf16 route's errors."""
    B, H, S, D, tl, window, scale = KERNEL_CASES[case]

    def run(a, b, c):
        return fp.flash_prefill(a, b, c, ttl, window_size=W,
                                need_scores=False, sliding_window=window)
    got, got32 = run(q, k, v), run(qf, kf, vf)
    ref = fp.flash_prefill_reference(qf, kf, vf, ttl, window_size=W,
                                     need_scores=False, sliding_window=window)
    sync()
    what = f"{case} need_scores=False"
    for route, g in (("bf16", got), ("float32", got32)):
        if not ((g[1] == 0).all() and (g[2] == 1).all()):
            fail(f"{what} {route}: m2 / l2 are not 0 / 1 in every row")
    err, need, rel = compare(f"{what} bf16", got, ref, tl, TOL, OUT_REL)
    for b, n in enumerate(tl if DEVICE == "cuda" else ()):
        if not (got[0][b, :, n:] == 0).all():
            fail(f"{what} bf16: pad rows of row {b} are not out = 0")
    t32 = TOL_F32[scale]
    err32, _, rel32 = compare(f"{what} float32", got32, ref, tl,
                              {n: (t32, t32) for n in OUTPUTS}, t32)
    print(f"kernels {what}: B={B} H={H} S={S} D={D} true_len={tl} "
          f"window={window}; bf16 max_abs_err out={err['out']:.3g}, least "
          f"atol needed {need['out']:.3g}, relative out {rel['out']:.3g} "
          f"(tolerance {OUT_REL}); float32 max_abs_err out="
          f"{err32['out']:.3g}, relative out {rel32['out']:.3g} (tolerance "
          f"{t32}); m2 = 0 and l2 = 1 in every row", flush=True)
    return err


def check_kernels(seed):
    from scope_tpu_torch.ops import flash_prefill as fp
    timing = {}
    for i, case in enumerate(KERNEL_CASES):
        B, H, S, D, tl, window, scale = KERNEL_CASES[case]
        q, k, v, ttl = kernel_inputs(case, seed + i)
        got = run_kernels(fp, q, k, v, ttl, window)
        qf, kf, vf = q.float(), k.float(), v.float()
        got32 = run_kernels(fp, qf, kf, vf, ttl, window)
        ro, rm2, rl2 = fp.flash_prefill_reference(
            qf, kf, vf, ttl, window_size=W, need_scores=True,
            sliding_window=window)
        ref = (ro, rm2, rl2, fp.colsum_scores_reference(
            qf, kf, ttl, rm2, rl2, window_size=W))
        sync()
        err, need, rel = compare(f"{case} bf16", got, ref, tl, TOL, OUT_REL)
        # The kernel's pad rows (a CPU rehearsal runs the plain version,
        # which computes attention there).
        for b, n in enumerate(tl if DEVICE == "cuda" else ()):
            if not ((got[0][b, :, n:] == 0).all()
                    and (got[1][b, :, n:] == 0).all()
                    and (got[2][b, :, n:] == 1).all()):
                fail(f"{case} bf16: pad rows of row {b} are not out = 0, "
                     f"m2 = 0, l2 = 1")
        t32 = TOL_F32[scale]
        err32, _, rel32 = compare(f"{case} float32", got32, ref, tl,
                                  {n: (t32, t32) for n in OUTPUTS}, t32)
        unscored = (check_unscored(fp, case, q, k, v, ttl, qf, kf, vf)
                    if case in UNSCORED_CASES else None)
        cs, rcs = got[3], ref[3]
        agree = topk_agreement(cs, rcs, tl)
        if agree < TOPK_MIN:
            fail(f"{case}: colsum top-k agreement {agree:.4f} < {TOPK_MIN}")
        print(f"kernels {case}: B={B} H={H} S={S} D={D} true_len={tl} "
              f"window={window} logits x{scale:g}; bf16 max_abs_err "
              f"{fmt(err)}, least atol needed {fmt(need)}, relative out "
              f"{rel['out']:.3g} (norm-wise per row, tolerance {OUT_REL}) l2 "
              f"{rel['l2']:.3g}; float32 max_abs_err {fmt(err32)}, relative "
              f"out {rel32['out']:.3g} l2 {rel32['l2']:.3g} (tolerance "
              f"{t32}); topk_agree={agree:.4f}", flush=True)
        if case == "main_path":
            m2, l2 = got[1], got[2]
            timing = time_kernels(fp, q, k, v, ttl, m2, l2, qf, kf, vf, rm2,
                                  rl2, err)
            timing["err"][UNSCORED] = unscored["out"]
            timing["err"]["scores_only"] = check_scores_only(q, k, ttl, tl)
    return timing


def check_scores_only(q, k, ttl, tl):
    """Chunked prefill's finalize scores on the card (the scored
    flash_prefill over V = K plus colsum_scores) against the blocked torch
    version in float32 on the same values: colsum within TOL["colsum"] and
    the kept sets agreeing to TOPK_MIN.  Returns the max abs error."""
    from scope_tpu_torch.ops import attention
    got = attention.prefill_scores_only(q, k, ttl, window_size=W,
                                        need_colsum_all=True).colsum_all
    ref = attention._blocked_colsum(q.float(), k.float(), ttl, W,
                                    1.0 / q.shape[-1] ** 0.5, 256)
    sync()
    rtol, atol = TOL["colsum"]
    d = (got - ref).abs()
    need = float((d - rtol * ref.abs()).max())
    agree = topk_agreement(got, ref, tl)
    if need > atol or agree < TOPK_MIN:
        fail(f"prefill_scores_only: colsum needs atol {need:.3g} (tolerance "
             f"{atol}), top-k agreement {agree:.4f}")
    print(f"kernels prefill_scores_only (chunked finalize) at the main "
          f"path's shape: kernel pair vs blocked torch version, max_abs_err "
          f"{float(d.max()):.3g}, topk_agree={agree:.4f}", flush=True)
    return float(d.max())


def bounds(B, H, S, D, n_real, elem_bytes, exps_per_s):
    """Least time for each function on these inputs (ms, bound_by): the
    largest of bytes / HBM rate, matmul operations / bf16 peak and exps /
    the special-function units' rate (exps_per_s, from exp_rate()).  Only
    the n_real rows before true_len count: nothing reads the outputs of
    pad rows (colsum masks them, later layers mask pad keys, the logits
    take the last real token), so S is not used."""
    # flash: QK^T for every real row against every real key (the scoring
    # side covers them all), PV for the causal pairs; q/k/v read, out / m2 /
    # l2 written for the real rows.  One exp per (real row, real key) pair
    # for the scoring side.  Below the diagonal the attention side sees the
    # same keys in the same order, so its probabilities are the scoring
    # side's times one factor per row: it needs exps of its own only for
    # the causal pairs of each row's diagonal tile.
    att_pairs = n_real * (n_real + 1) // 2
    full, part = divmod(n_real, TILE)
    diag_pairs = full * TILE * (TILE + 1) // 2 + part * (part + 1) // 2
    flash_ops = B * H * (2 * D * n_real * n_real + 2 * D * att_pairs)
    flash_exps = B * H * (n_real * n_real + diag_pairs)
    flash_bytes = B * H * n_real * (4 * D * elem_bytes + 2 * 4) + 4 * B
    # flash with need_scores=False: the attention side alone, QK^T and PV
    # over the causal pairs of real rows and one exp per pair; the same
    # bytes (m2 / l2 are written, as constants).
    un_ops = B * H * 4 * D * att_pairs
    un_exps = B * H * att_pairs
    # colsum: QK^T and one exp over real rows x real keys; q/k/m2/l2 read,
    # colsum written.
    cs_ops = B * H * 2 * D * n_real * n_real
    cs_exps = B * H * n_real * n_real
    cs_bytes = B * H * n_real * (2 * D * elem_bytes + 3 * 4) + 4 * B
    out = {}
    for name, ops, exps, nbytes in (
            ("flash_prefill", flash_ops, flash_exps, flash_bytes),
            (UNSCORED, un_ops, un_exps, flash_bytes),
            ("colsum_scores", cs_ops, cs_exps, cs_bytes)):
        terms = {"bytes": nbytes / PEAK_BYTES,
                 "operations": ops / PEAK_BF16_FLOPS,
                 "exps": exps / exps_per_s}
        by = max(terms, key=terms.get)
        out[name] = (terms[by] * 1e3, by)
    return out


def time_kernels(fp, q, k, v, ttl, m2, l2, qf, kf, vf, rm2, rl2, err):
    B, H, S, D = q.shape
    n_real = min(int(ttl[0]), S)
    t = {
        "flash_prefill": cuda_ms(lambda: fp.flash_prefill(
            q, k, v, ttl, window_size=W, need_scores=True), 10),
        "colsum_scores": cuda_ms(lambda: fp.colsum_scores(
            q, k, ttl, m2, l2, window_size=W), 10),
        "flash_prefill_plain": cuda_ms(lambda: fp.flash_prefill_reference(
            qf, kf, vf, ttl, window_size=W, need_scores=True), 3),
        UNSCORED: cuda_ms(lambda: fp.flash_prefill(
            q, k, v, ttl, window_size=W, need_scores=False), 10),
        UNSCORED + "_plain": cuda_ms(lambda: fp.flash_prefill_reference(
            qf, kf, vf, ttl, window_size=W, need_scores=False), 3),
        "colsum_scores_plain": cuda_ms(lambda: fp.colsum_scores_reference(
            qf, kf, ttl, rm2, rl2, window_size=W), 3),
        "sdpa": cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True), 10),
    }
    qr, kr, vr = (x[:, :, :n_real].contiguous() for x in (q, k, v))
    t["sdpa_real_rows"] = cuda_ms(lambda: F.scaled_dot_product_attention(
        qr, kr, vr, is_causal=True), 10)
    # Chunked prefill's finalize scores: the kernel pair (the scored flash
    # over V = K, its out discarded, then colsum), the blocked torch
    # version on the card, and the discarded out half (the attention side
    # alone: the need_scores=False route on the same q and k).
    from scope_tpu_torch.ops import attention
    t["scores_pair"] = cuda_ms(lambda: attention.prefill_scores_only(
        q, k, ttl, window_size=W, need_colsum_all=True), 10)
    t["scores_blocked"] = cuda_ms(lambda: attention._blocked_colsum(
        q, k, ttl, W, 1.0 / D ** 0.5, 256), 3)
    t["scores_out_half"] = cuda_ms(lambda: fp.flash_prefill(
        q, k, k, ttl, window_size=W, need_scores=False), 10)
    rate = exp_rate()
    t["bounds"] = bounds(B, H, S, D, n_real, q.element_size(), rate)
    t["err"] = err
    from scope_tpu_torch.ops import build
    t["design"] = {name: design(build.sass(src)) for name, src in (
        ("flash_prefill", "flash_prefill.cu"),
        ("colsum_scores", "colsum_scores.cu"))}
    print(f"kernel times at the main path's shape (B={B} H={H} S={S} D={D} "
          f"true_len={n_real} bf16): flash_prefill {t['flash_prefill']:.3f} "
          f"ms (plain {t['flash_prefill_plain']:.3f}, SDPA causal "
          f"{t['sdpa']:.3f} over {S} rows and {t['sdpa_real_rows']:.3f} over "
          f"the {n_real} real rows, yardsticks for the attention half "
          f"only), colsum_scores {t['colsum_scores']:.3f} ms (plain "
          f"{t['colsum_scores_plain']:.3f}); flash_prefill need_scores=False "
          f"{t[UNSCORED]:.3f} ms (plain {t[UNSCORED + '_plain']:.3f}; the "
          f"same function as SDPA over the real rows); chunked finalize "
          f"scores: kernel pair {t['scores_pair']:.3f} ms, blocked torch "
          f"version {t['scores_blocked']:.3f} ms, the discarded out half "
          f"{t['scores_out_half']:.3f} ms; exp rate "
          f"{rate:.4g}/s; bounds "
          f"{t['bounds']}; bf16 designs from SASS {t['design']}", flush=True)
    return t


def design(sass: str) -> str:
    """The design of a library's bf16 route, from its SASS (cuobjdump
    -sass): the DESIGN_OPS instructions that every bf16 kernel of it uses
    (functions named *_tc), joined by '+', or 'FMA' for none."""
    funcs = [f for f in sass.split("Function : ")[1:]
             if f.split(None, 1)[0].split("ILi")[0].endswith("_tc")]
    if not funcs:
        fail("no bf16 (_tc) kernel in the SASS")
    names = [name for op, name in DESIGN_OPS
             if all(re.search(rf"\b{op}\b", f) for f in funcs)]
    return "+".join(names) or "FMA"


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

def reset_launches():
    from scope_tpu_torch.ops import flash_prefill as fp
    fp.flash_prefill.launches = 0
    fp.colsum_scores.launches = 0


def read_launches():
    from scope_tpu_torch.ops import flash_prefill as fp
    return {"flash_prefill": fp.flash_prefill.launches,
            "colsum_scores": fp.colsum_scores.launches}


def counted(what, per_prefill, prefills, fn):
    """fn() with every launch counter set to 0 just before and read just
    after; fails unless each kernel launched per_prefill times (an int for
    both kernels, or a dict by kernel) in each of the run's prefills.
    Returns (fn's result, the counts)."""
    if not isinstance(per_prefill, dict):
        per_prefill = {"flash_prefill": per_prefill,
                       "colsum_scores": per_prefill}
    reset_launches()
    out = fn()
    launches = read_launches()
    if DEVICE == "cuda" and any(launches[k] != n * prefills
                                for k, n in per_prefill.items()):
        fail(f"{what}: launches {launches} over {prefills} prefill(s), "
             f"expected {per_prefill} per prefill")
    return out, launches


def rate(tpot_s):
    """decode tok/s and TPOT median / p95 from per-token host times (the
    first entry, the time to the first token, left out)."""
    t = np.asarray(tpot_s[1:]) * 1e3
    return (f"decode {len(t) / t.sum() * 1e3:.1f} tok/s over {len(t)} "
            f"tokens (TPOT median {np.median(t):.2f} ms, p95 "
            f"{np.percentile(t, 95):.2f} ms)")


def spread(tpot_s):
    """Per-token times of a chunked run: the tokens of one chunk share its
    end time (zeros after its first token); give each an equal share."""
    out = list(tpot_s)
    i = 1
    while i < len(out):
        j = i + 1
        while j < len(out) and out[j] == 0:
            j += 1
        out[i:j] = [out[i] / (j - i)] * (j - i)
        i = j
    return out


def first_difference(a, b):
    diff = np.flatnonzero(np.asarray(a) != np.asarray(b))
    return int(diff[0]) if len(diff) else None


def wave_steps(lengths):
    """Decode steps whose compression shrank some layer's cache, from the
    per-layer lengths after prefill and after each step."""
    return [s - 1 for s in range(1, len(lengths))
            if any(b < a for a, b in zip(lengths[s - 1], lengths[s]))]


def small_spec(layers=2):
    """The 2-layer (or deeper) D=64 model of the card-against-CPU checks."""
    from scope_tpu_torch import ModelSpec
    return ModelSpec(name=f"smoke-small-{layers}l", vocab_size=512,
                     hidden_size=256, intermediate_size=512,
                     num_layers=layers, num_heads=4, num_kv_heads=2,
                     head_dim=64)


def on_card(params):
    """A copy of a parameter dict on DEVICE."""
    out = {n: a.to(DEVICE) for n, a in params.items() if n != "layers"}
    out["layers"] = {n: a.to(DEVICE) for n, a in params["layers"].items()}
    return out


def small_model_check(seed):
    """Kernels (card) against plain versions (CPU) through the whole path:
    a 2-layer model with Llama head shapes, float32, identical tokens, in
    cond mode (B=2, ragged) and on the host-scheduled path with chunked
    hot runs (B=1)."""
    from scope_tpu_torch import CompressionConfig, EngineConfig
    from scope_tpu_torch.engine.generate import generate
    from scope_tpu_torch.engine.host_loop import host_generate
    from scope_tpu_torch.models import llama
    spec = small_spec()
    comp = CompressionConfig(method="h2o", decoding_metric="jump",
                             max_capacity_prompt=64, window_size=8,
                             decoding_window_size=32,
                             decoding_recent_size=16, delta=3)
    ecfg = EngineConfig(max_prompt_len=256, max_new_tokens=48,
                        dtype="float32")
    g = torch.Generator(device="cpu").manual_seed(seed)
    p_cpu = llama.init_params(spec, g, torch.float32, device="cpu")
    p_gpu = on_card(p_cpu)
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, spec.vocab_size, (2, 256)).astype(np.int32)
    tl = np.array([230, 171], np.int32)
    L = spec.num_layers
    (gen_gpu, _), _ = counted("small model, cond mode", L, 1, lambda: generate(
        spec, comp, ecfg, p_gpu, toks, tl, 48, -1, device=DEVICE))
    gen_cpu, _ = generate(spec, comp, ecfg, p_cpu, toks, tl, 48, -1,
                          device="cpu")
    same = float((gen_gpu.cpu() == gen_cpu).float().mean())
    ecfg_c = ecfg.replace(decode_chunk_sizes=(8, 4))
    (host_gpu, _), _ = counted("small model, host path", L, 1, lambda: (
        host_generate(spec, comp, ecfg_c, p_gpu, toks[:1], tl[:1], 48,
                      device=DEVICE)))
    host_cpu, _ = host_generate(spec, comp, ecfg_c, p_cpu, toks[:1], tl[:1],
                                48, device="cpu")
    host_same = float(np.mean(host_gpu == host_cpu))
    print(f"small model (2 layers, D=64, float32): card kernels vs CPU plain "
          f"versions, token agreement {same:.4f} in cond mode (B=2), "
          f"{host_same:.4f} on the host path with chunks (8, 4) (B=1)",
          flush=True)
    if same != 1.0 or host_same != 1.0:
        fail("small model: card and CPU tokens differ")


# Greedy tokens per request: the first jump wave fires at decode step 293,
# then 324 and 355 (they depend on cache lengths only, not on tokens).
N_NEW = 384
WAVES = [293, 324, 355]
# Teacher-forced on the cond path's tokens, the host path's logits at
# every step, norm-wise: |a - b| / |b| over the vocabulary.  Both paths
# run the same operations on the same shapes (every hot step's length
# bucket is the full capacity here), so the expected error is 0; a wrong
# keep count or gate moves it to O(1).
LOGIT_REL = 1e-2


def main_config():
    """Llama-3.2-1B at full width and depth; the paper's H2O + jump knobs;
    a 3000-token prompt in the 4096 bucket, so H2O evicts (a prompt in the
    2048 bucket would take the S_pad <= P passthrough)."""
    from scope_tpu_torch import CompressionConfig, EngineConfig
    from scope_tpu_torch.models.registry import get_spec
    comp = CompressionConfig(method="h2o", decoding_metric="jump",
                             max_capacity_prompt=2048, window_size=W,
                             decoding_window_size=512,
                             decoding_recent_size=256, delta=30)
    ecfg = EngineConfig(max_prompt_len=4096, max_new_tokens=7950)
    return get_spec("llama-3.2-1b"), comp, ecfg, 3000


def main_inputs(spec, ecfg, n_prompt, seed):
    """Random bf16 weights and one prompt of n_prompt real tokens."""
    from scope_tpu_torch.models import llama
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    params = llama.init_params(spec, g, torch.bfloat16, device=DEVICE)
    rng = np.random.default_rng(seed)
    toks = np.zeros((1, ecfg.bucket_for(n_prompt)), np.int32)
    toks[0, :n_prompt] = rng.integers(1, spec.vocab_size, n_prompt)
    return params, toks, np.array([n_prompt], np.int32)


def cond_run(spec, comp, ecfg, params, toks, tl, n_steps):
    """Cond mode (the device's gates, one host sync per layer): tokens,
    per-token host times, per-layer lengths after prefill and after each
    step, each step's logits (kept on the device) and the cache's per-head
    prefill counts (pvalid [L, B, H])."""
    from scope_tpu_torch.models import llama
    tt = torch.as_tensor(toks, device=DEVICE)
    ttl = torch.as_tensor(tl, device=DEVICE)
    t0 = time.perf_counter()
    logits, cache, state = llama.prefill(spec, comp, ecfg, params, tt, ttl)
    tok = logits.argmax(-1).to(torch.int32)
    got, stamps = [int(tok[0])], [time.perf_counter()]
    lengths, logs = [cache.length[:, 0].clone()], []
    for s in range(n_steps):
        logits, cache, state = llama.decode_step(spec, comp, ecfg, params,
                                                 tok, ttl + s, cache, state)
        logs.append(logits[0])
        tok = logits.argmax(-1).to(torch.int32)
        got.append(int(tok[0]))
        stamps.append(time.perf_counter())
        lengths.append(cache.length[:, 0].clone())
    logs = torch.stack(logs)
    if not torch.isfinite(logs).all():
        fail("cond path: non-finite logits")
    tpot = np.diff([t0] + stamps).tolist()
    return got, tpot, torch.stack(lengths).tolist(), logs, cache.pvalid


def teacher_forced(spec, comp, ecfg, params, toks, tl, fed, ref_logits):
    """The host-scheduled decoder fed the cond path's tokens: its logits'
    norm-wise error against the cond path's, its per-layer lengths after
    prefill and after each step, and its mirror's per-layer lengths after
    each step."""
    from scope_tpu_torch.engine.host_loop import HostScheduledDecoder
    from scope_tpu_torch.models import llama
    dec = HostScheduledDecoder(spec, comp, ecfg)
    # Hot steps attend over the whole capacity, as cond mode does, so both
    # paths run the same operations on the same shapes.  A narrower length
    # bucket (pyramidkv's shorter layers) sums the bf16 products in another
    # order and moved the logits by up to 1.7% norm-wise (PERF.md §6).
    dec.buckets = (dec.capacity,)
    dec.dec_buckets = (ecfg.max_new_tokens + 1,)
    ttl = torch.as_tensor(tl, device=DEVICE)
    logits, cache, state = llama.prefill(
        spec, comp, ecfg, params, torch.as_tensor(toks, device=DEVICE), ttl)
    sched = dec.new_scheduler(int(tl[0]), prompt_pad=toks.shape[1])
    lengths, errs, mirror = [cache.length[:, 0].clone()], [], []
    for s, ref in enumerate(ref_logits):
        tok = torch.full((1,), fed[s], dtype=torch.int32, device=DEVICE)
        logits, cache, state = dec.step(sched, params, tok, ttl + s, cache,
                                        state)
        ref = ref.float()
        errs.append((logits[0].float() - ref).norm() / ref.norm())
        lengths.append(cache.length[:, 0].clone())
        mirror.append(mirror_lengths(sched, spec.num_layers))
    return (torch.stack(errs).tolist(), torch.stack(lengths).tolist(),
            mirror)


def mirror_lengths(sched, num_layers):
    """A host mirror's length per layer (one length for every layer unless
    the mirror is pyramidkv's layered one)."""
    return list(getattr(sched, "lengths", [sched.length] * num_layers))


def main_path(spec, comp, ecfg, n_prompt, seed, card):
    """(a) StreamingGenerator, the user's entry point (host-scheduled);
    (b) the cond-mode prefill / decode_step loop as the reference, and the
    host path teacher-forced on its tokens; (c) host_generate with chunked
    hot runs.  Returns (a)'s launch counts."""
    from scope_tpu_torch.engine.generate import StreamingGenerator
    from scope_tpu_torch.engine.host_loop import host_generate
    L = spec.num_layers
    name = f"{spec.name} evict_per_qhead={comp.evict_per_qhead}"
    cap = ecfg.cache_capacity(comp)
    params, toks, tl = main_inputs(spec, ecfg, n_prompt, seed)

    # (a) the user's entry point, timed per token.
    sg = StreamingGenerator(spec, comp, ecfg, params, eos_ids=(),
                            device=DEVICE)
    if sg.host_decoder is None:
        fail(f"{name}: StreamingGenerator did not take the host path")
    sync()
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    res, launches = counted(f"{name} (a)", L, 1,
                            lambda: sg.generate(toks, tl, N_NEW))
    peak = torch.cuda.max_memory_allocated() if DEVICE == "cuda" else 0
    host_toks = res.tokens[0]
    if res.gen_lengths[0] != N_NEW or not (
            (host_toks >= 0) & (host_toks < spec.vocab_size)).all():
        fail(f"{name} (a): bad tokens {host_toks[:8]}...")

    # (b) cond mode, then the host path fed its tokens.
    (got, cond_tpot, lengths, logs, _), _ = counted(
        f"{name} (b) cond", L, 1, lambda: cond_run(
            spec, comp, ecfg, params, toks, tl, N_NEW - 1))
    (errs, h_lengths, mirror), _ = counted(
        f"{name} (b) host, teacher-forced", L, 1, lambda: teacher_forced(
            spec, comp, ecfg, params, toks, tl, got, logs))
    del logs
    waves, h_waves = wave_steps(lengths), wave_steps(h_lengths)
    if h_lengths != lengths:
        s = next(i for i, (a, b) in enumerate(zip(h_lengths, lengths))
                 if a != b)
        fail(f"{name}: host and cond per-layer lengths differ after decode "
             f"step {s - 1}: {h_lengths[s]} vs {lengths[s]}")
    if any(x != m for x, m in zip(h_lengths[1:], mirror)):
        fail(f"{name}: the host mirror's length left the cache's")
    if waves[:3] != WAVES or h_waves != waves:
        fail(f"{name}: waves at {h_waves[:6]} (host) and {waves[:6]} "
             f"(cond), expected {WAVES} first")
    if max(max(x) for x in lengths) > cap:
        fail(f"{name}: a cache length exceeded capacity {cap}")
    worst = max(errs)
    if not worst <= LOGIT_REL:
        fail(f"{name}: teacher-forced logits off by {worst:.3g} norm-wise "
             f"at decode step {int(np.argmax(errs))} (tolerance {LOGIT_REL})")
    diverge = first_difference(host_toks, got)
    print(f"main path {name} (a) StreamingGenerator, host-scheduled: TTFT "
          f"{res.ttft_s * 1e3:.1f} ms, {rate(res.tpot_s)}; (b) cond mode: "
          f"TTFT {cond_tpot[0] * 1e3:.1f} ms, {rate(cond_tpot)}; peak memory "
          f"{peak / 2**30:.2f} GiB; launches per prefill {launches}; card "
          f"{card}", flush=True)
    print(f"main path {name} host vs cond: per-layer lengths identical at "
          f"all {len(lengths) - 1} steps ({lengths[0][0]} after prefill, "
          f"{min(map(min, lengths))}..{max(map(max, lengths))} of capacity "
          f"{cap}); waves at steps {h_waves[:6]} on both, all {L} layers; "
          f"mirror = cache length at every step; teacher-forced logits "
          f"norm-wise error max {worst:.3g}, median {np.median(errs):.3g} "
          f"(tolerance {LOGIT_REL}); free-running token agreement "
          f"{np.mean(host_toks == np.array(got)):.4f}, first divergence at "
          f"token {diverge}", flush=True)

    # (c) host_generate with chunked hot runs (bench.py's setting); it may
    # run up to 15 steps past max_new, which stays inside (b)'s table.
    ecfg_c = ecfg.replace(decode_chunk_sizes=(16, 8))
    if ecfg_c.cache_capacity(comp) != cap:
        fail(f"{name} (c): chunk slack changed the capacity")
    (gen, stats), _ = counted(f"{name} (c)", L, 1, lambda: host_generate(
        spec, comp, ecfg_c, params, toks, tl, N_NEW - 16, device=DEVICE))
    n_c = stats["decode_steps"]
    if (set(stats["cache_length"]) != {stats["mirror_length"]}
            or stats["cache_length"] != lengths[n_c]):
        fail(f"{name} (c): after {n_c} steps, cache lengths "
             f"{stats['cache_length']}, mirror {stats['mirror_length']}, "
             f"per-step path {lengths[n_c]}")
    print(f"main path {name} (c) host_generate, chunks (16, 8): "
          f"{rate(spread(stats['tpot_s']))}, tokens of one chunk sharing its "
          f"time equally; mirror = cache = per-step length "
          f"{stats['mirror_length']} after {n_c} steps; token agreement with "
          f"(a) {np.mean(gen[0] == host_toks[:gen.shape[1]]):.4f}; card "
          f"{card}", flush=True)
    return launches


def sync_free(spec, comp, ecfg, n_prompt, seed):
    """(d) 300 decode steps of step_auto with chunks (16, 8) under
    torch.cuda.set_sync_debug_mode("error"): hot chunks and the first
    wave's force step (per layer for pyramidkv), and no call may wait for
    the device."""
    from scope_tpu_torch.engine.host_loop import HostScheduledDecoder
    from scope_tpu_torch.models import llama
    ecfg_e = ecfg.replace(decode_chunk_sizes=(16, 8))
    params, toks, tl = main_inputs(spec, ecfg, n_prompt, seed)
    dec = HostScheduledDecoder(spec, comp, ecfg_e)
    ttl = torch.as_tensor(tl, device=DEVICE)
    logits, cache, state = llama.prefill(
        spec, comp, ecfg_e, params, torch.as_tensor(toks, device=DEVICE), ttl)
    tok = logits.argmax(-1).to(torch.int32)
    sched = dec.new_scheduler(int(tl[0]), prompt_pad=toks.shape[1])
    L = spec.num_layers
    # One chunk first, outside the check: first calls set up libraries.
    out, cache, state = dec.step_auto(sched, params, tok, ttl, cache, state)
    s, tok = out.shape[1], out[:, -1]
    sync()
    chunks = fires = 0
    if DEVICE == "cuda":
        torch.cuda.set_sync_debug_mode("error")
    try:
        while s < 300:
            before = mirror_lengths(sched, L)
            out, cache, state = dec.step_auto(sched, params, tok, ttl + s,
                                              cache, state)
            n = out.shape[1]
            chunks += n > 1
            fires += any(a < b + n for a, b in
                         zip(mirror_lengths(sched, L), before))
            s, tok = s + n, out[:, -1]
    finally:
        if DEVICE == "cuda":
            torch.cuda.set_sync_debug_mode("default")
    sync()
    if chunks < 10 or fires < 1:
        fail(f"sync check: {chunks} chunks and {fires} fires in {s} steps")
    print(f"sync check {spec.name} {comp.method}+{comp.decoding_metric} "
          f"evict_per_qhead={comp.evict_per_qhead}: "
          f"{s - 16} decode steps of step_auto (chunks (16, 8)) under "
          f"torch.cuda.set_sync_debug_mode('error'): {chunks} hot chunks, "
          f"{fires} force step(s), no host sync", flush=True)


# ---------------------------------------------------------------------------
# phase 3, serving: (e) small model, card against CPU; (f) Llama-3.2-1B
# ---------------------------------------------------------------------------

def serve(spec, comp, ecfg, params, reqs, device, max_slots, what,
          prefill_chunk=None):
    """ServingEngine over reqs [(prompt, max_new)]: tokens per request in
    submit order.  On the card each kernel must launch as the method's
    prefill launches it (``per_prefill``, or ``per_chunked`` with chunked
    admission) in each admission."""
    from scope_tpu_torch.engine.serving import ServingEngine
    eng = ServingEngine(spec, comp, ecfg, params, max_slots=max_slots,
                        prefill_chunk=prefill_chunk, device=device)
    ids = [eng.submit(p, n) for p, n in reqs]
    if device == "cpu":
        res = eng.run()
    else:
        if prefill_chunk:
            expect, n = per_chunked(spec, comp, [len(p) for p, _ in reqs],
                                    prefill_chunk), 1
        else:
            expect, n = per_prefill(spec, comp), len(reqs)
        res, _ = counted(what, expect, n, eng.run)
    return [res[i] for i in ids]


def per_prefill(spec, comp):
    """Each kernel's launches in one prefill: flash_prefill in every layer,
    colsum_scores in every layer of the methods that rank by cumulative
    attention (h2o, pyramidkv)."""
    L = spec.num_layers
    return {"flash_prefill": L,
            "colsum_scores": L if comp.method in ("h2o", "pyramidkv") else 0}


def serving_small_check(seed):
    """(e) The 2-layer D=64 float32 model served on the card (kernels)
    against the same engine on the CPU (plain versions): 3 slots, 5 ragged
    requests, h2o + jump, per-kv-head eviction, chunked hot runs.  Tokens
    identical with the float32 cache; with int8 KV and int8 weights the
    first difference, if any, is printed."""
    from scope_tpu_torch import CompressionConfig, EngineConfig
    from scope_tpu_torch.models import llama
    from scope_tpu_torch.ops import quant
    spec = small_spec()
    comp = CompressionConfig(method="h2o", decoding_metric="jump",
                             max_capacity_prompt=64, window_size=8,
                             decoding_window_size=32,
                             decoding_recent_size=16, delta=3,
                             evict_per_qhead=False)
    ecfg = EngineConfig(max_prompt_len=256, max_new_tokens=48,
                        dtype="float32", decode_chunk_sizes=(8, 4))
    g = torch.Generator(device="cpu").manual_seed(seed)
    p_cpu = llama.init_params(spec, g, torch.float32, device="cpu")
    rng = np.random.default_rng(seed)
    reqs = [(rng.integers(1, spec.vocab_size, n).astype(np.int32), m)
            for n, m in ((230, 40), (171, 33), (120, 45), (250, 24),
                         (90, 38))]
    out = []
    for kv, w8 in (("bfloat16", False), ("int8", True)):
        pc = quant.quantize_layer_weights(p_cpu) if w8 else p_cpu
        pg = on_card(pc)
        e = ecfg.replace(kv_dtype=kv)
        got = serve(spec, comp, e, pg, reqs, DEVICE, 3,
                    f"small serving kv={kv} w8={w8}")
        ref = serve(spec, comp, e, pc, reqs, "cpu", 3, "")
        if [len(t) for t in got] != [m for _, m in reqs]:
            fail(f"small serving kv={kv}: token counts "
                 f"{[len(t) for t in got]}")
        diffs = [first_difference(a, b) for a, b in zip(got, ref)]
        same = np.mean([np.mean(np.array(a) == np.array(b))
                        for a, b in zip(got, ref)])
        out.append(f"kv={kv} weights={'int8' if w8 else 'float32'}: token "
                   f"agreement {same:.4f}, first difference per request "
                   f"{diffs}")
        if not w8 and any(d is not None for d in diffs):
            fail(f"small serving (float32 cache): card and CPU tokens differ "
                 f"at {diffs}")
    print(f"serving (e) small model (2 layers, D=64, 3 slots, 5 requests, "
          f"h2o+jump, per-kv-head), card kernels vs CPU plain versions: "
          f"{'; '.join(out)}", flush=True)


SERVE_SLOTS = 16
SERVE_REQUESTS = 24
SERVE_PROMPT = (2100, 3000)     # real tokens: the 4096 bucket, so H2O evicts
SERVE_NEW = (320, 384)          # the first jump waves fire at 293/324/355
SINGLE_STREAM = (4, 64)         # requests also run through StreamingGenerator,
                                # and the tokens each of them generates there
# Request 0 (slot 0) teacher-forced at B=1 on its served tokens: its logits
# against the ones it got at B=16, norm-wise.  bf16 products of another
# batch size round differently (a few 1e-3 per layer); a wrong row,
# position or cache read moves them by O(1).
TF_STEPS = 64
BATCH_LOGIT_REL = 0.1


def serving_requests(spec, seed):
    rng = np.random.default_rng(seed + 1)
    return [(rng.integers(1, spec.vocab_size, int(n)).astype(np.int32),
             int(m))
            for n, m in zip(rng.integers(*SERVE_PROMPT, SERVE_REQUESTS),
                            rng.integers(SERVE_NEW[0], SERVE_NEW[1] + 1,
                                         SERVE_REQUESTS))]


def instrument(eng):
    """Host-side checks wrapped around one engine: force steps whose gate
    holds only part of the active rows, each slot's mirror length against
    its cache length when its request finishes (a host read of the device),
    a device flag of non-finite logits (no host read), and slot 0's logits
    of the first TF_STEPS decode steps (kept on the device).  Returns the
    record they fill."""
    from scope_tpu_torch.models import llama
    rec = {"force": 0, "partial": 0, "finished": 0, "mirror_off": [],
           "bad": torch.zeros((), dtype=torch.bool, device=eng.device),
           "logits": []}
    step_force, finish = eng._hdec.step_force, eng._finish
    decode_step = llama.decode_step

    def force(params, tok, vpos, cache, state, n_keep, row_gate=None):
        active = np.array([s.active for s in eng.slots])
        gate = np.asarray(row_gate, bool)
        rec["force"] += 1
        rec["partial"] += bool(gate[active].any() and not gate[active].all())
        return step_force(params, tok, vpos, cache, state, n_keep, row_gate)

    def fin(slot):
        mirror = eng._slot_scheds[slot].length
        cache = eng.cache.length[:, slot].tolist()
        if set(cache) != {mirror}:
            rec["mirror_off"].append((slot, mirror, cache))
        rec["finished"] += 1
        finish(slot)

    def checked(*a, **k):
        out = decode_step(*a, **k)
        rec["bad"] |= ~torch.isfinite(out[0]).all()
        if len(rec["logits"]) < TF_STEPS:
            rec["logits"].append(out[0][0].clone())
        return out

    eng._hdec.step_force, eng._finish = force, fin
    llama.decode_step = checked
    rec["undo"] = lambda: setattr(llama, "decode_step", decode_step)
    return rec


def pct(x, q):
    return float(np.percentile(np.asarray(x), q))


def device_ms(fn, iters: int):
    """Device kernel ms per call of fn, summed over the kernels the
    profiler records (device activity only) in iters calls; None where it
    recorded none."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    sync()
    activities = ([ProfilerActivity.CUDA] if DEVICE == "cuda"
                  else [ProfilerActivity.CPU])
    with profile(activities=activities) as prof:
        for _ in range(iters):
            fn()
        sync()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / 1e3 / iters if us > 0 else None


def graph_ms(fn, iters: int):
    """Device ms per call of fn: fn captured once in a CUDA graph, the
    graph's replays timed by CUDA events, so the host's launch rate does
    not bound the reading.  None off the card."""
    if DEVICE != "cuda":
        return None
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    ms = cuda_ms(graph.replay, iters)
    del graph
    return ms


def serving_busy_share(spec, comp, ecfg, params, reqs):
    """The serving hot step with all SERVE_SLOTS slots live and one request
    queued (so no chunk runs): (host ms per step over 10 steps, device
    kernel ms per step over 10 more under the profiler, or None).  Their
    ratio is the device busy share: the profiled device time over the
    unprofiled host time, so the profiler's own host cost does not dilute
    it.  The dispatches run under torch.cuda.set_sync_debug_mode("error")."""
    from scope_tpu_torch.engine.serving import ServingEngine
    eng = ServingEngine(spec, comp, ecfg, params, max_slots=SERVE_SLOTS,
                        pipeline_depth=1, device=DEVICE)
    for p, n in reqs[:SERVE_SLOTS + 1]:
        eng.submit(p, n)
    for _ in range(3):
        eng.step()
    dispatch = eng._dispatch

    def sync_free_dispatch():
        torch.cuda.set_sync_debug_mode("error")
        try:
            dispatch()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    if DEVICE == "cuda":
        eng._dispatch = sync_free_dispatch
    sync()
    t0 = time.perf_counter()
    for _ in range(10):
        eng.step()
    sync()
    host_ms = (time.perf_counter() - t0) * 1e2
    dev = device_ms(eng.step, 10)
    if eng.sched.queued != 1 or eng.slots[0].dispatched != 25:
        fail("serving busy share: the window was not 24 single steps with "
             "every slot live")
    del eng
    return host_ms, dev


def quant_costs(spec, comp, ecfg, params, qparams, card):
    """Device ms per decode step (all layers, SERVE_SLOTS rows,
    ``graph_ms``) of the two converts the quantized path adds: the layer weight
    products (``wdot``) with bf16 weights and with int8 weights, whose
    convert writes a bf16 copy of every weight per call; and grouped
    decode attention over the whole capacity with a bf16 and an int8
    cache, whose products convert the cache slice per layer."""
    from scope_tpu_torch.cache import slot_mask
    from scope_tpu_torch.models import llama
    from scope_tpu_torch.ops import quant
    from scope_tpu_torch.ops.common import wdot
    B, L, D = SERVE_SLOTS, spec.num_layers, spec.head_dim
    Hkv, G = spec.num_kv_heads, spec.num_kv_groups
    cap = ecfg.cache_capacity(comp)
    g = torch.Generator(device=DEVICE).manual_seed(0)
    rows = {n: params["layers"][n].shape[1] for n in quant.WEIGHT_NAMES}
    xs = {n: torch.randn((B, 1, r), generator=g, device=DEVICE,
                         dtype=torch.bfloat16) for n, r in rows.items()}

    def products(pr):
        layers = [{n: a[l] for n, a in pr["layers"].items()}
                  for l in range(L)]
        return lambda: [wdot(xs[n], p, n) for p in layers for n in xs]

    k = torch.randn((B, Hkv, cap, D), generator=g, device=DEVICE,
                    dtype=torch.bfloat16)
    q = torch.randn((B, Hkv * G, 1, D), generator=g, device=DEVICE,
                    dtype=torch.bfloat16)
    length = torch.full((B,), cap, dtype=torch.int32, device=DEVICE)
    mask = slot_mask(length, length[:, None].expand(B, Hkv), 0, cap)
    ki = quant.quantize(k, quant.calibrate(k))

    def attention(kc):
        return lambda: [llama._grouped_decode_attention(q, kc, kc, mask, G)
                        for _ in range(L)]

    t = {"w_bf16": graph_ms(products(params), 10),
         "w_int8": graph_ms(products(qparams), 10),
         "a_bf16": graph_ms(attention(k), 10),
         "a_int8": graph_ms(attention(ki), 10)}
    if None in t.values():
        print(f"quantized path's converts: not measured {t}; card {card}",
              flush=True)
        return t
    print(f"quantized path's converts, device ms per decode step ({L} "
          f"layers, {B} rows, CUDA-graph replays): weight products bf16 "
          f"{t['w_bf16']:.3f}, int8 {t['w_int8']:.3f} (+"
          f"{t['w_int8'] - t['w_bf16']:.3f} for the per-call convert); "
          f"grouped decode attention over {cap} slots, bf16 cache "
          f"{t['a_bf16']:.3f}, int8 cache {t['a_int8']:.3f} (+"
          f"{t['a_int8'] - t['a_bf16']:.3f}); card {card}", flush=True)
    return t


def serving_main(seed, card):
    """(f) Llama-3.2-1B at full width and depth, random bf16 weights, the
    main path's compression (h2o + jump, P=2048, w=8, W=512, r=256,
    delta=30) with per-kv-head eviction and chunked hot runs (16, 8):
    ServingEngine(max_slots=16, pipeline_depth=1) serves 24 ragged requests
    of 2100-3000 real tokens (the 4096 bucket) and 320-384 new tokens, with
    a bf16 cache and bf16 weights, then with int8 KV and int8 weights.
    Returns the bf16 run's launch counts."""
    from scope_tpu_torch.engine.generate import StreamingGenerator
    from scope_tpu_torch.engine.serving import ServingEngine
    from scope_tpu_torch.ops import quant
    spec, comp, ecfg, _ = main_config()
    comp = comp.replace(evict_per_qhead=False)
    ecfg = ecfg.replace(decode_chunk_sizes=(16, 8))
    params, _, _ = main_inputs(spec, ecfg, 16, seed)
    reqs = serving_requests(spec, seed)
    L = spec.num_layers
    launches = {}
    for kv, w8 in (("bfloat16", False), ("int8", True)):
        what = (f"serving (f) {spec.name} kv={kv} weights="
                f"{'int8' if w8 else 'bf16'}")
        p = quant.quantize_layer_weights(params) if w8 else params
        e = ecfg.replace(kv_dtype=kv)
        sync()
        if DEVICE == "cuda":
            torch.cuda.reset_peak_memory_stats()
        eng = ServingEngine(spec, comp, e, p, max_slots=SERVE_SLOTS,
                            pipeline_depth=1, device=DEVICE)
        rec = instrument(eng)
        ids = [eng.submit(q, n) for q, n in reqs]
        t0 = time.perf_counter()
        try:
            res, got = counted(what, L, len(reqs), eng.run)
            sync()
        finally:
            rec["undo"]()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() if DEVICE == "cuda" else 0
        toks = [res[i] for i in ids]
        if [len(t) for t in toks] != [n for _, n in reqs]:
            fail(f"{what}: token counts {[len(t) for t in toks]}, asked "
                 f"{[n for _, n in reqs]}")
        if bool(rec["bad"]):
            fail(f"{what}: non-finite logits")
        if rec["partial"] < 1:
            fail(f"{what}: no force step gated only part of the active rows "
                 f"({rec['force']} force steps)")
        if rec["mirror_off"] or rec["finished"] != len(reqs):
            fail(f"{what}: mirror and cache lengths differ at finish: "
                 f"{rec['mirror_off'][:4]} ({rec['finished']} finished)")
        if any(not (0 <= t < spec.vocab_size) for seq in toks for t in seq):
            fail(f"{what}: token out of the vocabulary")
        m = [eng.request_metrics[i] for i in ids]
        ttft = [x["ttft_s"] * 1e3 for x in m]
        tpot = [x["tpot_s"] * 1e3 for x in m]
        n_dec = sum(len(t) - 1 for t in toks)       # first tokens: prefill
        t1 = time.perf_counter()
        step_ms, dev_ms = serving_busy_share(spec, comp, e, p, reqs)
        busy = ("not measured" if dev_ms is None else
                f"{dev_ms:.2f} ms of device time, busy share "
                f"{dev_ms / step_ms:.3f}")
        print(f"{what}: {len(reqs)} requests on {SERVE_SLOTS} slots, "
              f"{n_dec} decode tokens in {wall:.2f} s = {n_dec / wall:.1f} "
              f"tok/s aggregate (the admissions' prefills inside the "
              f"window); TTFT median {np.median(ttft):.1f} ms, p95 "
              f"{pct(ttft, 95):.1f} ms (queueing included); TPOT median "
              f"{np.median(tpot):.2f} ms, p95 "
              f"{pct(tpot, 95):.2f} ms; peak memory {peak / 2**30:.2f} GiB; "
              f"{rec['force']} force steps, {rec['partial']} gating part of "
              f"the active rows; mirror = cache length at all {rec['finished']}"
              f" finishes; launches {got} ({L} of each per admission); "
              f"hot step with all {SERVE_SLOTS} slots live {step_ms:.2f} ms "
              f"on the host ({busy} under the profiler), dispatch free of "
              f"host syncs; run {wall:.1f} s, step and profile "
              f"{time.perf_counter() - t1:.1f} s; card {card}", flush=True)
        if w8:
            quant_costs(spec, comp, e, params, p, card)
        else:
            launches = got
            q0 = reqs[0][0]
            padded = np.zeros((1, e.bucket_for(len(q0))), np.int32)
            padded[0, :len(q0)] = q0
            errs, _, _ = teacher_forced(spec, comp, e, p, padded,
                                        np.array([len(q0)], np.int32),
                                        toks[0], torch.stack(rec["logits"]))
            print(f"{what}: request 0 teacher-forced at B=1 on its served "
                  f"tokens, logits against its B=16 ones norm-wise over "
                  f"{len(errs)} steps: max {max(errs):.3g}, median "
                  f"{np.median(errs):.3g} (tolerance {BATCH_LOGIT_REL}); "
                  f"card {card}", flush=True)
            if not max(errs) <= BATCH_LOGIT_REL:
                fail(f"{what}: B=1 and B=16 logits of request 0 differ by "
                     f"{max(errs):.3g} norm-wise")
            t1 = time.perf_counter()
            sg = StreamingGenerator(spec, comp, e, p, eos_ids=(),
                                    device=DEVICE)
            agree, first = [], []
            n_req, n_new = SINGLE_STREAM
            for (q, _), seq in list(zip(reqs, toks))[:n_req]:
                padded = np.zeros((1, e.bucket_for(len(q))), np.int32)
                padded[0, :len(q)] = q
                one = sg.generate(padded, np.array([len(q)], np.int32), n_new)
                first.append(int(one.tokens[0, 0]) == seq[0])
                agree.append(float(np.mean(one.tokens[0]
                                           == np.array(seq[:n_new]))))
            print(f"{what}: first token identical to StreamingGenerator's "
                  f"for {sum(first)} of {len(first)} requests; agreement of "
                  f"their first {n_new} tokens "
                  f"{[round(a, 4) for a in agree]} "
                  f"(batched bf16 decode against B=1), in "
                  f"{time.perf_counter() - t1:.1f} s; card {card}",
                  flush=True)
            if not all(first):
                fail(f"{what}: first tokens differ from StreamingGenerator's")
        del eng, rec
    return launches


# ---------------------------------------------------------------------------
# phase 3, methods: (g) SnapKV, StreamingLLM, PyramidKV and headwise
# ---------------------------------------------------------------------------

def decode_run(spec, comp, ecfg, params, toks, tl, n_steps, device, host,
               chunk=None):
    """Prefill (chunked, ``chunk`` tokens at a time, when given), then
    n_steps greedy decode steps on the host path (HostScheduledDecoder.step,
    B=1) or in cond mode: tokens [B, n+1] and the per-layer lengths [L, B]
    after prefill and after each step."""
    from scope_tpu_torch.engine.host_loop import HostScheduledDecoder
    from scope_tpu_torch.models import llama
    from scope_tpu_torch.models.chunked_prefill import prefill_chunked
    ttl = torch.as_tensor(tl, device=device)
    tt = torch.as_tensor(toks, device=device)
    if chunk:
        logits, cache, state = prefill_chunked(spec, comp, ecfg, params, tt,
                                               ttl, chunk_size=chunk)
    else:
        logits, cache, state = llama.prefill(spec, comp, ecfg, params, tt,
                                             ttl)
    if host:
        dec = HostScheduledDecoder(spec, comp, ecfg)
        sched = dec.new_scheduler(int(tl[0]), prompt_pad=toks.shape[1])
    tok = logits.argmax(-1).to(torch.int32)
    out, lengths = [tok.cpu()], [cache.length.tolist()]
    for s in range(n_steps):
        if host:
            logits, cache, state = dec.step(sched, params, tok, ttl + s,
                                            cache, state)
        else:
            logits, cache, state = llama.decode_step(
                spec, comp, ecfg, params, tok, ttl + s, cache, state)
        if not torch.isfinite(logits).all():
            fail(f"{comp.method}+{comp.decoding_metric}: non-finite logits")
        tok = logits.argmax(-1).to(torch.int32)
        out.append(tok.cpu())
        lengths.append(cache.length.tolist())
    return torch.stack(out, 1).numpy(), lengths


def small_comp(method, metric, **kw):
    from scope_tpu_torch import CompressionConfig
    return CompressionConfig(
        method=method, decoding_metric=metric, max_capacity_prompt=64,
        window_size=32 if method == "streamingllm" else 8,
        decoding_window_size=32, decoding_recent_size=16, delta=3,
        headwise_max_budget=64, headwise_min_budget=16, headwise_gamma=0.5,
        **kw)


# (method, metric, host path, layers): the small model's method runs.
SMALL_METHODS = [("snapkv", "jump", True, 2), ("streamingllm", "slm", True, 2),
                 ("pyramidkv", "pyramidinfer", True, 2),
                 ("pyramidkv", "pyramidinfer", False, 2),
                 ("pyramidkv", "jump", True, 2), ("pyramidkv", "jump", False, 2),
                 ("headwise", "jump", False, 4)]


def small_methods_check(seed):
    """(g) small: the 2-layer D=64 float32 model (4 layers for headwise,
    whose first three are not compressed) on the card against the CPU, each
    method's tokens and per-layer lengths identical at every step: host
    path at B=1, cond mode at B=2 ragged; then the ServingEngine (3 slots,
    5 requests) for pyramidkv + jump (device cond, per-row counters) and
    snapkv + jump (host mode)."""
    from scope_tpu_torch import EngineConfig
    from scope_tpu_torch.models import llama
    ecfg = EngineConfig(max_prompt_len=256, max_new_tokens=48,
                        dtype="float32")
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, 512, (2, 256)).astype(np.int32)
    tl = np.array([230, 171], np.int32)
    weights, done = {}, []
    for method, metric, host, layers in SMALL_METHODS:
        spec = small_spec(layers)
        if layers not in weights:
            g = torch.Generator(device="cpu").manual_seed(seed)
            p_cpu = llama.init_params(spec, g, torch.float32, device="cpu")
            weights[layers] = (p_cpu, on_card(p_cpu))
        p_cpu, p_gpu = weights[layers]
        comp = small_comp(method, metric, evict_per_qhead=not host)
        B = 1 if host else 2
        what = (f"small model {method}+{metric} "
                f"{'host path' if host else 'cond mode'}")
        (got, lens), _ = counted(what, per_prefill(spec, comp), 1,
                                 lambda: decode_run(spec, comp, ecfg, p_gpu,
                                                    toks[:B], tl[:B], 47,
                                                    DEVICE, host))
        ref, ref_lens = decode_run(spec, comp, ecfg, p_cpu, toks[:B], tl[:B],
                                   47, "cpu", host)
        if not (got == ref).all() or lens != ref_lens:
            fail(f"{what}: card and CPU differ (tokens from "
                 f"{first_difference(got[0], ref[0])}, lengths "
                 f"{lens != ref_lens})")
        # A step that fires ends no longer than it began.
        if not any((np.array(b) <= np.array(a)).any()
                   for a, b in zip(lens, lens[1:])):
            fail(f"{what}: no decode compression fired")
        done.append(f"{method}+{metric} {'host' if host else 'cond'} "
                    f"(lengths {lens[0]} -> {lens[-1]})")
    reqs = [(rng.integers(1, 512, n).astype(np.int32), m)
            for n, m in ((230, 40), (171, 33), (120, 45), (250, 24),
                         (90, 38))]
    for method in ("pyramidkv", "snapkv"):
        spec = small_spec(2)
        p_cpu, p_gpu = weights[2]
        comp = small_comp(method, "jump", evict_per_qhead=False)
        got = serve(spec, comp, ecfg, p_gpu, reqs, DEVICE, 3,
                    f"small serving {method}+jump")
        ref = serve(spec, comp, ecfg, p_cpu, reqs, "cpu", 3, "")
        if got != ref or [len(t) for t in got] != [m for _, m in reqs]:
            fail(f"small serving {method}+jump: card and CPU differ at "
                 f"{[first_difference(a, b) for a, b in zip(got, ref)]}")
        done.append(f"serving {method}+jump (5 requests, 3 slots)")
    print(f"methods (g) small model (D=64, float32), card kernels vs CPU "
          f"plain versions, tokens and per-layer lengths identical at every "
          f"step: {'; '.join(done)}", flush=True)


def methods_config(method, per_qhead):
    """(g) at Llama-3.2-1B: the main path's model and knobs with another
    prefill method and jump decode.  streamingllm's window is the
    reference's P // 2; headwise budgets 2048 tokens at most, 128 at
    least, to coverage 0.95; pyramidkv's 4090-token prompt takes its deep
    branch (shallow layers keep up to 3986 tokens)."""
    spec, comp, ecfg, _ = main_config()
    comp = comp.replace(method=method, evict_per_qhead=per_qhead)
    if method == "streamingllm":
        comp = comp.replace(window_size=comp.max_capacity_prompt // 2)
    if method == "headwise":
        comp = comp.replace(headwise_max_budget=2048,
                            headwise_min_budget=128, headwise_gamma=0.95)
    return spec, comp, ecfg, 4090 if method == "pyramidkv" else 3000


def method_path(spec, comp, ecfg, n_prompt, seed, card):
    """(g) one method at 1B: StreamingGenerator on the host path (timed),
    the cond-mode loop as the reference, and the host path teacher-forced
    on its tokens (per-layer lengths and fire steps identical, logits
    within LOGIT_REL); headwise runs cond mode only.  Returns the
    launches of the run the user's entry point made."""
    from scope_tpu_torch.compression.host_sched import pyramid_prefill_kept
    from scope_tpu_torch.engine.generate import StreamingGenerator
    L = spec.num_layers
    host = comp.method != "headwise"
    name = (f"methods (g) {spec.name} {comp.method}+{comp.decoding_metric} "
            f"evict_per_qhead={comp.evict_per_qhead}")
    cap = ecfg.cache_capacity(comp)
    params, toks, tl = main_inputs(spec, ecfg, n_prompt, seed)
    expect = per_prefill(spec, comp)
    sync()
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    timed = ""
    if host:
        sg = StreamingGenerator(spec, comp, ecfg, params, eos_ids=(),
                                device=DEVICE)
        if sg.host_decoder is None or (
                sg.host_decoder.layered != (comp.method == "pyramidkv")):
            fail(f"{name}: StreamingGenerator did not take the host path")
        res, launches = counted(f"{name} StreamingGenerator", expect, 1,
                                lambda: sg.generate(toks, tl, N_NEW))
        seq = res.tokens[0]
        if res.gen_lengths[0] != N_NEW or not (
                (seq >= 0) & (seq < spec.vocab_size)).all():
            fail(f"{name}: bad tokens {seq[:8]}...")
        timed = (f"StreamingGenerator (host path) TTFT {res.ttft_s * 1e3:.1f}"
                 f" ms, {rate(res.tpot_s)}; ")
    (got, cond_tpot, lengths, logs, pvalid), launches_c = counted(
        f"{name} cond", expect, 1, lambda: cond_run(
            spec, comp, ecfg, params, toks, tl, N_NEW - 1))
    peak = torch.cuda.max_memory_allocated() if DEVICE == "cuda" else 0
    if not host:
        launches = launches_c
    top = max(max(x) for x in lengths)
    if top > cap:
        fail(f"{name}: a cache length {top} exceeded capacity {cap}")
    extra = ""
    if comp.method == "pyramidkv":
        kept = pyramid_prefill_kept(comp, L, n_prompt, toks.shape[1])
        if lengths[0] != kept:
            fail(f"{name}: prefill lengths {lengths[0]}, expected {kept}")
        extra = f"prefill lengths {kept[0]}..{kept[-1]} of capacity {cap}; "
    if comp.method == "headwise":
        pv = pvalid[:, 0].cpu()                                  # [L, H]
        gap, low = comp.headwise_max_budget, comp.headwise_min_budget
        full = min(n_prompt, gap)
        if not (((pv >= low) & (pv <= gap)).all()
                and (pv[:3] == full).all()):
            fail(f"{name}: pvalid outside [{low}, {gap}] or layers 0-2 not "
                 f"at {full}: {pv.tolist()}")
        extra = (f"pvalid layers 0-2 = {full}, layers 3-{L - 1} "
                 f"{int(pv[3:].min())}..{int(pv[3:].max())}; ")
    waves = wave_steps(lengths)
    if not waves:
        fail(f"{name}: no decode compression fired in {N_NEW} tokens")
    if host:
        (errs, h_lengths, mirror), _ = counted(
            f"{name} host, teacher-forced", expect, 1, lambda: teacher_forced(
                spec, comp, ecfg, params, toks, tl, got, logs))
        if h_lengths != lengths:
            s = next(i for i, (a, b) in enumerate(zip(h_lengths, lengths))
                     if a != b)
            fail(f"{name}: host and cond per-layer lengths differ after "
                 f"decode step {s - 1}: {h_lengths[s]} vs {lengths[s]}")
        if any(x != m for x, m in zip(h_lengths[1:], mirror)):
            fail(f"{name}: the host mirror's lengths left the cache's")
        worst = max(errs)
        if not worst <= LOGIT_REL:
            fail(f"{name}: teacher-forced logits off by {worst:.3g} "
                 f"norm-wise at step {int(np.argmax(errs))}")
        extra += (f"host = cond per-layer lengths at all {N_NEW - 1} steps, "
                  f"teacher-forced logits max {worst:.3g} (tolerance "
                  f"{LOGIT_REL}), free-running agreement "
                  f"{np.mean(seq == np.array(got)):.4f}; ")
    del logs
    print(f"{name}: {timed}cond mode TTFT {cond_tpot[0] * 1e3:.1f} ms, "
          f"{rate(cond_tpot)}; peak memory {peak / 2**30:.2f} GiB; {extra}"
          f"fire steps {waves[:6]}; launches per prefill {launches}; card "
          f"{card}", flush=True)
    return launches


SERVE_G = dict(slots=8, requests=12, prompt=(2100, 4090), new=128)


def serving_methods(seed, card):
    """(g) serving at 1B on the device-cond path: pyramidkv + jump,
    per-kv-head eviction, 8 slots, 12 requests of 2100-4090 real tokens and
    128 new tokens.  Exact token counts, no non-finite logits, every
    slot's per-layer lengths within capacity at each finish, 16 launches
    of each kernel per admission."""
    from scope_tpu_torch.engine.serving import ServingEngine
    from scope_tpu_torch.models import llama
    spec, comp, ecfg, _ = methods_config("pyramidkv", False)
    cap = ecfg.cache_capacity(comp)
    params, _, _ = main_inputs(spec, ecfg, 16, seed)
    rng = np.random.default_rng(seed + 2)
    n = SERVE_G["requests"]
    reqs = [(rng.integers(1, spec.vocab_size, int(k)).astype(np.int32),
             SERVE_G["new"]) for k in rng.integers(*SERVE_G["prompt"], n)]
    sync()
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    eng = ServingEngine(spec, comp, ecfg, params,
                        max_slots=SERVE_G["slots"], pipeline_depth=1,
                        device=DEVICE)
    if eng._host_mode or eng.state.step.shape != (SERVE_G["slots"],):
        fail("serving (g): pyramidkv + jump did not take the device-cond "
             "path with per-row counters")
    over, bad = [], torch.zeros((), dtype=torch.bool, device=eng.device)
    finish, decode_step = eng._finish, llama.decode_step

    def fin(slot):
        top = int(eng.cache.length[:, slot].max())
        if top > cap:
            over.append((slot, top))
        finish(slot)

    def checked(*a, **k):
        nonlocal bad
        out = decode_step(*a, **k)
        bad = bad | ~torch.isfinite(out[0]).all()
        return out
    eng._finish, llama.decode_step = fin, checked
    ids = [eng.submit(q, m) for q, m in reqs]
    what = f"serving (g) {spec.name} pyramidkv+jump device-cond"
    t0 = time.perf_counter()
    try:
        res, got = counted(what, per_prefill(spec, comp), n, eng.run)
        sync()
    finally:
        llama.decode_step = decode_step
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if DEVICE == "cuda" else 0
    toks = [res[i] for i in ids]
    if [len(t) for t in toks] != [m for _, m in reqs]:
        fail(f"{what}: token counts {[len(t) for t in toks]}")
    if bool(bad) or over:
        fail(f"{what}: non-finite logits ({bool(bad)}) or lengths over "
             f"capacity {cap} at finish {over[:4]}")
    m = [eng.request_metrics[i] for i in ids]
    ttft = [x["ttft_s"] * 1e3 for x in m]
    tpot = [x["tpot_s"] * 1e3 for x in m]
    n_dec = sum(len(t) - 1 for t in toks)
    print(f"{what}: {n} requests on {SERVE_G['slots']} slots, {n_dec} decode "
          f"tokens in {wall:.2f} s = {n_dec / wall:.1f} tok/s aggregate "
          f"(admissions inside); TTFT median {np.median(ttft):.1f} ms, p95 "
          f"{pct(ttft, 95):.1f} ms; TPOT median {np.median(tpot):.2f} ms; "
          f"peak memory {peak / 2**30:.2f} GiB; lengths within capacity {cap}"
          f" at all {n} finishes; launches {got}; card {card}", flush=True)


def methods_main(seed, card):
    """(g) at 1B: each method's path, pyramidkv's at both eviction
    granularities, then pyramidkv's layered host path under the sync check
    and the device-cond serving run.  Returns snapkv's launches (the
    need_scores=False route's)."""
    launches = {}
    for method, per_qhead in (("snapkv", False), ("streamingllm", False),
                              ("pyramidkv", True), ("pyramidkv", False),
                              ("headwise", False)):
        spec, comp, ecfg, n_prompt = methods_config(method, per_qhead)
        got = method_path(spec, comp, ecfg, n_prompt, seed, card)
        launches.setdefault(method, got)
    spec, comp, ecfg, n_prompt = methods_config("pyramidkv", False)
    sync_free(spec, comp, ecfg, n_prompt, seed)
    serving_methods(seed, card)
    return launches["snapkv"]


# ---------------------------------------------------------------------------
# phase (h): Quest, chunked prefill and chunked admission
# ---------------------------------------------------------------------------

def per_chunked(spec, comp, lens, chunk):
    """Each kernel's launches over chunked prefills of ``lens`` real
    tokens (one prefill each; a batch counts as its longest row) in chunks
    of ``chunk``: every chunk attends through flash_prefill
    (need_scores=False) in every layer, and each finalize pass scores the
    staged prompt with flash_prefill (scored) and colsum_scores in every
    layer of the methods that rank by cumulative attention."""
    L = spec.num_layers
    chunks = sum(-(-int(n) // chunk) for n in lens)
    scored = L * len(lens) if comp.method in ("h2o", "pyramidkv") else 0
    return {"flash_prefill": L * chunks + scored, "colsum_scores": scored}


# (metric, host path, quest_decode_pages, kv dtype): the small model's
# Quest runs.
SMALL_QUEST = [("none", True, 0, "bfloat16"), ("none", False, 0, "bfloat16"),
               ("fixed", True, 0, "bfloat16"), ("fixed", False, 0, "bfloat16"),
               ("jump", True, 0, "bfloat16"), ("jump", False, 0, "bfloat16"),
               ("none", True, 4, "bfloat16"), ("none", False, 4, "bfloat16"),
               ("jump", False, 0, "int8")]
SMALL_CHUNK = 64


def small_quest_check(seed):
    """(h) small: the 2-layer D=64 float32 model on the card against the
    CPU, tokens and per-layer lengths identical at every step: Quest (one
    skip layer) with none / fixed / jump on the host path (B=1) and in cond
    mode (B=2 ragged), the paged decode region, int8 KV; Quest served on 3
    slots; chunked prefill on the card against the CPU's monolithic prefill
    for h2o, snapkv, pyramidkv and quest; chunked admission on the card
    against monolithic admission on the CPU."""
    from scope_tpu_torch import EngineConfig
    from scope_tpu_torch.models import llama
    spec = small_spec()
    ecfg = EngineConfig(max_prompt_len=256, max_new_tokens=48,
                        dtype="float32")
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, 512, (2, 256)).astype(np.int32)
    tl = np.array([230, 171], np.int32)
    g = torch.Generator(device="cpu").manual_seed(seed)
    p_cpu = llama.init_params(spec, g, torch.float32, device="cpu")
    p_gpu = on_card(p_cpu)
    done = []

    def same(what, comp, e, B, host, chunk=None):
        (got, lens), _ = counted(
            what, per_chunked(spec, comp, [max(tl[:B])], chunk) if chunk
            else per_prefill(spec, comp), 1, lambda: decode_run(
                spec, comp, e, p_gpu, toks[:B], tl[:B], 47, DEVICE, host,
                chunk=chunk))
        ref, ref_lens = decode_run(spec, comp, e, p_cpu, toks[:B], tl[:B],
                                   47, "cpu", host)
        if not (got == ref).all() or lens != ref_lens:
            fail(f"{what}: card and CPU differ (tokens from "
                 f"{first_difference(got[0], ref[0])}, lengths "
                 f"{lens != ref_lens})")
        return lens

    for metric, host, pages, kv in SMALL_QUEST:
        comp = small_comp("quest", metric, quest_skip_layers=1,
                          quest_decode_pages=pages, evict_per_qhead=host)
        what = (f"small model quest+{metric} pages={pages} kv={kv} "
                f"{'host path' if host else 'cond mode'}")
        lens = same(what, comp, ecfg.replace(kv_dtype=kv), 1 if host else 2,
                    host)
        done.append(f"quest+{metric}{f' pages={pages}' if pages else ''}"
                    f"{' int8' if kv == 'int8' else ''} "
                    f"{'host' if host else 'cond'} (lengths {lens[0]} -> "
                    f"{lens[-1]})")
    for method in ("h2o", "snapkv", "pyramidkv", "quest"):
        comp = small_comp(method, "jump", quest_skip_layers=1,
                          evict_per_qhead=False)
        same(f"small model {method}+jump chunked prefill (card) vs "
             f"monolithic (CPU)", comp, ecfg, 2, False, chunk=SMALL_CHUNK)
        done.append(f"{method} chunked (C={SMALL_CHUNK}) = monolithic")
    reqs = [(rng.integers(1, 512, n).astype(np.int32), m)
            for n, m in ((230, 40), (171, 33), (120, 45), (250, 24),
                         (90, 38))]
    for method, chunk in (("quest", None), ("h2o", SMALL_CHUNK)):
        comp = small_comp(method, "jump", quest_skip_layers=1,
                          evict_per_qhead=False)
        e = ecfg.replace(decode_chunk_sizes=(8, 4))
        got = serve(spec, comp, e, p_gpu, reqs, DEVICE, 3,
                    f"small serving {method}+jump prefill_chunk={chunk}",
                    prefill_chunk=chunk)
        ref = serve(spec, comp, e, p_cpu, reqs, "cpu", 3, "")
        if got != ref or [len(t) for t in got] != [m for _, m in reqs]:
            fail(f"small serving {method}+jump prefill_chunk={chunk}: card "
                 f"and CPU differ at "
                 f"{[first_difference(a, b) for a, b in zip(got, ref)]}")
        how = (f", chunked admission (C={chunk}) vs monolithic" if chunk
               else "")
        done.append(f"served {method}+jump, 5 requests on 3 slots{how}")
    print(f"quest/chunked (h) small model (D=64, float32), card kernels vs "
          f"CPU plain versions, tokens and per-layer lengths identical at "
          f"every step: {'; '.join(done)}", flush=True)


def quest_config(per_qhead):
    """(h) at Llama-3.2-1B: Quest + jump with 16-token pages and two dense
    skip layers at the main path's knobs; capacity 12160 (the whole prompt
    and every decode token: Quest evicts nothing from the prompt)."""
    spec, comp, ecfg, n_prompt = main_config()
    comp = comp.replace(method="quest", evict_per_qhead=per_qhead,
                        chunk_size=16, quest_skip_layers=2)
    return spec, comp, ecfg, n_prompt


QUEST_CAPACITY = 12160


def quest_path(spec, comp, ecfg, n_prompt, seed, card):
    """(h) Quest at 1B: StreamingGenerator on the host path (timed), cond
    mode as the reference (per-layer lengths and fire steps identical at
    every step, waves of two consecutive steps, the skip layers never
    shrinking), and the host path teacher-forced on cond mode's tokens with
    its length and decode-region buckets pinned to the whole cache (logits
    within LOGIT_REL).  Returns the entry point's launches."""
    from scope_tpu_torch.engine.generate import StreamingGenerator
    name = (f"quest (h) {spec.name} quest+{comp.decoding_metric} "
            f"evict_per_qhead={comp.evict_per_qhead}")
    cap = ecfg.cache_capacity(comp)
    if cap != QUEST_CAPACITY:
        fail(f"{name}: capacity {cap}, expected {QUEST_CAPACITY}")
    params, toks, tl = main_inputs(spec, ecfg, n_prompt, seed)
    expect = per_prefill(spec, comp)
    sync()
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    sg = StreamingGenerator(spec, comp, ecfg, params, eos_ids=(),
                            device=DEVICE)
    if sg.host_decoder is None or not sg.host_decoder.quest:
        fail(f"{name}: StreamingGenerator did not take the quest host path")
    res, launches = counted(f"{name} StreamingGenerator", expect, 1,
                            lambda: sg.generate(toks, tl, N_NEW))
    peak = torch.cuda.max_memory_allocated() if DEVICE == "cuda" else 0
    seq = res.tokens[0]
    if res.gen_lengths[0] != N_NEW or not (
            (seq >= 0) & (seq < spec.vocab_size)).all():
        fail(f"{name}: bad tokens {seq[:8]}...")
    (got, cond_tpot, lengths, logs, _), _ = counted(
        f"{name} cond", expect, 1, lambda: cond_run(
            spec, comp, ecfg, params, toks, tl, N_NEW - 1))
    (errs, h_lengths, mirror), _ = counted(
        f"{name} host, teacher-forced", expect, 1, lambda: teacher_forced(
            spec, comp, ecfg, params, toks, tl, got, logs))
    del logs
    if h_lengths != lengths:
        s = next(i for i, (a, b) in enumerate(zip(h_lengths, lengths))
                 if a != b)
        fail(f"{name}: host and cond per-layer lengths differ after decode "
             f"step {s - 1}: {h_lengths[s]} vs {lengths[s]}")
    if any(x != m for x, m in zip(h_lengths[1:], mirror)):
        fail(f"{name}: the host mirror's lengths left the cache's")
    # A fire step ends no longer than it began in some layer (a layer that
    # fires again right after its wave keeps its length).
    waves = [s - 1 for s in range(1, len(lengths))
             if any(b <= a for a, b in zip(lengths[s - 1], lengths[s]))]
    skip = comp.quest_skip_layers
    if (len(waves) < 2 or waves[1] != waves[0] + 1
            or any(x[l] != n_prompt + s for s, x in enumerate(lengths)
                   for l in range(skip))):
        fail(f"{name}: fire steps {waves[:6]} (expected pairs of "
             f"consecutive steps) or a skip layer's length left prompt + "
             f"step")
    if max(max(x) for x in lengths) > cap:
        fail(f"{name}: a cache length exceeded capacity {cap}")
    worst = max(errs)
    if not worst <= LOGIT_REL:
        fail(f"{name}: teacher-forced logits off by {worst:.3g} norm-wise "
             f"at decode step {int(np.argmax(errs))} (tolerance {LOGIT_REL})")
    print(f"{name}: StreamingGenerator (host path) TTFT "
          f"{res.ttft_s * 1e3:.1f} ms, {rate(res.tpot_s)}; cond mode TTFT "
          f"{cond_tpot[0] * 1e3:.1f} ms, {rate(cond_tpot)}; peak memory "
          f"{peak / 2**30:.2f} GiB (cache capacity {cap}); host = cond "
          f"per-layer lengths at all {N_NEW - 1} steps, fire steps "
          f"{waves[:6]} (two-step waves), skip layers at prompt + step; "
          f"teacher-forced "
          f"logits max {worst:.3g}, median {np.median(errs):.3g} (tolerance "
          f"{LOGIT_REL}); free-running agreement "
          f"{np.mean(seq == np.array(got)):.4f}; launches per prefill "
          f"{launches}; card {card}", flush=True)
    return launches


SERVE_H = dict(slots=8, requests=12, prompt=(2100, 3000), new=128)
PREFILL_CHUNK = 512


def serve_1b(spec, comp, ecfg, params, reqs, expect, prefills, what,
             prefill_chunk=None):
    """Serve reqs on SERVE_H's slots: (tokens per request, TTFT ms per
    request, aggregate decode tok/s, the longest host gap between two
    decode dispatches in ms, peak GiB, launches, TPOT ms per request).
    Fails on a wrong token count or a non-finite logit."""
    from scope_tpu_torch.engine.serving import ServingEngine
    from scope_tpu_torch.models import llama
    sync()
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    eng = ServingEngine(spec, comp, ecfg, params, max_slots=SERVE_H["slots"],
                        pipeline_depth=1, prefill_chunk=prefill_chunk,
                        device=DEVICE)
    if not eng._host_mode:
        fail(f"{what}: not in host mode")
    bad = torch.zeros((), dtype=torch.bool, device=eng.device)
    stamps, dispatch, decode_step = [], eng._dispatch, llama.decode_step

    def timed_dispatch():
        stamps.append(time.perf_counter())
        dispatch()

    def checked(*a, **k):
        nonlocal bad
        out = decode_step(*a, **k)
        bad = bad | ~torch.isfinite(out[0]).all()
        return out
    eng._dispatch, llama.decode_step = timed_dispatch, checked
    ids = [eng.submit(q, m) for q, m in reqs]
    t0 = time.perf_counter()
    try:
        res, launches = counted(what, expect, prefills, eng.run)
        sync()
    finally:
        llama.decode_step = decode_step
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if DEVICE == "cuda" else 0
    toks = [res[i] for i in ids]
    if [len(t) for t in toks] != [m for _, m in reqs] or bool(bad):
        fail(f"{what}: token counts {[len(t) for t in toks]} or non-finite "
             f"logits ({bool(bad)})")
    ttft = [eng.request_metrics[i]["ttft_s"] * 1e3 for i in ids]
    tpot = [eng.request_metrics[i]["tpot_s"] * 1e3 for i in ids]
    gap = max(np.diff(stamps)) * 1e3 if len(stamps) > 1 else 0.0
    n_dec = sum(len(t) - 1 for t in toks)
    return toks, ttft, n_dec / wall, gap, peak / 2**30, launches, tpot


def chunked_prefill_check(spec, comp, ecfg, params, prompt, card):
    """One prompt through ChunkedPrefiller (PREFILL_CHUNK) and through the
    monolithic prefill: logits within LOGIT_REL norm-wise, the same first
    token and per-layer lengths, each kernel launched as per_chunked and
    per_prefill say; and both warm times (host clock, synchronised)."""
    from scope_tpu_torch.models import llama
    from scope_tpu_torch.models.chunked_prefill import ChunkedPrefiller
    toks = np.zeros((1, ecfg.bucket_for(len(prompt))), np.int32)
    toks[0, :len(prompt)] = prompt
    tt = torch.as_tensor(toks, device=DEVICE)
    ttl = torch.tensor([len(prompt)], dtype=torch.int32, device=DEVICE)
    chunker = ChunkedPrefiller(spec, comp, ecfg, chunk_size=PREFILL_CHUNK)

    def timed(fn):
        fn()
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, (time.perf_counter() - t0) * 1e3
    what = f"chunked prefill (h) {spec.name} {comp.method}"
    ((lc, cc, _), t_c), _ = counted(
        what, {k: 2 * n for k, n in per_chunked(
            spec, comp, [len(prompt)], PREFILL_CHUNK).items()}, 1,
        lambda: timed(lambda: chunker(params, tt, ttl)))
    ((lm, cm, _), t_m), _ = counted(
        f"{what} monolithic", per_prefill(spec, comp), 2,
        lambda: timed(lambda: llama.prefill(spec, comp, ecfg, params, tt,
                                            ttl)))
    err = float((lc.float() - lm.float()).norm() / lm.float().norm())
    same_tok = int(lc.argmax(-1)[0]) == int(lm.argmax(-1)[0])
    same_len = torch.equal(cc.length, cm.length)
    print(f"{what}, {len(prompt)} tokens in chunks of {PREFILL_CHUNK}: "
          f"logits against the monolithic prefill's {err:.3g} norm-wise "
          f"(tolerance {LOGIT_REL}), first token equal {same_tok}, per-layer "
          f"lengths equal {same_len}; warm {t_c:.1f} ms chunked (every chunk "
          f"and the finalize pass) against {t_m:.1f} ms monolithic; card "
          f"{card}", flush=True)
    if not (err <= LOGIT_REL and same_tok and same_len):
        fail(f"{what}: differs from the monolithic prefill")


def serving_quest_chunked(seed, card):
    """(h) serving at 1B, per-kv-head eviction, 8 slots, 12 requests of
    2100-3000 tokens and 128 new: Quest + jump in host mode, per-slot
    QuestHostScheduler mirrors; then h2o + jump with chunked admission
    (prefill_chunk=512) against monolithic admission: first tokens equal,
    TTFT and the longest gap between decode dispatches of both.  Returns
    the chunked run's launches."""
    spec, comp, ecfg, _ = quest_config(False)
    params, _, _ = main_inputs(spec, ecfg, 16, seed)
    rng = np.random.default_rng(seed + 3)
    n = SERVE_H["requests"]
    reqs = [(rng.integers(1, spec.vocab_size, int(k)).astype(np.int32),
             SERVE_H["new"]) for k in rng.integers(*SERVE_H["prompt"], n)]
    what = f"serving (h) {spec.name} quest+jump"
    _, ttft, tps, gap, peak, got, tpot = serve_1b(
        spec, comp, ecfg, params, reqs, per_prefill(spec, comp), n, what)
    print(f"{what}: {n} requests on {SERVE_H['slots']} slots, {tps:.1f} "
          f"tok/s aggregate; TTFT median {np.median(ttft):.1f} ms, p95 "
          f"{pct(ttft, 95):.1f} ms; TPOT median {np.median(tpot):.2f} ms; "
          f"longest gap between decode dispatches "
          f"{gap:.1f} ms; peak memory {peak:.2f} GiB; launches {got}; card "
          f"{card}", flush=True)
    comp = comp.replace(method="h2o")
    chunked_prefill_check(spec, comp, ecfg, params, reqs[0][0], card)
    runs = {}
    for chunk in (PREFILL_CHUNK, None):
        what = (f"serving (h) {spec.name} h2o+jump "
                f"{f'prefill_chunk={chunk}' if chunk else 'monolithic'}")
        expect, prefills = ((per_chunked(spec, comp, [len(q) for q, _ in
                                          reqs], chunk), 1) if chunk
                            else (per_prefill(spec, comp), n))
        runs[chunk] = serve_1b(spec, comp, ecfg, params, reqs, expect,
                               prefills, what, prefill_chunk=chunk)
        toks, ttft, tps, gap, peak, launches, tpot = runs[chunk]
        print(f"{what}: {n} requests on {SERVE_H['slots']} slots, {tps:.1f} "
              f"tok/s aggregate; TTFT median {np.median(ttft):.1f} ms, p95 "
              f"{pct(ttft, 95):.1f} ms; TPOT median {np.median(tpot):.2f} "
              f"ms; longest gap between decode "
              f"dispatches {gap:.1f} ms; peak memory {peak:.2f} GiB; "
              f"launches {launches}; card {card}", flush=True)
    chunked, mono = runs[PREFILL_CHUNK][0], runs[None][0]
    firsts = [a[0] == b[0] for a, b in zip(chunked, mono)]
    agree = np.mean([np.mean(np.array(a) == np.array(b))
                     for a, b in zip(chunked, mono)])
    print(f"serving (h) chunked vs monolithic admission: first tokens equal "
          f"in {sum(firsts)} of {n} requests; token agreement {agree:.4f} "
          f"(batched bf16 decode parts greedy streams of random weights); "
          f"card {card}", flush=True)
    if not all(firsts):
        fail(f"serving (h): chunked admission's first tokens differ from "
             f"monolithic admission's in requests "
             f"{[i for i, f in enumerate(firsts) if not f]}")
    return runs[PREFILL_CHUNK][5]


def quest_main(seed, card):
    """(h) at 1B: Quest's path at both eviction granularities, its host
    path under the sync check, then serving.  Returns (the quest prefill's
    launches, the chunked admissions' launches)."""
    launches = None
    for per_qhead in (True, False):
        spec, comp, ecfg, n_prompt = quest_config(per_qhead)
        launches = quest_path(spec, comp, ecfg, n_prompt, seed, card)
    sync_free(spec, comp, ecfg, n_prompt, seed)
    return launches, serving_quest_chunked(seed, card)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs the port on an NVIDIA card")
    sys.path.insert(0, HERE)
    import scope_tpu_torch
    if not os.path.abspath(scope_tpu_torch.__file__).startswith(HERE):
        fail(f"scope_tpu_torch imported from {scope_tpu_torch.__file__}, "
             f"not from this checkout")
    from scope_tpu_torch.ops import build
    t0 = time.time()
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t = time.time()
    logs = build.build()
    print(f"build: {len(logs)} sources compiled in {time.time() - t:.1f} s "
          f"into {build.BUILD_DIR}", flush=True)
    for source, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {source}: {line.split(':', 1)[-1].strip()}")

    def phase(name, fn, *a):
        t = time.time()
        out = fn(*a)
        print(f"phase {name}: {time.time() - t:.1f} s", flush=True)
        return out

    timing = phase("kernels", check_kernels, args.seed)
    phase("small model", small_model_check, args.seed)
    spec, comp, ecfg, n_prompt = main_config()
    launches = {}
    for per_qhead in (True, False):
        launches = phase(f"main path per_qhead={per_qhead}", main_path, spec,
                         comp.replace(evict_per_qhead=per_qhead), ecfg,
                         n_prompt, args.seed, card)
    phase("sync check", sync_free, spec, comp, ecfg, n_prompt, args.seed)
    phase("serving (e)", serving_small_check, args.seed)
    serve_launches = phase("serving (f)", serving_main, args.seed, card)
    t = time.time()
    phase("methods (g) small model", small_methods_check, args.seed)
    unscored_launches = phase("methods (g) Llama-3.2-1B", methods_main,
                              args.seed, card)
    print(f"phase methods (g): {time.time() - t:.1f} s", flush=True)
    t = time.time()
    phase("quest/chunked (h) small model", small_quest_check, args.seed)
    quest_launches, chunk_launches = phase(
        "quest/chunked (h) Llama-3.2-1B", quest_main, args.seed, card)
    print(f"phase quest/chunked (h): {time.time() - t:.1f} s", flush=True)
    if any(m.split(".")[0] in ("jax", "jaxlib", "flax", "scope_tpu")
           for m in sys.modules):
        fail("the port loaded JAX or the JAX package")

    flash = ("scope_tpu_torch/csrc/flash_prefill.cu",
             "scope_tpu/ops/pallas/flash_prefill.py:179")
    sources = {"flash_prefill": flash,
               "colsum_scores": ("scope_tpu_torch/csrc/colsum_scores.cu",
                                 "scope_tpu/ops/pallas/flash_prefill.py:299"),
               UNSCORED: flash}
    sdpa = ("F.scaled_dot_product_attention(is_causal=True), the attention "
            "half only")
    kernels = []
    for name, (src, replaces) in sources.items():
        bound_ms, bound_by = timing["bounds"][name]
        base = name.split("[")[0]
        entry = {
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[base],
            "max_abs_err": timing["err"]["colsum" if base == "colsum_scores"
                                         else "out"],
            "ms": timing[name], "kernel_ms": timing[name],
            "plain_ms": timing[name + "_plain"], "bound_ms": bound_ms,
            "bound_by": bound_by, "design": timing["design"][base],
            "library_ms": timing["sdpa"] if base == "flash_prefill" else None,
            "library_real_rows_ms": (timing["sdpa_real_rows"]
                                     if base == "flash_prefill" else None),
            "library": sdpa if name == "flash_prefill" else None,
        }
        if base == "flash_prefill":
            # Chunked prefill's finalize scores: this kernel (scored, its
            # out discarded) plus colsum_scores.
            entry.update(
                scores_only_pair_ms=timing["scores_pair"],
                scores_only_blocked_torch_ms=timing["scores_blocked"],
                scores_only_out_half_ms=timing["scores_out_half"],
                scores_only_max_abs_err=timing["err"]["scores_only"])
        if name == UNSCORED:
            # Launched by snapkv's (and streamingllm's, headwise's)
            # prefill, phase (g); the same function as SDPA over the real
            # rows.
            entry.update(
                launches=unscored_launches["flash_prefill"],
                launches_quest_prefill=quest_launches["flash_prefill"],
                launches_chunk_attention=(chunk_launches["flash_prefill"]
                                          - chunk_launches["colsum_scores"]),
                max_abs_err=timing["err"][UNSCORED],
                library="F.scaled_dot_product_attention(is_causal=True), "
                        "the same function over the real rows")
        else:
            entry.update(
                launches_serving=serve_launches[name],
                launches_per_admission=serve_launches[name] // SERVE_REQUESTS,
                launches_chunked_finalize=chunk_launches["colsum_scores"],
                launches_per_chunked_finalize=(
                    chunk_launches["colsum_scores"] // SERVE_H["requests"]))
        kernels.append(entry)
    print(f"total {time.time() - t0:.1f} s; card {card}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
