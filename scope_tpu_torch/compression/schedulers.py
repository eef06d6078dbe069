"""SCOPE decode-phase budget schedulers over the static slotted cache.

The fixed ("slide"), linear ("adaptive") and jump ("discontinuous")
schedulers and the method-specific h2o, slm (positional) and pyramidinfer
metrics share :func:`schedule_decision`.  The reference's cross-layer
class-attribute counters become an explicit :class:`SchedState` threaded
through the layer loop; each layer call does the same counter arithmetic as
one reference call, so the div-by-(delta * num_layers) schedule is the JAX
package's exactly.  With ``SchedState.init(batch=B)`` every batch row runs
its own counters (its own linear / jump schedule), which the serving
engine's device-cond path needs.

Two ways to apply a decision:
- cond mode (``llama.decode_step`` default): :func:`block_rewrite` asks
  ``row_gate.any()`` on the host, one device-to-host sync per layer per
  step, where the JAX package has a ``lax.cond``;
- host scheduling (``engine/host_loop.py``): the host mirrors the gates
  (``compression/host_sched.py``) and a force step rewrites at
  :func:`force_pseg` with the host's keep count.  The device is never
  asked whether to fire.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import torch

from scope_tpu_torch.compression.policies import topk_indices
from scope_tpu_torch.config import CompressionConfig
from scope_tpu_torch.ops.attention import NEG_INF


@dataclass
class SchedState:
    """Cross-layer scheduler counters (reference class attributes), as
    int32 tensors: scalars for one stream whose gates couple all batch rows,
    or [B] with ``init(batch=B)``, each row an independent request stream
    with its own linear / jump schedule."""

    step: torch.Tensor        # current_decoding_step (per layer call)
    jump_step: torch.Tensor
    jump_layer: torch.Tensor

    @staticmethod
    def init(device=None, batch: int = 0) -> "SchedState":
        def z():
            return torch.zeros((batch,) if batch else (), dtype=torch.int32,
                               device=device)
        return SchedState(step=z(), jump_step=z(), jump_layer=z())

    def replace(self, **kw) -> "SchedState":
        return dataclasses.replace(self, **kw)

    def reset_row(self, row: int) -> "SchedState":
        """Zero one row's counters (a new request admitted to that slot)."""
        def zeroed(x):
            x = x.clone()
            x[row] = 0
            return x
        return SchedState(step=zeroed(self.step),
                          jump_step=zeroed(self.jump_step),
                          jump_layer=zeroed(self.jump_layer))


class DecodeCaps(NamedTuple):
    """Static capacity knobs derived by the engine."""

    keep_cap: int            # static top-k size >= any W(t) - r
    capacity: int            # cache slot capacity S_max


def static_keep_cap(comp: CompressionConfig, max_new_tokens: int) -> int:
    """Static top-k size bounding the data-dependent keep count."""
    W = comp.decoding_window_size
    r = comp.decoding_recent_size
    P = comp.max_capacity_prompt
    m = comp.decoding_metric
    if m in ("fixed",):
        return W - r
    if m in ("linear", "jump"):
        return max(W - r, max_new_tokens // max(comp.delta, 1) + 1)
    if m == "pyramidinfer":
        min_num = (P + W - r) // 2
        max_num = (P + W - r) * 2 - min_num
        return max(P + W - r, max_num + W)
    # h2o / slm global metrics
    return P + W - r


def schedule_decision(comp: CompressionConfig, caps: DecodeCaps,
                      state: SchedState, length: torch.Tensor,
                      prompt_len: torch.Tensor, layer_idx: int,
                      num_layers: int):
    """Pure counter/gate logic for one layer call.

    length [B] includes the appended token.  Returns (row_gate [B] bool,
    n_keep [B] int32, pseg [B] int32, positional, state); positional is
    True only for the slm metric, which keeps the lowest slots."""
    metric = comp.decoding_metric
    W = comp.decoding_window_size
    r = comp.decoding_recent_size
    P = comp.max_capacity_prompt
    B = length.shape[0]
    dev = length.device
    i32 = torch.int32
    if comp.method == "allkv":
        pseg0 = prompt_len.to(i32)
    elif comp.method == "headwise":
        pseg0 = torch.full((B,), comp.headwise_max_budget, dtype=i32,
                           device=dev)
    else:
        pseg0 = torch.full((B,), P, dtype=i32, device=dev)
    thresh = comp.delta * num_layers
    pseg = pseg0
    positional = False

    if metric == "none":
        return (torch.zeros((B,), dtype=torch.bool, device=dev),
                torch.zeros((B,), dtype=i32, device=dev), pseg, False,
                state)
    if metric == "fixed":
        row_gate = length >= pseg0 + W
        n_keep = torch.full((B,), W - r, dtype=i32, device=dev)
    elif metric in ("linear", "jump"):
        w_t = r + torch.div(state.step, thresh, rounding_mode="floor")
        state = state.replace(step=state.step + 1)
        row_gate = length >= pseg0 + w_t
        n_keep = (w_t - r).to(i32).expand(B)
        if metric == "jump":
            # Scalar counters: one stream, the gate couples all rows.
            # Per-row counters: each row runs its own jump wave.
            gate = row_gate.any() if state.jump_step.dim() == 0 else row_gate
            counting = gate & (state.jump_step < thresh)
            wave = gate & (state.jump_step >= thresh)
            js = state.jump_step + counting.to(i32)
            jl = state.jump_layer + wave.to(i32)
            finished = jl >= num_layers
            zero = torch.zeros_like(js)
            state = state.replace(jump_step=torch.where(finished, zero, js),
                                  jump_layer=torch.where(finished, zero, jl))
            row_gate = row_gate & wave
    elif metric in ("h2o", "slm"):
        # Method-specific global metrics: gate like fixed, re-rank the
        # whole cache from slot 0 keeping P+W-r (by score for h2o, the
        # lowest slots for slm), plus the recent r.
        row_gate = length >= pseg0 + W
        n_keep = pseg0 + W - r
        pseg = torch.zeros((B,), dtype=i32, device=dev)
        positional = metric == "slm"
    elif metric == "pyramidinfer":
        # Decode-phase pyramid budgets over the whole cache.
        min_num = (P + W - r) // 2
        max_num = (P + W - r) * 2 - min_num
        steps = (max_num - min_num) // num_layers
        budget_l = max_num - layer_idx * steps
        row_gate = length >= pseg0 + W
        mid = length < (P - r) * 2 + W
        n_keep = torch.where(mid, P + W - r, budget_l + W).to(i32)
        pseg = torch.zeros((B,), dtype=i32, device=dev)
    else:
        raise ValueError(f"unknown decoding metric {metric!r}")

    keep_cap = min(caps.keep_cap, caps.capacity)
    region_len = (length - r - pseg).clamp(min=0)
    n_keep = torch.minimum(n_keep.clamp(min=0), region_len)
    n_keep = n_keep.clamp(max=keep_cap)
    n_keep = torch.minimum(n_keep, caps.capacity - r - pseg)
    return row_gate, n_keep.to(i32), pseg, positional, state


def block_width(comp: CompressionConfig, caps: DecodeCaps) -> int:
    """Static width of the rewritten region [pseg, pseg + blkW)."""
    return min(caps.keep_cap + comp.decoding_recent_size, caps.capacity)


def force_pseg(comp: CompressionConfig, batch: int,
               prompt_len: torch.Tensor) -> Tuple[torch.Tensor, bool]:
    """(pseg [B] int32, positional) for a host-planned force rewrite:
    method-specific metrics re-rank from slot 0 (slm positionally);
    allkv/fullkv protect the recorded prompt, headwise its reserved
    segment, everything else max_capacity_prompt."""
    positional = comp.decoding_metric == "slm"
    dev = prompt_len.device
    if comp.decoding_metric in ("h2o", "slm", "pyramidinfer"):
        return torch.zeros((batch,), dtype=torch.int32, device=dev), \
            positional
    if comp.method in ("allkv", "fullkv"):
        return prompt_len.to(torch.int32), positional
    pseg = (comp.headwise_max_budget if comp.method == "headwise"
            else comp.max_capacity_prompt)
    return torch.full((batch,), pseg, dtype=torch.int32, device=dev), \
        positional


def block_map(comp: CompressionConfig, caps: DecodeCaps,
              probs: torch.Tensor, length: torch.Tensor, pseg: torch.Tensor,
              n_keep: torch.Tensor, row_gate: torch.Tensor,
              positional: bool = False):
    """Src map restricted to the rewritten block [pseg, pseg + blkW):
    [top-n_keep of the decode region by score | last r | identity].

    probs: [B, H, S] float32 scores (this step's attention probabilities).
    positional=True keeps the lowest slot indices instead of the top
    scores (the slm metric).  Returns (src_blk [B, H, blkW] absolute slot
    indices int64, new_len [B] int32).  Rows where row_gate is False map
    to themselves."""
    B, H, S = probs.shape
    r = comp.decoding_recent_size
    keep_cap = min(caps.keep_cap, caps.capacity)
    blkW = block_width(comp, caps)
    dev = probs.device
    d = torch.arange(blkW, device=dev)
    pseg_b = pseg[:, None, None].long()
    len_b = length[:, None, None].long()
    s_idx = torch.arange(S, device=dev)
    score_region = (s_idx >= pseg_b) & (s_idx < len_b - r)       # [B, 1, S]
    if positional:
        sc = torch.where(score_region, -s_idx.float(), NEG_INF)
        sc = sc.expand(B, H, S)
    else:
        sc = torch.where(score_region, probs, NEG_INF)
    topk = topk_indices(sc, keep_cap)                            # [B, H, K]

    nk = n_keep[:, None, None].long()
    in_keep = d < nk
    in_rec = (d >= nk) & (d < nk + r)
    src_keep = topk[..., d.clamp(max=keep_cap - 1)]              # [B,H,blkW]
    src_rec = (len_b - r) + (d - nk)
    src_id = pseg_b + d
    src = torch.where(in_keep, src_keep, torch.where(in_rec, src_rec, src_id))
    src = torch.where(row_gate[:, None, None], src, src_id)
    new_len = torch.where(row_gate, pseg + n_keep + r, length)
    return src, new_len.to(torch.int32)


def gather_block(comp: CompressionConfig, caps: DecodeCaps,
                 probs: torch.Tensor, ck_l: torch.Tensor, cv_l: torch.Tensor,
                 length: torch.Tensor, pseg: torch.Tensor,
                 n_keep: torch.Tensor, row_gate: torch.Tensor,
                 positional: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The contents of [pseg, pseg + blkW) after the rewrite.

    ck_l/cv_l: [B, H, cap, D].  Returns (kblk, vblk [B, H, blkW, D],
    new_len [B]); ungated rows get their region unchanged."""
    B, H, cap, D = ck_l.shape
    src_blk, new_len = block_map(comp, caps, probs, length, pseg, n_keep,
                                 row_gate, positional)
    idx = src_blk.clamp(0, cap - 1)[..., None].expand(B, H, -1, D)
    return torch.gather(ck_l, 2, idx), torch.gather(cv_l, 2, idx), new_len


def block_rewrite(comp: CompressionConfig, caps: DecodeCaps,
                  probs: torch.Tensor, ck_l: torch.Tensor,
                  cv_l: torch.Tensor, length: torch.Tensor,
                  pseg: torch.Tensor, n_keep: torch.Tensor,
                  row_gate: torch.Tensor, positional: bool = False
                  ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor],
                             torch.Tensor]:
    """The block rewrite of the JAX package's ``block_rewrite_cond``.

    Returns :func:`gather_block`'s (kblk, vblk, new_len) when a row fires.
    When none fires, the region is unchanged and (None, None, length) is
    returned: there is nothing to write.  Deciding that costs one
    device-to-host sync (``row_gate.any()``)."""
    if not bool(row_gate.any()):
        return None, None, length
    return gather_block(comp, caps, probs, ck_l, cv_l, length, pseg, n_keep,
                        row_gate, positional)


def write_block(buf: torch.Tensor, l: int, start: torch.Tensor,
                blk: torch.Tensor) -> None:
    """buf[l, b, :, start[b]:start[b]+W] = blk[b], each start clamped so
    the block fits, as ``lax.dynamic_update_slice`` clamps it.  One
    index_put at the device's offsets [B] serves uniform and per-row
    offsets alike, with no host sync."""
    B, H, W = blk.shape[:3]
    dest = start.long().clamp(0, buf.shape[3] - W)[:, None, None] + \
        torch.arange(W, device=blk.device)                        # [B, 1, W]
    b_idx = torch.arange(B, device=blk.device)[:, None, None]
    h_idx = torch.arange(H, device=blk.device)[None, :, None]
    buf[l, b_idx, h_idx, dest] = blk
