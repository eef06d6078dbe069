"""Prefill attention with fused H2O eviction scoring: two CUDA kernels for
Hopper and their plain PyTorch versions.

``flash_prefill`` replaces the Pallas TPU kernel
``scope_tpu/ops/pallas/flash_prefill.py :: flash_prefill`` (``_flash_kernel``).
One online-softmax pass over K/V tiles gives the causal attention output
and, from the same QK^T tile, the row max ``m2`` and normalizer ``l2`` of
the reference's *scoring* softmax — which masks only pad keys and the
trailing w x w causal tail, so earlier rows see future keys.

``colsum_scores`` replaces ``... :: colsum_scores`` (``_colsum_kernel``).
Given (m2, l2) it recomputes QK^T and sums, per key, ``exp(s - m2) / l2``
over the real query rows: the H2O cumulative-attention score that
``compress_prefill`` ranks.

What bounds them on an H100: the ``exp``s, not bytes.  Both read O(S*D)
per (batch, head) and need 2*D operations and one ``exp`` per (row, key)
pair of the scoring side, which is non-causal, so it covers every key
below true_len for every row (below the diagonal the attention side's
probabilities are the scoring side's times one factor per row; the
flash kernel still evaluates them apart).  One ``exp`` on the
special-function units costs the time of ~240 bf16 tensor-core
operations, so at D=64
(Llama-3.2-1B) the ``exp``s set the bound and at D=128 (Llama-3.1-8B) the
tensor-core operations do.  What the design does: a QK^T tile is computed
once and feeds both softmaxes; tiles wholly above the diagonal, outside the
sliding window or past true_len skip the attention side (and past true_len
the scoring side); q-tiles and key tiles wholly past true_len do no work;
masks are built only on tiles that cross an edge; ``exp``s are single
``ex2.approx`` instructions with the scale, log2(e) and (in
``colsum_scores``) the normalizer folded into one multiply-add.  bf16 inputs
run on the tensor cores (``wgmma``), fed by TMA into a shared-memory double
buffer under mbarriers; float32 inputs keep float32 FMA products, so that
route stays within 2e-4 of the plain version.  PERF.md has the times.

On the bf16 route every row at or past true_len reads out = 0, m2 = 0,
l2 = 1; the plain version computes attention there.  Nothing reads those
rows (tests/test_torch_pad_rows.py).

``colsum_scores`` takes no atomics: one block owns a 64-key tile and walks
the query tiles in ascending order, so sums are the same on every run and
near-tied top-k picks cannot flip between runs.

Each wrapper runs its kernel for CUDA tensors (or raises) and the plain
version for CPU tensors; ``launches`` counts kernel launches only.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from scope_tpu_torch.ops import build

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures of the two entry points (csrc/*.cu): pointers, then ints,
# then the softmax scale, then the stream.
_SIGNATURES = {
    "scope_flash_prefill": [_P] * 7 + [_I] * 8 + [_F, _P],
    "scope_colsum_scores": [_P] * 6 + [_I] * 6 + [_F, _P],
}


def _kernel(source: str, name: str):
    """The C entry point ``name`` of ``source``, built at first use."""
    fn = getattr(build.load(source), name)
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
    return fn


def _check_inputs(what: str, true_len: torch.Tensor, *xs: torch.Tensor
                  ) -> torch.Tensor:
    q = xs[0]
    if q.dim() != 4:
        raise ValueError(f"{what}: expected [B, H, S, D], got {tuple(q.shape)}")
    B, H, S, D = q.shape
    for x in xs:
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{what}: q/k/v must share shape, dtype and "
                             f"device")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{what}: inputs must be contiguous and "
                             f"16-byte aligned")
    if q.dtype not in _DTYPES:
        raise ValueError(f"{what}: dtype {q.dtype} not supported "
                         f"(bfloat16 or float32)")
    if D not in _HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {D} not supported "
                         f"(kernels are built for {_HEAD_DIMS})")
    if B * H > 65535:
        raise ValueError(f"{what}: B*H = {B * H} exceeds the grid limit")
    if tuple(true_len.shape) != (B,):
        raise ValueError(f"{what}: true_len must be [B]")
    return true_len.to(device=q.device, dtype=torch.int32).contiguous()


# --------------------------------------------------------------------------
# flash_prefill
# --------------------------------------------------------------------------

def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  true_len: torch.Tensor, *, window_size: int,
                  need_scores: bool, sliding_window: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q/k/v: [B, H, S, D] -> (out [B,H,S,D] in q's dtype, m2 [B,H,S] f32,
    l2 [B,H,S] f32).  true_len: [B] real (non-pad) tokens per row; prompts
    are right-padded to S.  With ``need_scores=False``, m2=0 and l2=1."""
    if q.device.type == "cpu":
        return flash_prefill_reference(q, k, v, true_len,
                                       window_size=window_size,
                                       need_scores=need_scores,
                                       sliding_window=sliding_window)
    tl = _check_inputs("flash_prefill", true_len, q, k, v)
    if sliding_window is not None and sliding_window <= 0:
        raise ValueError("sliding_window must be positive or None")
    B, H, S, D = q.shape
    out = torch.empty_like(q)
    m2 = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    l2 = torch.empty_like(m2)
    fn = _kernel("flash_prefill.cu", "scope_flash_prefill")
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), tl.data_ptr(),
             out.data_ptr(), m2.data_ptr(), l2.data_ptr(),
             B, H, S, D, _DTYPES[q.dtype], window_size, int(need_scores),
             sliding_window or 0, 1.0 / math.sqrt(D),
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check("flash_prefill.cu", err)
    flash_prefill.launches += 1
    return out, m2, l2


flash_prefill.launches = 0


def _masks(S: int, tl: torch.Tensor, w: int, device):
    """Per-row (one batch row) key-real and scoring masks, [S, S] bool."""
    idx = torch.arange(S, device=device)
    qi, kj = idx[:, None], idx[None, :]
    key_real = kj < tl
    in_tail = (qi >= tl - w) & (kj >= tl - w) & (kj > qi)
    return qi, kj, key_real, key_real & ~in_tail


def flash_prefill_reference(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, true_len: torch.Tensor, *,
                            window_size: int, need_scores: bool,
                            sliding_window: Optional[int] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Plain version of :func:`flash_prefill`: dense over the S x S
    rectangle, same masks and guards, float32 softmax.  One batch row at a
    time to bound the [H, S, S] temporaries."""
    B, H, S, D = q.shape
    scale = 1.0 / math.sqrt(D)
    outs, m2s, l2s = [], [], []
    for b in range(B):
        tl = true_len[b].to(q.device)
        qf, kf, vf = q[b].float(), k[b].float(), v[b].float()
        s = torch.einsum("hqd,hkd->hqk", qf, kf) * scale
        qi, kj, key_real, score_mask = _masks(S, tl, window_size, q.device)
        attn_mask = (kj <= qi) & key_real
        if sliding_window is not None:
            attn_mask = attn_mask & (kj > qi - sliding_window)
        s_attn = torch.where(attn_mask, s, NEG_INF)
        m = s_attn.amax(dim=-1, keepdim=True)
        p = torch.where(s_attn > NEG_INF / 2, torch.exp(s_attn - m), 0.0)
        del s_attn
        l = p.sum(dim=-1, keepdim=True)
        # Probabilities round to v's dtype before the PV product, as in
        # the TPU kernel.
        o = torch.einsum("hqk,hkd->hqd", p.to(v.dtype).float(), vf)
        del p
        outs.append((o / torch.where(l > 0, l, 1.0)).to(q.dtype))
        if need_scores:
            s_sc = torch.where(score_mask, s, NEG_INF)
            m2 = s_sc.amax(dim=-1)
            p2 = torch.where(s_sc > NEG_INF / 2,
                             torch.exp(s_sc - m2[..., None]), 0.0)
            m2s.append(m2)
            l2s.append(p2.sum(dim=-1))
        else:
            m2s.append(torch.zeros((H, S), dtype=torch.float32,
                                   device=q.device))
            l2s.append(torch.ones((H, S), dtype=torch.float32,
                                  device=q.device))
    return torch.stack(outs), torch.stack(m2s), torch.stack(l2s)


# --------------------------------------------------------------------------
# colsum_scores
# --------------------------------------------------------------------------

def colsum_scores(q: torch.Tensor, k: torch.Tensor, true_len: torch.Tensor,
                  m2: torch.Tensor, l2: torch.Tensor, *, window_size: int
                  ) -> torch.Tensor:
    """Column sums of the scoring softmax given its row stats -> [B,H,S]
    float32 (q, k: [B, H, S, D]; m2, l2: [B, H, S] float32)."""
    if q.device.type == "cpu":
        return colsum_scores_reference(q, k, true_len, m2, l2,
                                       window_size=window_size)
    tl = _check_inputs("colsum_scores", true_len, q, k)
    B, H, S, D = q.shape
    for x in (m2, l2):
        if (x.shape != (B, H, S) or x.dtype != torch.float32
                or x.device != q.device or not x.is_contiguous()):
            raise ValueError("colsum_scores: m2/l2 must be contiguous "
                             "float32 [B, H, S] on q's device")
    out = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    fn = _kernel("colsum_scores.cu", "scope_colsum_scores")
    err = fn(q.data_ptr(), k.data_ptr(), tl.data_ptr(), m2.data_ptr(),
             l2.data_ptr(), out.data_ptr(), B, H, S, D, _DTYPES[q.dtype],
             window_size, 1.0 / math.sqrt(D),
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check("colsum_scores.cu", err)
    colsum_scores.launches += 1
    return out


colsum_scores.launches = 0


def colsum_scores_reference(q: torch.Tensor, k: torch.Tensor,
                            true_len: torch.Tensor, m2: torch.Tensor,
                            l2: torch.Tensor, *, window_size: int
                            ) -> torch.Tensor:
    """Plain version of :func:`colsum_scores`, dense over S x S."""
    B, H, S, D = q.shape
    scale = 1.0 / math.sqrt(D)
    outs = []
    for b in range(B):
        tl = true_len[b].to(q.device)
        s = torch.einsum("hqd,hkd->hqk", q[b].float(), k[b].float()) * scale
        qi, _, _, score_mask = _masks(S, tl, window_size, q.device)
        s_m = torch.where(score_mask, s, NEG_INF)
        del s
        safe_l = torch.where(l2[b] > 0, l2[b], 1.0)[..., None]
        p = torch.where(s_m > NEG_INF / 2,
                        torch.exp(s_m - m2[b][..., None]), 0.0) / safe_l
        p = torch.where(qi < tl, p, 0.0)
        outs.append(p.sum(dim=-2))
    return torch.stack(outs)
