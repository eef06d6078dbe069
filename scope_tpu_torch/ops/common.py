"""Core numerical ops shared by all model families.

HF-compatible semantics, as in the JAX package:
- RMSNorm computes the variance in float32 and casts back before the weight
  multiply, like ``LlamaRMSNorm``.
- RoPE uses the rotate-half convention with duplicated cos/sin, and supports
  Llama-3.1-style frequency scaling.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float
             ) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (weight * xf.to(dtype)).to(dtype)


def rope_inv_freq(head_dim: int, theta: float,
                  rope_scaling: Optional[Tuple[float, float, float, int]],
                  device=None) -> torch.Tensor:
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2,
                                             dtype=torch.float32,
                                             device=device) / head_dim))
    if rope_scaling is None:
        return inv_freq
    # Llama-3.1 rope scaling (matches HF ROPE_INIT_FUNCTIONS["llama3"]).
    factor, low_freq_factor, high_freq_factor, orig_max = rope_scaling
    low_freq_wavelen = orig_max / low_freq_factor
    high_freq_wavelen = orig_max / high_freq_factor
    wavelen = 2.0 * math.pi / inv_freq
    inv_freq_llama = torch.where(wavelen > low_freq_wavelen,
                                 inv_freq / factor, inv_freq)
    smooth = ((orig_max / wavelen - low_freq_factor)
              / (high_freq_factor - low_freq_factor))
    smoothed = ((1.0 - smooth) * inv_freq_llama / factor
                + smooth * inv_freq_llama)
    is_medium = (wavelen >= high_freq_wavelen) & (wavelen <= low_freq_wavelen)
    return torch.where(is_medium, smoothed, inv_freq_llama)


def rope_cos_sin(positions: torch.Tensor, inv_freq: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions [..., S] int -> cos/sin [..., S, head_dim] float32."""
    freqs = positions.float()[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x [B, H, S, D]; cos/sin [B, S, D] (or broadcastable)."""
    dtype = x.dtype
    cos = cos[:, None, :, :]
    sin = sin[:, None, :, :]
    xf = x.float()
    return (xf * cos + _rotate_half(xf) * sin).to(dtype)


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, H_kv, S, D] -> [B, H_kv * n_rep, S, D] (interleave like HF)."""
    if n_rep == 1:
        return x
    b, h, s, d = x.shape
    return x[:, :, None].expand(b, h, n_rep, s, d).reshape(b, h * n_rep, s, d)


def wdot(x: torch.Tensor, p, name: str) -> torch.Tensor:
    """Weight matmul ``x @ p[name]``, with optional weight-only int8.

    An int8 ``p[name]`` (``ops/quant.quantize_layer_weights``) is converted
    to x's dtype and the product scaled per output channel by
    ``p[name + "_scale"]``.  The convert writes a full-size copy of the
    weight on every call, where XLA fused it into the product's weight
    read; PERF.md has its cost on the card."""
    w = p[name]
    if w.dtype == torch.int8:
        return (x @ w.to(x.dtype)) * p[name + "_scale"].to(x.dtype)
    if w.dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(f"weight dtype {w.dtype} is not supported")
    return x @ w


def mlp(x: torch.Tensor, p) -> torch.Tensor:
    """SwiGLU MLP over a layer param dict (int8-weight aware)."""
    g = wdot(x, p, "w_gate")
    u = wdot(x, p, "w_up")
    return wdot(F.silu(g) * u, p, "w_down")
