"""Carry a parameter set of the JAX package into this package.

``params_from_jax`` takes the JAX package's parameter tree as numpy arrays
(``embed``, ``final_norm``, ``layers/{ln_attn, ln_mlp, wqkv, wo, w_gate,
w_up, w_down}``, optional ``lm_head``).  The two packages keep the same
layouts, fused kv-head-grouped ``wqkv`` included, so the conversion is a
dtype and device move: given the same weights, both compute the same thing.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from scope_tpu_torch.device import resolve_device

_TOP = ("embed", "final_norm", "lm_head")
_LAYER = ("ln_attn", "ln_mlp", "wqkv", "wo", "w_gate", "w_up", "w_down")


def _tensor(x, dev: torch.device, dtype: torch.dtype) -> torch.Tensor:
    # float32 first: numpy has no native bfloat16 that torch reads.
    arr = np.array(x, dtype=np.float32)
    return torch.from_numpy(arr).to(device=dev, dtype=dtype)


def params_from_jax(params_np: Mapping[str, Any], device="cuda",
                    dtype: torch.dtype = torch.bfloat16) -> dict:
    """JAX-package parameter tree (numpy arrays) -> this package's params."""
    dev = resolve_device(device)
    layers = params_np["layers"]
    unknown = (set(params_np) - set(_TOP) - {"layers"}) | (
        set(layers) - set(_LAYER))
    if unknown:
        raise NotImplementedError(
            f"parameters {sorted(unknown)} are not ported yet (quantized "
            f"weights: ROADMAP §1 item 10; qkv bias: item 13)")
    out = {name: _tensor(params_np[name], dev, dtype)
           for name in _TOP if name in params_np}
    out["layers"] = {name: _tensor(layers[name], dev, dtype)
                     for name in _LAYER}
    return out
