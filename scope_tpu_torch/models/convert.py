"""Carry a parameter set of the JAX package into this package.

``params_from_jax`` takes the JAX package's parameter tree as numpy arrays
(``embed``, ``final_norm``, ``layers/{ln_attn, ln_mlp, wqkv, wo, w_gate,
w_up, w_down}``, optional ``lm_head``), including what its ``ops/quant``
adds: int8 layer weights with a float32 ``<name>_scale`` beside each, and
the materialized head ``lm_head_t`` with its optional
``lm_head_t_scale``.  The two packages keep the same layouts, fused
kv-head-grouped ``wqkv`` included, so the conversion is a dtype and device
move: given the same weights, both compute the same thing.  int8 stays
int8, scales stay float32, everything else takes ``dtype``.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from scope_tpu_torch.device import resolve_device
from scope_tpu_torch.ops.quant import WEIGHT_NAMES

_TOP = ("embed", "final_norm", "lm_head", "lm_head_t", "lm_head_t_scale")
_LAYER = ("ln_attn", "ln_mlp", "wqkv", "wo", "w_gate", "w_up", "w_down")
_SCALES = tuple(n + "_scale" for n in WEIGHT_NAMES)


def _tensor(name: str, x, dev: torch.device, dtype: torch.dtype
            ) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype == np.int8:
        return torch.from_numpy(np.array(arr)).to(dev)
    if name.endswith("_scale"):
        dtype = torch.float32
    # float32 first: numpy has no native bfloat16 that torch reads.
    return torch.from_numpy(np.array(arr, dtype=np.float32)).to(
        device=dev, dtype=dtype)


def params_from_jax(params_np: Mapping[str, Any], device="cuda",
                    dtype: torch.dtype = torch.bfloat16) -> dict:
    """JAX-package parameter tree (numpy arrays) -> this package's params."""
    dev = resolve_device(device)
    layers = params_np["layers"]
    unknown = (set(params_np) - set(_TOP) - {"layers"}) | (
        set(layers) - set(_LAYER) - set(_SCALES))
    if unknown:
        raise NotImplementedError(
            f"parameters {sorted(unknown)} are not ported yet (qkv bias: "
            f"ROADMAP §1 item 13, Qwen2)")
    out = {name: _tensor(name, params_np[name], dev, dtype)
           for name in _TOP if name in params_np}
    out["layers"] = {name: _tensor(name, arr, dev, dtype)
                     for name, arr in layers.items()}
    return out
