"""Typed, frozen configuration for the PyTorch SCOPE engine.

A copy of the JAX package's ``scope_tpu/config.py`` (the two packages share
no code): ``ModelSpec`` and ``CompressionConfig`` keep the same fields and
validation, ``EngineConfig`` keeps the shape, KV-dtype and chunk fields and the
capacity derivation, except that a pyramidkv cache holds its deep branch's
prefill (:func:`pyramid_prefill_max`; the TPU staging ring, lazy eviction
and ``uniform_lengths`` are left out on purpose).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

PREFILL_METHODS = (
    "fullkv",       # no compression, no decode scheduling state at all
    "allkv",        # no prefill compression; records prompt length
    "h2o",          # cumulative-attention heavy hitters
    "snapkv",       # observation-window pooled scoring
    "pyramidkv",    # layer-decayed budget, PyramidInfer-mode scoring
    "streamingllm", # positional sink + recent
    "quest",        # full prefill kept; per-step page selection
    "headwise",     # per-head coverage budget
)

DECODE_METRICS = (
    "none",         # no decode-phase compression
    "fixed",        # SCOPE "slide": steady-state cache P+W
    "linear",       # SCOPE "adaptive": W(t) grows 1 per delta steps
    "jump",         # SCOPE "discontinuous": burst compression waves
    "h2o",          # H2O-only: global top-k during decode
    "slm",          # StreamingLLM-only: positional during decode
    "pyramidinfer", # PyramidKV-only: pyramid budget over full cache
)

KV_DTYPES = ("bfloat16", "int8", "int4")


@dataclass(frozen=True)
class ModelSpec:
    """Architecture hyper-parameters of a dense decoder-only LLM."""

    name: str
    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5
    max_position_embeddings: int = 8192
    tie_word_embeddings: bool = False
    # Llama-3.1-style rope scaling: (factor, low_freq_factor, high_freq_factor,
    # original_max_position_embeddings); None = plain RoPE.
    rope_scaling: Optional[Tuple[float, float, float, int]] = None
    # Mistral-style sliding window attention; None = global attention.
    sliding_window: Optional[int] = None
    # Qwen2-style q/k/v projection bias (o_proj stays bias-free).
    attention_bias: bool = False
    arch: str = "llama"

    @property
    def num_kv_groups(self) -> int:
        return self.num_heads // self.num_kv_heads

    def replace(self, **kw) -> "ModelSpec":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class CompressionConfig:
    """Prefill policy x decode scheduler (the reference's knob set)."""

    method: str = "allkv"
    decoding_metric: str = "none"
    # P: prefill token budget.
    max_capacity_prompt: int = 2048
    # w: protected observation/recent window during prefill compression.
    window_size: int = 8
    kernel_size: int = 7
    pooling: str = "maxpool"
    # PyramidKV pyramid sharpness.
    beta: int = 20
    # W: decode-phase window budget.
    decoding_window_size: int = 512
    # r: protected recent window during decode compression.
    decoding_recent_size: int = 256
    # linear/jump growth period (see derive_delta).
    delta: int = 15
    # Quest page (chunk) size and skipped dense layers.
    chunk_size: int = 16
    quest_skip_layers: int = 2
    # Quest decode-region paging (0 = dense decode region).
    quest_decode_pages: int = 0
    # Headwise coverage budgeting.
    headwise_max_budget: int = 2048
    headwise_min_budget: int = 128
    headwise_gamma: float = 0.95
    # True: the reference's GQA-expanded per-query-head eviction (the cache
    # is num_heads wide); False: per-KV-head eviction (num_kv_heads wide).
    evict_per_qhead: bool = True
    # Reference Mistral decode-phase window slicing for compressed methods.
    mistral_window_parity: bool = False

    def __post_init__(self):
        if self.method not in PREFILL_METHODS:
            raise ValueError(f"unknown method {self.method!r}")
        if self.decoding_metric not in DECODE_METRICS:
            raise ValueError(f"unknown decoding metric {self.decoding_metric!r}")
        if self.method not in ("allkv", "fullkv", "quest"):
            if not self.max_capacity_prompt - self.window_size > 0:
                raise ValueError("max_capacity_prompt must exceed window_size")
        if self.decoding_metric != "none":
            if not self.decoding_window_size - self.decoding_recent_size > 0:
                raise ValueError("decoding_window_size must exceed decoding_recent_size")
        if self.quest_decode_pages:
            if self.method != "quest" or self.decoding_metric != "none":
                raise ValueError(
                    "quest_decode_pages requires method='quest' with "
                    "decoding_metric='none' (the schedulers score the "
                    "whole region; their bounded region gains nothing)")

    def replace(self, **kw) -> "CompressionConfig":
        return dataclasses.replace(self, **kw)


def derive_delta(output_max_len: int, decoding_window_size: int,
                 decoding_recent_size: int) -> int:
    """delta = (output_max_len - r) // (W - r), the reference runner's rule."""
    return max(1, (output_max_len - decoding_recent_size)
               // (decoding_window_size - decoding_recent_size))


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pyramid_prefill_max(comp: CompressionConfig) -> int:
    """The most prefill tokens any pyramidkv layer keeps, whatever the
    prompt.  The mid branch (prompts below 2(P - w)) keeps at most P + w;
    the deep branch keeps budget_l + w in layer l, and layer 0's budget
    reaches max_num = 2(P - w) - (P - w) // beta."""
    P, w = comp.max_capacity_prompt, comp.window_size
    max_num = (P - w) * 2 - (P - w) // comp.beta
    return max(P, max_num) + w


@dataclass(frozen=True)
class EngineConfig:
    """Engine-level shapes derived from model + compression config.

    The cache is a fixed-capacity slotted buffer, so these capacities bound
    the dynamic lengths the reference lets tensors take.
    """

    max_prompt_len: int = 8192        # S_cap: prompt bucket ceiling (padded)
    max_new_tokens: int = 4096
    prompt_pad_multiple: int = 128
    dtype: str = "bfloat16"           # activations and weights
    # KV cache storage: "bfloat16" (the compute dtype, whatever ``dtype``
    # is), "int8" (per-channel symmetric, calibrated once at prefill; the
    # scales fold into q and the attention output) or "int4" (two
    # asymmetric per-channel codes per byte; the zero points fold too).
    # See ops/quant.py.
    kv_dtype: str = "bfloat16"
    # Host-scheduled decode: run fire-free stretches as one
    # ``llama.decode_steps`` call of n steps, sizes tried largest first;
    # empty = one dispatch per step (per-token timing).  Eagerly a chunk
    # only skips the host read of each token, which measures no faster
    # (PERF.md §5); it is the JAX package's knob and the unit a captured
    # hot run would replay.
    decode_chunk_sizes: Tuple[int, ...] = ()

    def __post_init__(self):
        if self.kv_dtype not in KV_DTYPES:
            raise ValueError(f"unknown kv_dtype {self.kv_dtype!r}; one of "
                             f"{KV_DTYPES}")

    def cache_capacity(self, comp: CompressionConfig) -> int:
        """Physical slot capacity S_max of the per-layer KV buffer.

        fixed: steady-state P+W, +1 for the append-before-compress step.
        linear/jump: W grows to ~r + max_new/delta; jump additionally
        overshoots by up to delta tokens between waves.  The chunk slack
        term is the JAX package's, so capacities match it for every method
        but pyramidkv (see :func:`pyramid_prefill_max`).
        """
        P = comp.max_capacity_prompt
        W = comp.decoding_window_size
        r = comp.decoding_recent_size
        if comp.method in ("fullkv", "quest") or (
            comp.method == "allkv" and comp.decoding_metric == "none"
        ):
            return _round_up(self.max_prompt_len + self.max_new_tokens, 128)
        if comp.method == "allkv":
            # Full prefill is kept; only the decode region is bounded.
            base = self.max_prompt_len
        elif comp.method == "headwise":
            base = comp.headwise_max_budget
        elif comp.method == "pyramidkv":
            # The JAX package sizes this min(P, max_prompt_len), which the
            # deep branch's shallow layers overrun (ROADMAP §3).
            base = min(pyramid_prefill_max(comp), self.max_prompt_len)
        else:
            base = min(P, self.max_prompt_len)
        if comp.decoding_metric == "none":
            return _round_up(base + self.max_new_tokens, 128)
        if comp.decoding_metric == "pyramidinfer":
            min_num = (P + W - r) // 2
            max_num = (P + W - r) * 2 - min_num
            return _round_up(max(base, max_num + W) + r + 2, 128)
        w_final = self.decode_budget_cap(comp) + r
        slack = comp.delta + 2  # jump-wave overshoot + append slot
        if self.decode_chunk_sizes:
            slack += max(self.decode_chunk_sizes)
        return _round_up(base + w_final + slack, 128)

    def decode_budget_cap(self, comp: CompressionConfig) -> int:
        """Static cap on the data-dependent decode keep-count W(t) - r."""
        W = comp.decoding_window_size
        r = comp.decoding_recent_size
        if comp.decoding_metric in ("fixed", "h2o", "slm", "pyramidinfer"):
            return W - r
        # linear/jump: W(t) = r + steps//delta, steps <= max_new_tokens.
        return max(W - r, self.max_new_tokens // max(comp.delta, 1) + 1)

    def prompt_buckets(self) -> Tuple[int, ...]:
        """Padded prompt lengths: powers of two from the pad multiple."""
        buckets = []
        b = self.prompt_pad_multiple
        while b < self.max_prompt_len:
            buckets.append(b)
            b *= 2
        buckets.append(self.max_prompt_len)
        return tuple(buckets)

    def bucket_for(self, length: int) -> int:
        for b in self.prompt_buckets():
            if length <= b:
                return b
        raise ValueError(f"prompt length {length} exceeds max_prompt_len "
                         f"{self.max_prompt_len}")

    def replace(self, **kw) -> "EngineConfig":
        return dataclasses.replace(self, **kw)
