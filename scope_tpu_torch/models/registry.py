"""Model specs for the families the reference targets (a copy of the JAX
package's registry; the two packages share no code)."""

from __future__ import annotations

from scope_tpu_torch.config import ModelSpec

_SPECS = {}


def register(spec: ModelSpec) -> ModelSpec:
    _SPECS[spec.name] = spec
    return spec


def get_spec(name: str) -> ModelSpec:
    key = name.lower()
    if key in _SPECS:
        return _SPECS[key]
    # Fall back to substring matching like the reference's model2maxlen table.
    for k, v in _SPECS.items():
        if k in key:
            return v
    raise KeyError(f"no ModelSpec for {name!r}; known: {sorted(_SPECS)}")


def list_specs():
    return dict(_SPECS)


LLAMA2_7B = register(ModelSpec(
    name="llama-2-7b", vocab_size=32000, hidden_size=4096,
    intermediate_size=11008, num_layers=32, num_heads=32, num_kv_heads=32,
    head_dim=128, rope_theta=10000.0, rms_norm_eps=1e-5,
    max_position_embeddings=4096, arch="llama"))

LLAMA3_8B = register(ModelSpec(
    name="llama-3-8b", vocab_size=128256, hidden_size=4096,
    intermediate_size=14336, num_layers=32, num_heads=32, num_kv_heads=8,
    head_dim=128, rope_theta=500000.0, rms_norm_eps=1e-5,
    max_position_embeddings=8192, arch="llama"))

LLAMA31_8B = register(ModelSpec(
    name="llama-3.1-8b", vocab_size=128256, hidden_size=4096,
    intermediate_size=14336, num_layers=32, num_heads=32, num_kv_heads=8,
    head_dim=128, rope_theta=500000.0, rms_norm_eps=1e-5,
    max_position_embeddings=131072,
    rope_scaling=(8.0, 1.0, 4.0, 8192), arch="llama"))

LLAMA32_1B = register(ModelSpec(
    name="llama-3.2-1b", vocab_size=128256, hidden_size=2048,
    intermediate_size=8192, num_layers=16, num_heads=32, num_kv_heads=8,
    head_dim=64, rope_theta=500000.0, rms_norm_eps=1e-5,
    max_position_embeddings=131072, tie_word_embeddings=True,
    rope_scaling=(32.0, 1.0, 4.0, 8192), arch="llama"))

LLAMA32_3B = register(ModelSpec(
    name="llama-3.2-3b", vocab_size=128256, hidden_size=3072,
    intermediate_size=8192, num_layers=28, num_heads=24, num_kv_heads=8,
    head_dim=128, rope_theta=500000.0, rms_norm_eps=1e-5,
    max_position_embeddings=131072, tie_word_embeddings=True,
    rope_scaling=(32.0, 1.0, 4.0, 8192), arch="llama"))

MISTRAL_7B = register(ModelSpec(
    name="mistral-7b", vocab_size=32000, hidden_size=4096,
    intermediate_size=14336, num_layers=32, num_heads=32, num_kv_heads=8,
    head_dim=128, rope_theta=10000.0, rms_norm_eps=1e-5,
    max_position_embeddings=32768, sliding_window=4096, arch="mistral"))

QWEN25_7B = register(ModelSpec(
    name="qwen2.5-7b", vocab_size=152064, hidden_size=3584,
    intermediate_size=18944, num_layers=28, num_heads=28, num_kv_heads=4,
    head_dim=128, rope_theta=1000000.0, rms_norm_eps=1e-6,
    max_position_embeddings=131072, attention_bias=True, arch="qwen2"))

QWEN25_1_5B = register(ModelSpec(
    name="qwen2.5-1.5b", vocab_size=151936, hidden_size=1536,
    intermediate_size=8960, num_layers=28, num_heads=12, num_kv_heads=2,
    head_dim=128, rope_theta=1000000.0, rms_norm_eps=1e-6,
    max_position_embeddings=32768, tie_word_embeddings=True,
    attention_bias=True, arch="qwen2"))

QWEN25_0_5B = register(ModelSpec(
    name="qwen2.5-0.5b", vocab_size=151936, hidden_size=896,
    intermediate_size=4864, num_layers=24, num_heads=14, num_kv_heads=2,
    head_dim=64, rope_theta=1000000.0, rms_norm_eps=1e-6,
    max_position_embeddings=32768, tie_word_embeddings=True,
    attention_bias=True, arch="qwen2"))

# Small configs for tests (CPU-friendly).
TINY_LLAMA = register(ModelSpec(
    name="tiny-llama", vocab_size=512, hidden_size=64,
    intermediate_size=128, num_layers=2, num_heads=4, num_kv_heads=2,
    head_dim=16, rope_theta=10000.0, rms_norm_eps=1e-5,
    max_position_embeddings=2048, arch="llama"))

TINY_MISTRAL = register(ModelSpec(
    name="tiny-mistral", vocab_size=512, hidden_size=64,
    intermediate_size=128, num_layers=2, num_heads=4, num_kv_heads=2,
    head_dim=16, rope_theta=10000.0, rms_norm_eps=1e-5,
    max_position_embeddings=2048, sliding_window=64, arch="mistral"))

TINY_QWEN2 = register(ModelSpec(
    name="tiny-qwen2", vocab_size=512, hidden_size=64,
    intermediate_size=128, num_layers=2, num_heads=4, num_kv_heads=2,
    head_dim=16, rope_theta=10000.0, rms_norm_eps=1e-6,
    max_position_embeddings=2048, attention_bias=True, arch="qwen2"))
