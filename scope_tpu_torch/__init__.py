"""scope_tpu_torch — SCOPE KV-cache compression in PyTorch, with the
prefill attention and eviction-scoring kernels written by hand in CUDA C++
for NVIDIA Hopper (sm_90a)."""

from scope_tpu_torch.config import CompressionConfig, EngineConfig, ModelSpec

__all__ = ["CompressionConfig", "EngineConfig", "ModelSpec"]
