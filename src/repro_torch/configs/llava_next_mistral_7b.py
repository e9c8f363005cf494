"""llava-next-mistral-7b [vlm] — anyres tiling
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]. Mistral-7B backbone:
32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000. The vision frontend is
a stub: input_specs() supplies precomputed patch embeddings (576 base tokens)."""
from .base import ModelConfig

def config() -> ModelConfig:
    return ModelConfig(
        name="llava-next-mistral-7b", family="vlm",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=14336, vocab=32000,
        frontend="vision_stub", frontend_dim=1024, n_frontend_tokens=576,
        rope_theta=1e6,
        param_dtype="bfloat16", activ_dtype="bfloat16")

def smoke_config() -> ModelConfig:
    return config().scaled(
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, frontend_dim=32, n_frontend_tokens=8,
        q_chunk=16, kv_chunk=16,
        param_dtype="float32", activ_dtype="float32")
