"""seamless-m4t-large-v2 [audio] — enc-dec, multimodal [arXiv:2308.11596; hf].
24L(+24 enc) d_model=1024 16H (kv=16) d_ff=8192 vocab=256206. The audio
frontend is a stub: input_specs() supplies precomputed frame embeddings."""
from .base import ModelConfig

def config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2", family="audio",
        n_layers=24, n_enc_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
        head_dim=64, d_ff=8192, vocab=256206,
        frontend="audio_stub", frontend_dim=1024, act="gelu",
        rope_theta=1e4,
        param_dtype="bfloat16", activ_dtype="bfloat16")

def smoke_config() -> ModelConfig:
    return config().scaled(
        n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=16, d_ff=128, vocab=256, frontend_dim=32,
        q_chunk=16, kv_chunk=16,
        param_dtype="float32", activ_dtype="float32")
