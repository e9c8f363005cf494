"""olmo-1b [dense] — non-parametric LN [arXiv:2402.00838; hf].
16L d_model=2048 16H (MHA kv=16) d_ff=8192 vocab=50304."""
from .base import ModelConfig

def config() -> ModelConfig:
    return ModelConfig(
        name="olmo-1b", family="dense",
        n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
        d_ff=8192, vocab=50304,
        norm_type="layernorm_np", tie_embeddings=True, rope_theta=1e4,
        param_dtype="bfloat16", activ_dtype="bfloat16")

def smoke_config() -> ModelConfig:
    return config().scaled(
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=256,
        q_chunk=16, kv_chunk=16,
        param_dtype="float32", activ_dtype="float32")
