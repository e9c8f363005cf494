"""qwen3-32b [dense] — qk_norm, GQA [hf:Qwen/Qwen3-8B; hf].
64L d_model=5120 64H (GQA kv=8) d_ff=25600 vocab=151936."""
from .base import ModelConfig

def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-32b", family="dense",
        n_layers=64, d_model=5120, n_heads=64, n_kv_heads=8, head_dim=128,
        d_ff=25600, vocab=151936,
        qk_norm=True, rope_theta=1e6,
        param_dtype="bfloat16", activ_dtype="bfloat16")

def smoke_config() -> ModelConfig:
    return config().scaled(
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256,
        q_chunk=16, kv_chunk=16,
        param_dtype="float32", activ_dtype="float32")
