"""qwen1.5-110b [dense] — QKV bias [hf:Qwen/Qwen1.5-0.5B; hf].
80L d_model=8192 64H (GQA kv=8) d_ff=49152 vocab=152064."""
from .base import ModelConfig

def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-110b", family="dense",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
        d_ff=49152, vocab=152064,
        attn_bias=True, rope_theta=1e6,
        param_dtype="bfloat16", activ_dtype="bfloat16")

def smoke_config() -> ModelConfig:
    return config().scaled(
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256,
        q_chunk=16, kv_chunk=16,
        param_dtype="float32", activ_dtype="float32")
