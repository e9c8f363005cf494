"""gemma3-1b [dense] — 5:1 local:global, 128k context
[hf:google/gemma-3-1b-pt; unverified]. 26L d_model=1152 4H (GQA kv=1)
d_ff=6912 vocab=262144, qk-norm, sliding window 512 on local layers."""
from .base import ModelConfig

def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-1b", family="dense",
        n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1, head_dim=256,
        d_ff=6912, vocab=262144,
        local_per_global=5, window=512, qk_norm=True,
        rope_theta=1e4, rope_theta_global=1e6, act="gelu",
        embed_scale=True, tie_embeddings=True,
        param_dtype="bfloat16", activ_dtype="bfloat16")

def smoke_config() -> ModelConfig:
    return config().scaled(
        n_layers=6, d_model=64, n_heads=2, n_kv_heads=1, head_dim=32,
        d_ff=128, vocab=256, window=16, local_per_global=2,
        q_chunk=16, kv_chunk=16,
        param_dtype="float32", activ_dtype="float32")
