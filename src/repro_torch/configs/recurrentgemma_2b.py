"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, 1 attn : 2 recurrent
[arXiv:2402.19427; hf]. 26L d_model=2560 10H (GQA kv=1) d_ff=7680 vocab=256000."""
from .base import ModelConfig

def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b", family="hybrid",
        n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, head_dim=256,
        d_ff=7680, vocab=256000,
        block_pattern=("rg", "rg", "attn_local"), lru_width=2560, conv_width=4,
        window=2048, rope_theta=1e4, act="gelu",
        embed_scale=True, tie_embeddings=True,
        param_dtype="bfloat16", activ_dtype="bfloat16")

def smoke_config() -> ModelConfig:
    return config().scaled(
        n_layers=5, d_model=64, n_heads=2, n_kv_heads=1, head_dim=32,
        d_ff=128, vocab=256, lru_width=64, window=16,
        q_chunk=16, kv_chunk=16,
        param_dtype="float32", activ_dtype="float32")
