"""qwen3-moe-30b-a3b [moe] — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B; hf].
48L d_model=2048 32H (GQA kv=4) expert d_ff=768 vocab=151936."""
from .base import ModelConfig

def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b", family="moe",
        n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=128,
        d_ff=768, vocab=151936,
        n_experts=128, top_k=8, moe_d_ff=768, router_norm_topk=True,
        qk_norm=True, rope_theta=1e6,
        param_dtype="bfloat16", activ_dtype="bfloat16")

def smoke_config() -> ModelConfig:
    return config().scaled(
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=64, vocab=256, n_experts=8, top_k=2, moe_d_ff=64,
        capacity_factor=8.0,
        q_chunk=16, kv_chunk=16,
        param_dtype="float32", activ_dtype="float32")
