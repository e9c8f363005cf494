"""rwkv6-7b [ssm] — Finch, data-dependent decay, attention-free
[arXiv:2404.05892; hf]. 32L d_model=4096 d_ff=14336 vocab=65536; head size 64."""
from .base import ModelConfig

def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-7b", family="ssm",
        n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64, head_dim=64,
        d_ff=14336, vocab=65536,
        rwkv_lora=64, rwkv_chunk=16,
        param_dtype="bfloat16", activ_dtype="bfloat16")

def smoke_config() -> ModelConfig:
    return config().scaled(
        n_layers=3, d_model=64, n_heads=2, n_kv_heads=2, head_dim=32,
        d_ff=128, vocab=256, rwkv_lora=16,
        q_chunk=16, kv_chunk=16,
        param_dtype="float32", activ_dtype="float32")
