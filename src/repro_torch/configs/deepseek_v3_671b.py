"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed top-8, MTP
[arXiv:2412.19437; hf]. 61L d_model=7168 128H expert d_ff=2048 vocab=129280."""
from .base import ModelConfig

def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b", family="moe",
        n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128, head_dim=192,
        d_ff=18432, vocab=129280,
        n_experts=256, n_shared_experts=1, top_k=8, moe_d_ff=2048,
        first_dense_layers=3, router_fn="sigmoid", router_norm_topk=True,
        use_mla=True, q_lora_rank=1536, kv_lora_rank=512,
        qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
        mtp=True, rope_theta=1e4,
        param_dtype="bfloat16", activ_dtype="bfloat16")

def smoke_config() -> ModelConfig:
    return config().scaled(
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, head_dim=48,
        d_ff=128, vocab=256, n_experts=8, top_k=2, moe_d_ff=32,
        first_dense_layers=2, q_lora_rank=32, kv_lora_rank=16,
        qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
        capacity_factor=8.0,
        q_chunk=16, kv_chunk=16,
        param_dtype="float32", activ_dtype="float32")
