"""llama4-maverick-400b-a17b [moe] — MoE 128e top-1, GQA, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=8192, vocab_size=202048, head_dim=128,
    layer_pattern="M", num_experts=128, experts_per_token=1,
    rope_kind="rope", rope_theta=500000.0,
)

REDUCED = CONFIG.scaled(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                        head_dim=16, d_ff=96, vocab_size=512, num_experts=8,
                        experts_per_token=1, attn_block_q=32, attn_block_kv=64)
