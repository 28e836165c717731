"""kimi-k2-1t-a32b [moe] — Kimi K2, trillion-param MoE (paper-table).
[arXiv:2501.kimi2; unverified]
61L d_model=7168 64H (GQA kv=8) d_ff=2048 vocab=163840, MoE 384e top-8."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    num_layers=61, d_model=7168, num_heads=64, num_kv_heads=8,
    d_ff=2048, vocab_size=163840, head_dim=112,
    layer_pattern="M", num_experts=384, experts_per_token=8,
    rope_kind="rope", rope_theta=50000.0,
    # §Perf A1: head-parallel attention (64 heads / 16-way TP)
    attn_parallel="auto",
)

REDUCED = CONFIG.scaled(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                        head_dim=16, d_ff=64, vocab_size=512, num_experts=16,
                        experts_per_token=4, attn_block_q=32, attn_block_kv=64)
