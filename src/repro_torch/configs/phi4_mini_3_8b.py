"""phi4-mini-3.8b [dense] — RoPE SwiGLU GQA. [arXiv:2412.08905; hf]
32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b", family="dense",
    num_layers=32, d_model=3072, num_heads=24, num_kv_heads=8,
    d_ff=8192, vocab_size=200064, head_dim=128,
    layer_pattern="A", rope_kind="rope", rope_theta=10000.0,
)

REDUCED = CONFIG.scaled(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                        head_dim=16, d_ff=128, vocab_size=512,
                        attn_block_q=32, attn_block_kv=64)
