"""starcoder2-3b [dense] — GQA, RoPE. [arXiv:2402.19173; hf]
30L d_model=3072 24H (GQA kv=2) d_ff=12288 vocab=49152."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b", family="dense",
    num_layers=30, d_model=3072, num_heads=24, num_kv_heads=2,
    d_ff=12288, vocab_size=49152, head_dim=128,
    layer_pattern="A", rope_kind="rope", rope_theta=100000.0,
)

REDUCED = CONFIG.scaled(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                        head_dim=16, d_ff=128, vocab_size=512,
                        attn_block_q=32, attn_block_kv=64)
