"""mistral-large-123b [dense]. [hf:mistralai/Mistral-Large-Instruct-2407]
88L d_model=12288 96H (GQA kv=8) d_ff=28672 vocab=32768."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b", family="dense",
    num_layers=88, d_model=12288, num_heads=96, num_kv_heads=8,
    d_ff=28672, vocab_size=32768, head_dim=128,
    layer_pattern="A", rope_kind="rope", rope_theta=1000000.0,
)

REDUCED = CONFIG.scaled(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                        head_dim=16, d_ff=128, vocab_size=512,
                        attn_block_q=32, attn_block_kv=64)
