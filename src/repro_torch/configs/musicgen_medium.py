"""musicgen-medium [audio] — decoder-only over EnCodec tokens.
[arXiv:2306.05284; hf]  Backbone only: the EnCodec frontend is a STUB —
input_specs() provides precomputed frame embeddings.
48L d_model=1536 24H (kv=24) d_ff=6144 vocab=2048."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio",
    num_layers=48, d_model=1536, num_heads=24, num_kv_heads=24,
    d_ff=6144, vocab_size=2048, head_dim=64,
    layer_pattern="A", rope_kind="rope", input_mode="embeddings",
)

REDUCED = CONFIG.scaled(num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
                        head_dim=16, d_ff=128, vocab_size=128,
                        attn_block_q=32, attn_block_kv=64)
