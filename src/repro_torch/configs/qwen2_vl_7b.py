"""qwen2-vl-7b [vlm] — M-RoPE, dynamic resolution. [arXiv:2409.12191; hf]
Backbone only: the vision frontend is a STUB — input_specs() provides
precomputed patch embeddings + (t,h,w) position ids.
28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b", family="vlm",
    num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4,
    d_ff=18944, vocab_size=152064, head_dim=128,
    layer_pattern="A", rope_kind="mrope", mrope_sections=(16, 24, 24),
    input_mode="embeddings",
)

REDUCED = CONFIG.scaled(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                        head_dim=16, d_ff=128, vocab_size=512,
                        mrope_sections=(2, 3, 3),
                        attn_block_q=32, attn_block_kv=64)
