"""recurrentgemma-2b [hybrid] — RG-LRU + local attn, 1:2. [arXiv:2402.19427]
26L d_model=2560 10H (GQA kv=1) d_ff=7680 vocab=256000, window 2048.
Pattern RRW: two recurrent blocks then one local-attention block."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    num_layers=26, d_model=2560, num_heads=10, num_kv_heads=1,
    d_ff=7680, vocab_size=256000, head_dim=256,
    layer_pattern="RRW", local_window=2048, rope_kind="rope",
    tie_embeddings=True, logit_softcap=30.0, rglru_conv=4,
)

REDUCED = CONFIG.scaled(num_layers=6, d_model=64, num_heads=4, num_kv_heads=1,
                        head_dim=16, d_ff=128, vocab_size=512, local_window=64,
                        attn_block_q=32, attn_block_kv=64)
