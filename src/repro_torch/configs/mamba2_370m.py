"""mamba2-370m [ssm] — SSD (state-space duality). [arXiv:2405.21060]
48L d_model=1024 (attn-free) vocab=50280, ssm_state=128."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m", family="ssm",
    num_layers=48, d_model=1024, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50280, head_dim=0,
    layer_pattern="S", ssm_state=128, ssm_expand=2, ssm_headdim=64,
    ssm_conv=4, ssm_chunk=256, rope_kind="none", tie_embeddings=True,
)

REDUCED = CONFIG.scaled(num_layers=2, d_model=64, vocab_size=512,
                        ssm_state=16, ssm_headdim=16, ssm_chunk=32)
