"""Model configuration covering all assigned architecture families.

One frozen dataclass drives every family: dense GQA transformers, MLA
(MiniCPM3), MoE (Llama-4 / Kimi-K2), SSM (Mamba-2 SSD), hybrid RG-LRU +
local attention (RecurrentGemma), and the stub-frontend audio/VLM decoders
(MusicGen / Qwen2-VL).  `layer_pattern` encodes heterogeneous stacks as a
repeating unit, e.g. "RRA" = two RG-LRU blocks then one local-attention
block (RecurrentGemma's 1:2 ratio).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // num_heads

    # layer stack: one char per layer type, tiled to num_layers.
    #   A = global attention + MLP      L = MLA attention + MLP
    #   M = global attention + MoE      S = Mamba-2 (SSD) block
    #   R = RG-LRU recurrent block      W = local (windowed) attention + MLP
    layer_pattern: str = "A"

    # attention
    rope_kind: str = "rope"      # rope | mrope | none
    rope_theta: float = 10000.0
    local_window: int = 0        # for W layers
    attn_logit_softcap: float = 0.0
    attn_block_q: int = 512      # blockwise-attention tile sizes
    attn_block_kv: int = 1024
    # TP strategy for attention: "seq" stripes Q tiles over the model axis
    # (works for any head count); "head" shards heads (classic Megatron —
    # no per-layer seq<->TP reshard, requires H % model_axis == 0);
    # "auto" picks "head" when divisible.
    attn_parallel: str = "seq"
    # KV-cache precision: "int8" stores quantized K/V with per-vector
    # scales factored out of the attention dots (beyond-paper: halves the
    # decode memory term)
    kv_cache_dtype: str = "bfloat16"

    # MLA (minicpm3-style)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25

    # SSM (mamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256
    ssm_groups: int = 1

    # RG-LRU (recurrentgemma)
    rglru_conv: int = 4
    rglru_c: float = 8.0

    # frontends: "tokens" or "embeddings" (audio/vlm stubs feed embeddings)
    input_mode: str = "tokens"
    mrope_sections: tuple[int, ...] = ()   # head_dim split for M-RoPE (t,h,w)

    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    logit_softcap: float = 0.0

    # numerics / execution
    dtype: str = "bfloat16"
    remat: str = "full"          # full | dots | none

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def layers(self) -> str:
        """Full per-layer type string of length num_layers."""
        pat = self.layer_pattern
        return (pat * (self.num_layers // len(pat) + 1))[: self.num_layers]

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256 so the vocab/logits dim
        shards evenly on the model axis (MaxText-style padding)."""
        return -(-self.vocab_size // 256) * 256

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def scaled(self, **overrides) -> "ModelConfig":
        """A reduced copy (smoke tests) with the same family/pattern."""
        return dataclasses.replace(self, **overrides)

    # --- parameter counting (for 6ND roofline math) -----------------------
    def param_count(self) -> int:
        return _count_params(self, active_only=False)

    def active_param_count(self) -> int:
        return _count_params(self, active_only=True)


def _count_params(cfg: ModelConfig, active_only: bool) -> int:
    d = cfg.d_model
    total = cfg.vocab_size * d                      # embedding
    if not cfg.tie_embeddings:
        total += cfg.vocab_size * d                 # unembedding
    for kind in cfg.layers:
        total += 2 * d                              # pre-norms (approx 2/block)
        if kind in ("A", "M", "W"):
            hd = cfg.head_dim
            total += d * cfg.num_heads * hd         # wq
            total += 2 * d * cfg.num_kv_heads * hd  # wk, wv
            total += cfg.num_heads * hd * d         # wo
        elif kind == "L":
            r = cfg.kv_lora_rank
            qk = cfg.qk_nope_dim + cfg.qk_rope_dim
            if cfg.q_lora_rank:
                total += d * cfg.q_lora_rank + cfg.q_lora_rank * cfg.num_heads * qk
            else:
                total += d * cfg.num_heads * qk
            total += d * (r + cfg.qk_rope_dim)
            total += r * cfg.num_heads * (cfg.qk_nope_dim + cfg.v_head_dim)
            total += cfg.num_heads * cfg.v_head_dim * d
        elif kind == "S":
            di, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
            G = cfg.ssm_groups
            total += d * (2 * di + 2 * G * N + H)   # in_proj
            total += cfg.ssm_conv * (di + 2 * G * N)
            total += 2 * H                          # A_log, D
            total += di                             # gated-norm scale
            total += di * d                         # out_proj
        elif kind == "R":
            total += 2 * d * d                      # in gates (x, gate branch)
            total += cfg.rglru_conv * d
            total += 3 * d                          # lru: a_param + 2 gate bias
            total += 2 * d * d                      # gate proj + out proj
        if kind in ("A", "W", "L"):
            total += 3 * d * cfg.d_ff               # SwiGLU
        elif kind == "M":
            e_params = 3 * d * cfg.d_ff
            total += d * cfg.num_experts            # router
            if active_only:
                total += cfg.experts_per_token * e_params
            else:
                total += cfg.num_experts * e_params
        elif kind == "R":
            total += 3 * d * cfg.d_ff               # R blocks carry an MLP too
    total += d                                      # final norm
    return total
