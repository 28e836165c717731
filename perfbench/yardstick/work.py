"""Operations and bytes of the work, and the chip's peaks.

Frozen copies of the arithmetic the port's ``chip_smoke.py`` uses for its
kernel rooflines (``bound``, ``matmul_work``, ``flash_work``), and the
model FLOPs of a training step from the configuration's own shapes.
Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, dense rates: 989 TFLOP/s
bf16, 3.35 TB/s HBM, 1,979 TOP/s of int8 (the byte operations of GF(2^8)
products are counted against it).
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
BYTE_OPS_PER_S = 1.979e15


def bound(nbytes: float, ops: float, ops_per_s: float = BYTE_OPS_PER_S):
    """(the least seconds the chip could take, "bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / ops_per_s
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def matmul_work(m: int, k: int, nnz: int, items: int, C: int):
    """Bytes a shared-matrix GF(2^8) product of (m, k) coefficients over
    ``items`` items of k vectors of C bytes must move (each input once,
    each output once, the matrix once) and its multiply-XORs (one per
    nonzero coefficient and output byte)."""
    return items * k * C + items * m * C + m * k, nnz * items * C


def causal_pairs(Sq: int, Skv: int) -> int:
    """(query, key) pairs a causal mask keeps, queries at the last Sq of
    Skv positions."""
    off = Skv - Sq
    return sum(min(off + i + 1, Skv) for i in range(Sq))


def flash_work(B: int, Sq: int, Skv: int, H: int, KV: int, hd: int,
               causal: bool, elem: int):
    """Bytes of one attention forward (q, k, v and the output, each once)
    and its operations: 2 per multiply-add of Q Kᵀ and of P V over the
    pairs the mask keeps."""
    nbytes = (2 * B * Sq * H * hd + 2 * B * Skv * KV * hd) * elem
    pairs = causal_pairs(Sq, Skv) if causal else Sq * Skv
    return nbytes, 4 * B * H * hd * pairs


def matmul_params(cfg: dict) -> int:
    """Weights a token multiplies by in one forward (the token table's
    lookup is no product; the output head is)."""
    d, f, L = cfg["d_model"], cfg["d_ff"], cfg["num_layers"]
    H = cfg["num_heads"]
    per = 3 * d * f
    if cfg["layer_kind"] == "A":
        hd, KV = cfg["head_dim"], cfg["num_kv_heads"]
        per += d * H * hd + 2 * d * KV * hd + H * hd * d
    elif cfg["layer_kind"] == "L":
        r, qr = cfg["kv_lora_rank"], cfg["q_lora_rank"]
        nope, rope, vd = cfg["qk_nope_dim"], cfg["qk_rope_dim"], \
            cfg["v_head_dim"]
        per += d * qr + qr * H * (nope + rope) + d * (r + rope) \
            + r * H * (nope + vd) + H * vd * d
    else:
        raise ValueError(f"layer kind {cfg['layer_kind']!r}")
    return L * per + d * cfg["padded_vocab"]


def attention_flops(cfg: dict, B: int, S: int) -> int:
    """One causal forward's attention products over all layers: 2 per
    multiply-add of the scores and of the values."""
    H, L = cfg["num_heads"], cfg["num_layers"]
    if cfg["layer_kind"] == "A":
        dqk = dv = cfg["head_dim"]
    else:
        dqk = cfg["qk_nope_dim"] + cfg["qk_rope_dim"]
        dv = cfg["v_head_dim"]
    return L * 2 * B * H * (dqk + dv) * causal_pairs(S, S)


def train_step_flops(cfg: dict, B: int, S: int) -> int:
    """A training step's model FLOPs: 6 per weight and token (forward 2,
    backward 4) and three times the forward's attention products; a
    recompute under rematerialisation is not counted."""
    return 6 * matmul_params(cfg) * B * S + 3 * attention_flops(cfg, B, S)
