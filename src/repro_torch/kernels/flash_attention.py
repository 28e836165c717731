"""Causal flash attention: a CUDA kernel + its plain torch version.

* ``flash_attention(q, k, v, *, causal=True, block_q=128, block_kv=128)``:
  the JAX package's signature and layout.  q is (B, Sq, H, hd), k and v
  are (B, Skv, KV, hd); the output is (B, Sq, H, hd) in q's dtype.  GQA:
  q head h reads KV head h // (H // KV).  Kernel ``flash_attention`` in
  ``csrc/flash_attention.cu`` replaces the Pallas kernel
  ``src/repro/kernels/flash_attention.py:31`` (``_flash_kernel``; its
  ``pallas_call`` at ``:77``), with two bodies:

  - bfloat16: tensor cores.  One CTA of one warpgroup per (batch and
    head, 64-row Q tile); Q, and 64-key K and V tiles through a ring of
    two slots (K0, V0, K1, ...), arrive by TMA (tensor maps built from
    the strides, swizzled shared memory) on mbarriers; S = Q Kᵀ is a
    ``wgmma`` from shared memory, the online softmax runs on the
    accumulator in registers, and O += P V is a ``wgmma`` with P from
    registers and V read key-major as a transposed B operand.  P enters
    as two bf16 terms, hi = bf16(p) and lo = bf16(p - hi): one bf16
    rounding of P misses ``tolerance`` 9 to 15 times over
    (``tests/test_torch_flash.py`` emulates the body on the CPU).
    At hd 112 the second 64-column panel is a quarter zero fill (the
    tensor maps' out-of-bounds columns), Q Kᵀ takes 7 k-steps and
    O += P V is a ``wgmma`` m64n112k16.  At hd 256 one warpgroup's O
    accumulator would take 128 of a thread's 255 registers, so a CTA has
    two consumer warpgroups that compute the same S and P and own 128
    columns of O each.
  - float32: CUDA cores in fp32 (TF32 tensor cores keep about 10 bits
    and cannot hold ``FP32_TOL``).

  Both loop over 64-key tiles up to the diagonal of a causal call, keep
  the scores and sums in fp32, and read q/k/v in place through their
  strides.

Both versions mask keys at positions >= Skv whatever ``causal`` is.  (The
reference's Pallas body pads a ragged K/V with zero keys and masks them
only through the causal test, so a non-causal call whose Skv is not a
multiple of its KV tile lets the zero keys into the softmax; its CPU path
and its test's oracle do not.  The port computes the oracle's function.)

``block_q`` and ``block_kv`` are the reference's TPU tile sizes; they are
taken for its signature and checked, and do not change the result.  There
is no ``interpret=``: the device of the tensors decides, as for every
kernel of the port.

Query stripes (``stripe=(seg, count, index)``): a rank of a (data, model)
mesh holds one stripe of the reference's Q tiles, which its
``blockwise_attention`` stripes over the "model" axis (tile t = l·M + m
goes to stripe m).  q then holds the stripe's rows only, and row r sits
at the absolute position ``((r // seg)·count + index)·seg + r % seg``
(``stripe_positions``), against keys at 0..Skv-1.  Only the causal test
reads positions: each query sees keys up to its own position.  The
kernel takes the three numbers and changes only a Q tile's first-row
and last-row positions (its diagonal test and its causal KV-tile count)
and each row's mask; ``count`` 1 (or ``stripe=None``) is the unstriped
call, bit for bit.  One launch covers the whole stripe.

Bound: operations.  At starcoder2-3b's prefill shape a causal call needs
4·B·H·hd·Sq(Sq+1)/2 = 1.03e11 of them (0.104 ms at 989 TFLOP/s bf16) on
109 MB of bytes; the split P costs the bf16 body 1.5 times that on the
tensor cores, a floor of 0.156 ms (see the source's note).  Left for
later: a producer warp with ``setmaxnreg``, ping-pong between consumer
warpgroups, softmax overlapped with the next Q Kᵀ, persistent CTAs,
clusters, one CTA per GQA group, fp8.

Dispatch: a CUDA tensor launches the kernel or raises; a CPU tensor takes
``flash_attention_plain``.  Nothing falls back.  The kernel's call is the
custom op ``torch.ops.repro_torch.flash_attention`` where something
watches the dispatcher: on a ``meta`` tensor (``launch/dryrun.py``) its
fake implementation gives the output's shape, and its FLOP formula
(``flash_flops``: 4·B·H·hd per (query, key) pair the causal mask keeps)
tells ``torch.utils.flop_counter.FlopCounterMode`` what the kernel
computes, so a dry run and a count on the card see the same kernel the
same way.  The ctypes launch alone would be invisible to it.  With no
dispatch mode active (every run but a count) a CUDA tensor calls the
launch directly: the op's trip through the dispatcher costs microseconds
of host time a call.

Training: when autograd records (grad enabled and an input requires
grad), ``flash_attention`` is a ``torch.autograd.Function`` whose forward
is the same kernel call and whose backward is ``flash_attention_backward``,
plain torch in fp32: the reference has no backward kernel either (its
model differentiates its jnp scan), so that backward ports no TPU
kernel.  It recomputes the softmax per query tile from q and k, so no
(Sq, Skv) tensor per head outlives a tile; a Hopper backward kernel is
left for later.  A stripe's backward (a rank's, ``models/ranked.py``)
masks by the stripe's positions and bounds each tile's keys by its last
row's position; with a stripe count of 1 it is the unstriped backward,
bit for bit.
"""
from __future__ import annotations

import math

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode
from torch.utils.flop_counter import register_flop_formula

from . import _build, dispatch

#: launches of the kernel by its wrapper (the plain version does not count)
LAUNCHES = {"flash_attention": 0}

#: masked scores, as in the reference (not -inf)
NEG_INF = -1e30
#: head dims the kernel is built for
HEAD_DIMS = (16, 32, 64, 112, 128, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


#: |kernel - plain| allowed in fp32: both sum in fp32, in different
#: orders (64-key tiles with an online softmax against one dense softmax)
FP32_TOL = 1e-4


def tolerance(want: torch.Tensor) -> torch.Tensor:
    """How far each element of the kernel's output may stray from the
    plain version's ``want`` on the same inputs, compared in fp32: an
    fp32 tensor of ``want``'s shape.

    float32: ``FP32_TOL``.  bfloat16: ``FP32_TOL`` + 2 bf16 ulps of that
    element's |want| (the ulp floored at bf16's smallest normal).  Both
    compute in fp32 from the same bf16 inputs, differ there by what the
    fp32 bound allows, and round once to bf16: each rounding moves a value
    by half an ulp, and a value next to a power of two may round into the
    binade above, so 2 ulps cover both roundings.  The ulp term alone does
    not hold where an output cancels to near 0 (|want| ~ 1e-7 and an fp32
    difference of ~4e-7 is 20 of its ulps); the fp32 term covers that.
    """
    w = want.detach().float().abs()
    if want.dtype == torch.float32:
        return torch.full_like(w, FP32_TOL)
    ulp = torch.exp2(torch.floor(torch.log2(w.clamp_min(2.0 ** -126))) - 7)
    return FP32_TOL + 2.0 * ulp


def tolerance_ratio(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest |got - want| / ``tolerance(want)`` over the elements:
    at most 1 where the kernel's output ``got`` holds."""
    if not want.numel():
        return 0.0
    diff = (got.detach().float() - want.detach().float()).abs()
    return float((diff / tolerance(want)).max())


def _stripe(stripe) -> tuple:
    """``stripe`` as (seg, count, index), checked; None is (0, 1, 0)."""
    if stripe is None:
        return 0, 1, 0
    seg, count, index = (int(x) for x in stripe)
    if count < 1 or not 0 <= index < count or (count > 1 and seg < 1):
        raise ValueError(f"stripe {tuple(stripe)}: expected (seg >= 1, "
                         f"count >= 1, 0 <= index < count)")
    return seg, count, index


def stripe_positions(rows: int, stripe=None, device=None) -> torch.Tensor:
    """The absolute positions of ``rows`` query rows of a stripe (module
    notes): 0..rows-1 without one."""
    seg, count, index = _stripe(stripe)
    r = torch.arange(rows, device=device)
    if count == 1:
        return r
    return ((r // seg) * count + index) * seg + r % seg


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          stripe=None) -> torch.Tensor:
    """Dense-softmax attention in fp32, GQA by KV-head index: the twin of
    the reference's ``_attention_xla`` and the plain version of the
    ``flash_attention`` kernel; ``stripe`` places the query rows (module
    notes)."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    kv_idx = torch.arange(H, device=q.device) // (H // KV)
    kf = k[:, :, kv_idx].float()
    vf = v[:, :, kv_idx].float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) / math.sqrt(hd)
    if causal:
        mask = (stripe_positions(Sq, stripe, q.device)[:, None]
                >= torch.arange(Skv, device=q.device)[None, :])
        s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)


def _check(q, k, v, block_q, block_kv, stripe=None) -> None:
    _stripe(stripe)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or t.dim() != 4:
            raise ValueError(f"{name} must be a 4-d torch.Tensor")
    B, Sq, H, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: expected (B, Sq, H, hd) and "
                         f"two (B, Skv, KV, hd)")
    KV = k.shape[2]
    if KV == 0 or H % KV:
        raise ValueError(f"{H} query heads do not group over {KV} KV heads")
    if k.shape[1] == 0:
        raise ValueError("attention over no keys")
    if int(block_q) <= 0 or int(block_kv) <= 0:
        raise ValueError(f"block sizes {block_q}, {block_kv}")


#: query rows a tile of the backward: its (B, H, rows, Skv) fp32 scores
#: stay near 100 MB at starcoder2-3b's B 2 x S 2,048
BWD_BLOCK_Q = 256


def _position(r: int, seg: int, count: int, index: int) -> int:
    """``stripe_positions`` of row r, on the host."""
    if count == 1:
        return r
    return ((r // seg) * count + index) * seg + r % seg


def flash_attention_backward(q, k, v, out, dout, *, causal: bool = True,
                             stripe=None):
    """(dq, dk, dv) of ``flash_attention`` at output ``out`` for the output
    gradient ``dout``, in fp32, cast to the inputs' dtypes.  Per tile of
    ``BWD_BLOCK_Q`` query rows: P = softmax(q kᵀ / sqrt(hd)) recomputed over
    the keys the tile can see (causal: up to its last row's position,
    the rows at ``stripe``'s positions), dV += Pᵀ dO, dP = dO Vᵀ, dS = P ∘
    (dP − rowsum(dO ∘ O)), dQ = dS K / sqrt(hd), dK += dSᵀ Q / sqrt(hd);
    the G query heads of a KV head sum into its dK and dV."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    seg, count, index = _stripe(stripe)
    pos = stripe_positions(Sq, stripe, q.device)
    kf = k.float().permute(0, 2, 1, 3)                    # (B, KV, Skv, hd)
    vf = v.float().permute(0, 2, 1, 3)
    dq = torch.empty((B, Sq, H, hd), dtype=torch.float32, device=q.device)
    dk = torch.zeros((B, KV, Skv, hd), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)

    def heads(x, s0, s1):                                 # (B, KV, G, T, hd)
        return x[:, s0:s1].float().reshape(B, s1 - s0, KV, G, hd) \
            .permute(0, 2, 3, 1, 4)

    for s0 in range(0, Sq, BWD_BLOCK_Q):
        s1 = min(Sq, s0 + BWD_BLOCK_Q)
        L = (min(Skv, _position(s1 - 1, seg, count, index) + 1) if causal
             else Skv)                                    # keys in view
        qt, ot, dot = heads(q, s0, s1), heads(out, s0, s1), \
            heads(dout, s0, s1)
        kt, vt = kf[:, :, :L], vf[:, :, :L]
        s = torch.einsum("bkgtd,bkld->bkgtl", qt, kt) * scale
        if causal:
            mask = (pos[s0:s1, None]
                    >= torch.arange(L, device=q.device)[None, :])
            s = s.masked_fill(~mask, NEG_INF)
        p = torch.softmax(s, dim=-1)
        del s
        dv[:, :, :L] += torch.einsum("bkgtl,bkgtd->bkld", p, dot)
        dp = torch.einsum("bkgtd,bkld->bkgtl", dot, vt)
        rowsum = (dot * ot).sum(-1, keepdim=True)
        ds = p * (dp - rowsum)
        del p, dp
        dq[:, s0:s1] = (torch.einsum("bkgtl,bkld->bkgtd", ds, kt) * scale) \
            .permute(0, 3, 1, 2, 4).reshape(B, s1 - s0, H, hd)
        dk[:, :, :L] += torch.einsum("bkgtl,bkgtd->bkld", ds, qt) * scale
    return (dq.to(q.dtype), dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


class _FlashAttention(torch.autograd.Function):
    """Kernel 11 forward, ``flash_attention_backward`` backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, stripe):
        out = _flash_forward(q, k, v, causal, stripe)
        ctx.save_for_backward(q, k, v, out)
        ctx.causal, ctx.stripe = causal, stripe
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, out, dout,
                                              causal=ctx.causal,
                                              stripe=ctx.stripe)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, block_q: int = 128,
                    block_kv: int = 128, stripe=None) -> torch.Tensor:
    """softmax(q kᵀ / sqrt(hd)) v per head, causal by absolute positions
    when ``causal``; q (B, Sq, H, hd), k/v (B, Skv, KV, hd) -> (B, Sq, H,
    hd) in q's dtype, on q's device.  ``stripe`` (seg, count, index)
    places q's rows at a stripe's positions (module notes).
    Differentiable when autograd records (the module notes)."""
    _check(q, k, v, block_q, block_kv, stripe)
    stripe = None if _stripe(stripe)[1] == 1 else _stripe(stripe)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, stripe)
    return _flash_forward(q, k, v, causal, stripe)


def _flash_forward(q, k, v, causal, stripe=None) -> torch.Tensor:
    """The kernel call (CUDA tensors, or its shape on meta) or the plain
    version (CPU)."""
    path = dispatch.decide(q).path
    if path == dispatch.TORCH_CPU:
        return flash_attention_plain(q, k, v, causal=causal, stripe=stripe)
    seg, count, index = _stripe(stripe)
    if path == dispatch.CUDA:
        _check_kernel_inputs(q, k, v)
        if _get_current_dispatch_mode() is None:
            return _launch(q, k, v, bool(causal), seg, count, index)
    return torch.ops.repro_torch.flash_attention(q, k, v, bool(causal), seg,
                                                 count, index)


def _pairs_run(p0: int, n: int, Skv: int) -> int:
    """Causal (query, key) pairs of n queries at positions p0..p0+n-1:
    each sees min(position + 1, Skv) keys."""
    a, b = p0, min(p0 + n, Skv)
    tri = b * (b + 1) // 2 - a * (a + 1) // 2 if b > a else 0
    return tri + (n - max(0, b - a)) * Skv


def causal_pairs(Sq: int, Skv: int, causal: bool, stripe=None) -> int:
    """(query, key) pairs the kernel computes: the query at position p
    sees keys 0..p (capped at Skv) when causal, every key otherwise;
    positions 0..Sq-1, or a stripe's (module notes)."""
    if not causal:
        return Sq * Skv
    seg, count, index = _stripe(stripe)
    if count == 1:
        return _pairs_run(0, Sq, Skv)
    return sum(_pairs_run(((s0 // seg) * count + index) * seg,
                          min(seg, Sq - s0), Skv)
               for s0 in range(0, Sq, seg))


def flash_flops(q_shape, k_shape, causal: bool, stripe=None) -> int:
    """Operations of one kernel call: 2 per multiply-add of Q Kᵀ and of P V
    over the pairs ``causal_pairs`` keeps."""
    B, Sq, H, hd = q_shape
    return 4 * B * H * hd * causal_pairs(Sq, k_shape[1], causal, stripe)


def _check_kernel_inputs(q, k, v) -> None:
    dev = q.device
    hd = q.shape[3]
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"q: dtype {q.dtype}, the kernel takes float32 "
                        f"and bfloat16")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd}: the kernel is built for "
                         f"{HEAD_DIMS}")
    vec = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != dev or t.dtype != q.dtype:
            raise ValueError(f"{name}: {t.dtype} on {t.device}, expected "
                             f"{q.dtype} on {dev}")
        if t.stride(3) != 1 or any(s % vec for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel reads 16-byte vectors, so "
                             f"hd must be contiguous and every stride a "
                             f"multiple of {vec} elements; got strides "
                             f"{t.stride()}")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool, seg: int, stripes: int,
            stripe: int) -> torch.Tensor:
    """One launch of kernel 11 (inputs checked by the caller); query row
    r at ``stripe_positions`` of (seg, stripes, stripe)."""
    dev = q.device
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=dev)
    if B == 0 or Sq == 0 or H == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Sq, Skv, H, KV, hd, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], 1.0 / math.sqrt(hd), int(bool(causal)),
            int(seg), int(stripes), int(stripe), _DTYPE_CODES[q.dtype],
            _build.stream_ptr(dev))
    _build.check(err, "flash_attention")
    _build.count_launch(LAUNCHES, "flash_attention")
    return out


_flash_op = torch.library.custom_op("repro_torch::flash_attention", _launch,
                                    mutates_args=(), device_types="cuda")


@_flash_op.register_fake
def _flash_shape(q, k, v, causal, seg, stripes, stripe):
    return torch.empty(q.shape, dtype=q.dtype, device=q.device)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flash_flop_formula(q_shape, k_shape, v_shape, causal, seg, stripes,
                        stripe, *, out_shape=None, **kwargs) -> int:
    return flash_flops(q_shape, k_shape, causal, (seg, stripes, stripe))
