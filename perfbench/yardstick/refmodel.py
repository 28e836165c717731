"""Plain reference of the trained model: the architecture's fp32 forward,
autograd for the backward, and AdamW, in plain torch.

Written from the configuration file's shapes (``shapes``), not from the
program's code, and importing nothing of it.  The architecture is the one
the configuration states (``model`` in its file; ``assumed`` there lists
where it departs from the published model):

* token ids -> an fp32 table row; per layer x += mixer(rmsnorm(x)),
  x += mlp(rmsnorm(x)); rmsnorm(x) = x / sqrt(mean(x^2) + eps) * scale;
  the final norm and an untied fp32 output table over the vocabulary
  padded to a multiple of 256; loss = mean over tokens of
  logsumexp(logits) - logit(label) + 1e-4 logsumexp(logits)^2;
* "A": causal softmax attention of GQA heads (head h reads key/value head
  h // (H / KV)), RoPE on q and k (rotate-half, inverse frequencies
  theta^(-2i/hd)), scores over sqrt(hd);
* "L" (MLA): q = rmsnorm(x w_dq) w_uq per head (nope + rope), the latent
  c = x w_dkv, k/v per head from rmsnorm(c[:r]) through w_uk / w_uv, one
  RoPE key c[r:] shared by the heads, scores (q_nope k_nope + q_rope
  k_rope) over sqrt(nope + rope);
* MLP: silu(x w_gate) * (x w_up) w_down.

Parameters are stored as the configuration states them (matrices in its
dtype, tables and norm scales in fp32) and every product is computed in
fp32 with TF32 off.  To fit beside nothing but itself on one card, the
forward keeps only each layer's input, and the backward recomputes one
layer at a time under autograd.

``quant="fp8"`` is the control: the same reference with both operands of
every product rounded to float8 e4m3 (a per-tensor scale) in the
forward, gradients passed straight through.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch

#: storage dtype names of the configuration file
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class Leaf:
    name: str
    shape: tuple
    dtype: torch.dtype
    init: str          # "normal" (drawn) or "ones" (a norm scale)


def shapes(config: dict) -> dict:
    """The configuration's model shapes, with what follows from them."""
    m = dict(config["model"])
    if len(set(m["layer_pattern"])) != 1:
        raise ValueError("the reference runs one layer kind a model")
    m["layer_kind"] = m["layer_pattern"][0]
    m["padded_vocab"] = -(-m["vocab_size"] // 256) * 256
    m.setdefault("norm_eps", 1e-6)
    m.setdefault("dtype", "bfloat16")
    return m


def _layer_leaves(s: dict) -> dict:
    """A layer's parameters: path tuple -> (shape, storage kind)."""
    d, f, H = s["d_model"], s["d_ff"], s["num_heads"]
    out = {("ln1", "scale"): ((d,), "norm"), ("ln2", "scale"): ((d,), "norm"),
           ("mlp", "w_gate"): ((d, f), "mat"), ("mlp", "w_up"): ((d, f), "mat"),
           ("mlp", "w_down"): ((f, d), "mat")}
    if s["layer_kind"] == "A":
        hd, KV = s["head_dim"], s["num_kv_heads"]
        out.update({("attn", "wq"): ((d, H * hd), "mat"),
                    ("attn", "wk"): ((d, KV * hd), "mat"),
                    ("attn", "wv"): ((d, KV * hd), "mat"),
                    ("attn", "wo"): ((H * hd, d), "mat")})
    elif s["layer_kind"] == "L":
        r, qr = s["kv_lora_rank"], s["q_lora_rank"]
        nope, rope, vd = s["qk_nope_dim"], s["qk_rope_dim"], s["v_head_dim"]
        out.update({("mla", "w_dkv"): ((d, r + rope), "mat"),
                    ("mla", "kv_norm", "scale"): ((r,), "norm"),
                    ("mla", "w_uk"): ((r, H, nope), "mat"),
                    ("mla", "w_uv"): ((r, H, vd), "mat"),
                    ("mla", "wo"): ((H * vd, d), "mat"),
                    ("mla", "w_dq"): ((d, qr), "mat"),
                    ("mla", "q_norm", "scale"): ((qr,), "norm"),
                    ("mla", "w_uq"): ((qr, H, nope + rope), "mat")})
    else:
        raise ValueError(f"layer kind {s['layer_kind']!r}")
    return out


def leaves(config: dict) -> list:
    """Every parameter as a ``Leaf``, in the tree's order: the unit's
    positions' leaves (paths sorted), each over its repeats, then the
    embeddings, the final norm and the remainder layers."""
    s = shapes(config)
    mat = DTYPES[s["dtype"]]
    V, d, L = s["padded_vocab"], s["d_model"], s["num_layers"]
    unit = len(s["layer_pattern"])
    R = L // unit
    per = _layer_leaves(s)

    def leaf(i, path):
        shape, kind = per[path]
        return Leaf(f"layers.{i}." + ".".join(path), shape,
                    mat if kind == "mat" else torch.float32,
                    "normal" if kind == "mat" else "ones")

    out = [leaf(r * unit + u, path) for u in range(unit) if R
           for path in sorted(per) for r in range(R)]
    out += [Leaf("embeddings.embed", (V, d), torch.float32, "normal"),
            Leaf("embeddings.unembed", (d, V), torch.float32, "normal"),
            Leaf("final_norm.scale", (d,), torch.float32, "ones")]
    out += [leaf(i, path) for i in range(R * unit, L) for path in sorted(per)]
    return out


@contextlib.contextmanager
def full_fp32():
    """fp32 products in fp32: TF32 off for the duration."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.backends.cudnn.allow_tf32 = old[1]
        torch.set_float32_matmul_precision(old[2])


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 under a per-tensor scale, gradient passed
    straight through."""
    x = t.detach()
    scale = x.abs().amax().clamp(min=1e-12) / 448.0
    q = (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return t + (q - x)


def _rmsnorm(x, scale, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * scale


def _rope(x, positions, theta):
    """x (B, S, h, dim) rotated by positions (S,), rotate-half."""
    dim = x.shape[-1]
    inv = torch.as_tensor(1.0 / (theta ** (np.arange(0, dim, 2) / dim)),
                          dtype=torch.float32, device=x.device)
    ang = positions.float()[:, None] * inv
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :dim // 2], x[..., dim // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


class Reference:
    def __init__(self, config: dict, quant: str | None = None):
        self.s = shapes(config)
        self.quant = quant
        self.names = [leaf.name for leaf in leaves(config)]

    # -- products ---------------------------------------------------------
    def mm(self, eq: str, a, b):
        if self.quant == "fp8":
            a, b = _fp8(a), _fp8(b)
        elif self.quant is not None:
            raise ValueError(f"quant {self.quant!r}")
        return torch.einsum(eq, a, b)

    def _softmax_attention(self, q, k, v, scale):
        """q (B, S, H, e), k (B, S, H, e), v (B, S, H, dv), causal."""
        S = q.shape[1]
        s = self.mm("bqhe,bkhe->bhqk", q, k) * scale
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
        return self.mm("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)

    # -- one layer --------------------------------------------------------
    def layer(self, x, W: dict, positions):
        s = self.s
        eps = s["norm_eps"]
        B, S, d = x.shape
        H = s["num_heads"]
        h = _rmsnorm(x, W["ln1.scale"], eps)
        if s["layer_kind"] == "A":
            hd, KV = s["head_dim"], s["num_kv_heads"]
            q = self.mm("bsd,de->bse", h, W["attn.wq"]).view(B, S, H, hd)
            k = self.mm("bsd,de->bse", h, W["attn.wk"]).view(B, S, KV, hd)
            v = self.mm("bsd,de->bse", h, W["attn.wv"]).view(B, S, KV, hd)
            q = _rope(q, positions, s["rope_theta"])
            k = _rope(k, positions, s["rope_theta"])
            G = H // KV
            k, v = k.repeat_interleave(G, dim=2), v.repeat_interleave(G, dim=2)
            o = self._softmax_attention(q, k, v, 1.0 / math.sqrt(hd))
            x = x + self.mm("bse,ed->bsd", o.reshape(B, S, H * hd),
                            W["attn.wo"])
        else:
            r, nope, rope = s["kv_lora_rank"], s["qk_nope_dim"], \
                s["qk_rope_dim"]
            vd = s["v_head_dim"]
            ql = _rmsnorm(self.mm("bsd,dq->bsq", h, W["mla.w_dq"]),
                          W["mla.q_norm.scale"], 1e-6)
            q = self.mm("bsq,qhe->bshe", ql, W["mla.w_uq"])
            ckv = self.mm("bsd,dc->bsc", h, W["mla.w_dkv"])
            lat = _rmsnorm(ckv[..., :r], W["mla.kv_norm.scale"], 1e-6)
            k_nope = self.mm("bsr,rhe->bshe", lat, W["mla.w_uk"])
            v = self.mm("bsr,rhe->bshe", lat, W["mla.w_uv"])
            q_rope = _rope(q[..., nope:], positions, s["rope_theta"])
            k_rope = _rope(ckv[..., r:][:, :, None, :], positions,
                           s["rope_theta"]).expand(B, S, H, rope)
            qf = torch.cat([q[..., :nope], q_rope], dim=-1)
            kf = torch.cat([k_nope, k_rope], dim=-1)
            o = self._softmax_attention(qf, kf, v,
                                        1.0 / math.sqrt(nope + rope))
            x = x + self.mm("bse,ed->bsd", o.reshape(B, S, H * vd),
                            W["mla.wo"])
        h = _rmsnorm(x, W["ln2.scale"], eps)
        a = torch.nn.functional.silu(self.mm("bsd,df->bsf", h,
                                             W["mlp.w_gate"]))
        u = self.mm("bsd,df->bsf", h, W["mlp.w_up"])
        return x + self.mm("bsf,fd->bsd", a * u, W["mlp.w_down"])

    def head(self, x, W: dict, labels):
        h = _rmsnorm(x, W["final_norm.scale"], self.s["norm_eps"])
        logits = self.mm("bsd,dv->bsv", h, W["embeddings.unembed"])
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
        return torch.mean(lse - gold + 1e-4 * lse * lse)

    # -- loss and gradients -------------------------------------------------
    def _weights(self, store, prefix: str, grad: bool) -> dict:
        out = {}
        for n in self.names:
            if n.startswith(prefix):
                w = store[n].detach().float()
                out[n[len(prefix):]] = w.requires_grad_(True) if grad else w
        return out

    def loss_and_grads(self, store: dict, batch: dict):
        """(loss, {name: fp32 gradient}) of one batch at ``store``."""
        tokens, labels = batch["tokens"].long(), batch["labels"]
        L = self.s["num_layers"]
        pos = torch.arange(tokens.shape[1], device=tokens.device)
        with full_fp32():
            with torch.no_grad():
                x = store["embeddings.embed"][tokens].float()
                inputs = []
                for i in range(L):
                    inputs.append(x)
                    x = self.layer(x, self._weights(store, f"layers.{i}.",
                                                    False), pos)
            xf = x.detach().requires_grad_(True)
            Wh = {n: store[n].detach().float().requires_grad_(True)
                  for n in ("final_norm.scale", "embeddings.unembed")}
            loss = self.head(xf, Wh, labels)
            loss.backward()
            grads = {n: w.grad for n, w in Wh.items()}
            g = xf.grad
            del Wh, xf, x
            for i in reversed(range(L)):
                xi = inputs[i].detach().requires_grad_(True)
                inputs[i] = None
                W = self._weights(store, f"layers.{i}.", True)
                self.layer(xi, W, pos).backward(g)
                for k, w in W.items():
                    grads[f"layers.{i}.{k}"] = w.grad
                g = xi.grad
                del W, xi
            ge = torch.zeros(store["embeddings.embed"].shape,
                             dtype=torch.float32, device=g.device)
            ge.index_add_(0, tokens.reshape(-1), g.reshape(-1, g.shape[-1]))
            grads["embeddings.embed"] = ge
        return float(loss.detach()), grads


class AdamW:
    """AdamW with fp32 moments, the global-norm clip and the cosine
    schedule with linear warm-up, as the configuration states; each update
    is added to the parameter in fp32 and stored in the parameter's
    dtype."""

    def __init__(self, hp: dict):
        self.hp = hp
        self.m, self.v = {}, {}
        self.count = 0

    def lr(self, c: int) -> float:
        hp = self.hp
        w, T = hp["warmup_steps"], hp["total_steps"]
        prog = min(max((c - w) / max(T - w, 1), 0.0), 1.0)
        return hp["lr"] * min(c / max(w, 1), 1.0) * \
            0.5 * (1.0 + math.cos(math.pi * prog))

    @torch.no_grad()
    def step(self, store: dict, grads: dict) -> dict:
        """Update ``store`` in place; returns each leaf's clipped gradient
        norm (the gradient the moments take)."""
        hp = self.hp
        b1, b2, eps, wd = hp["b1"], hp["b2"], hp["eps"], hp["weight_decay"]
        norm = math.sqrt(sum(float(torch.sum(g * g)) for g in grads.values()))
        scale = min(1.0, hp["grad_clip"] / max(norm, 1e-9))
        self.count += 1
        c = self.count
        lr_t, bc1, bc2 = self.lr(c), 1 - b1 ** c, 1 - b2 ** c
        seen = {}
        for n, g in grads.items():
            g = g * scale
            seen[n] = float(torch.linalg.vector_norm(g))
            if n not in self.m:
                self.m[n] = torch.zeros_like(g)
                self.v[n] = torch.zeros_like(g)
            m, v = self.m[n], self.v[n]
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            p = store[n]
            upd = (m / bc1) / (torch.sqrt(v / bc2) + eps) + wd * p.float()
            p.copy_((p.float() - lr_t * upd).to(p.dtype))
        return seen
