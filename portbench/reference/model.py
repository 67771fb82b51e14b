"""Plain float32 forward of the dense decoder the benchmark serves (GPT-2
medium, Nemotron-4), teacher-forced over one sequence: the logits at every
position, which the benchmark sets against the tokens the program served.

It follows the served configuration's arithmetic, not the program's code:

- embedding rows (+ learned positions, or rotary positions on q and k,
  rotate-half pairing, angles in float32);
- per layer: LayerNorm -> q, k, v (+ bias) -> attention -> o; residual;
  LayerNorm -> up (+ activation) -> down; residual; a final LayerNorm and
  the LM head;
- "lut" mode: the norms' rsqrt, the activation (GELU) and the softmax's
  exp come from the tables of `reference/lut.py`; the softmax is the
  page-ordered online softmax of the paged cache (per page of
  `page_size` keys: m' = max(m, max s), p = LUT(s - m'), corr = LUT(max(m
  - m', lo)), l = l corr + sum p, acc = acc corr + p v; out = acc / l),
  the function a LUT softmax over a paged cache computes;
- "exact" mode: rsqrt, tanh GELU and exp.

Squared ReLU is exact in both modes (it has no table). The weights are the
benchmark's own bf16 tensors, widened to float32 one matrix at a time (the
LM head in blocks of rows), so a 60 GB model fits beside itself. TF32 is
switched off for the products.
"""
from __future__ import annotations

import math

import torch

from portbench.reference.lut import Bank

NEG = -1e30
HEAD_ROWS = 32768


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.float()


class Reference:
    """model: the configuration's widths (n_layers, d_model, n_heads,
    n_kv_heads, head_dim, d_ff, vocab, norm_eps, activation, qkv_bias,
    learned_pos_emb, rope_theta); weights: the benchmark's tree."""

    def __init__(self, weights: dict, model: dict, *, nonlinear_mode: str,
                 lut_sections: int, page_size: int):
        if model["norm"] != "layernorm" or model.get("gated_mlp"):
            raise ValueError("the reference serves LayerNorm models with a plain MLP")
        self.w = weights
        self.m = model
        self.lut = Bank(lut_sections) if nonlinear_mode == "lut" else None
        self.page = page_size

    # -- pieces ---------------------------------------------------------------
    def norm(self, x, p):
        mean = x.mean(-1, keepdim=True)
        xc = x - mean
        var = (xc * xc).mean(-1, keepdim=True) + self.m["norm_eps"]
        inv = self.lut.rsqrt(var) if self.lut is not None else torch.rsqrt(var)
        return xc * inv * _f32(p["g"]) + _f32(p["b"])

    @staticmethod
    def linear(x, w, b=None):
        out = x @ _f32(w).t()
        return out + _f32(b) if b is not None else out

    def act(self, x):
        kind = self.m["activation"]
        if kind == "gelu":
            if self.lut is not None:
                return self.lut.gelu(x)
            return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                               * (x + 0.044715 * x ** 3)))
        if kind == "squared_relu":
            r = torch.clamp(x, min=0.0)
            return r * r
        raise ValueError(f"no reference for activation {kind!r}")

    def rope(self, x, pos):
        """x (T, H, D) rotated at positions pos (T,), rotate-half pairs."""
        D = x.shape[-1]
        half = D // 2
        freqs = 1.0 / (self.m["rope_theta"] ** (
            torch.arange(0, half, dtype=torch.float32, device=x.device) / half))
        ang = pos[:, None].float() * freqs
        c, s = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)

    def attention(self, q, k, v):
        """Causal attention of q (T, H, D) over k, v (T, Hkv, D)."""
        T, H, D = q.shape
        Hkv = k.shape[1]
        g = H // Hkv
        scale = D ** -0.5
        qh = q.reshape(T, Hkv, g, D).permute(1, 2, 0, 3)          # (Hkv, g, T, D)
        kh, vh = k.permute(1, 0, 2), v.permute(1, 0, 2)            # (Hkv, T, D)
        qpos = torch.arange(T, device=q.device)
        if self.lut is None:
            s = torch.einsum("hgtd,hkd->hgtk", qh, kh) * scale
            s = torch.where(qpos[None, :] <= qpos[:, None], s, -torch.inf)
            out = torch.einsum("hgtk,hkd->hgtd", torch.softmax(s, -1), vh)
            return out.permute(2, 0, 1, 3).reshape(T, H, D)
        exp = self.lut.exp
        m = torch.full((Hkv, g, T, 1), NEG, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qh)
        ps = self.page
        for p0 in range(0, T, ps):
            rows = slice(p0, T)       # queries before this page see none of it
            kp, vp = kh[:, p0:p0 + ps], vh[:, p0:p0 + ps]
            s = torch.einsum("hgtd,hkd->hgtk", qh[:, :, rows], kp) * scale
            kpos = p0 + torch.arange(kp.shape[1], device=q.device)
            mask = kpos[None, :] <= qpos[rows, None]
            s = torch.where(mask, s, NEG)
            m_old = m[:, :, rows]
            m_new = torch.maximum(m_old, s.amax(-1, keepdim=True))
            pr = torch.where(mask, exp(s - m_new), 0.0)
            corr = exp(torch.clamp(m_old - m_new, min=exp.lo))
            l[:, :, rows] = l[:, :, rows] * corr + pr.sum(-1, keepdim=True)
            acc[:, :, rows] = acc[:, :, rows] * corr + torch.einsum("hgtk,hkd->hgtd", pr, vp)
            m[:, :, rows] = m_new
        out = acc / torch.clamp(l, min=1e-9)
        return out.permute(2, 0, 1, 3).reshape(T, H, D)

    # -- forward --------------------------------------------------------------
    @torch.no_grad()
    def logits(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (T,) -> logits (T, vocab) float32, teacher-forced."""
        prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            return self._logits(tokens)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev

    def _logits(self, tokens):
        m, w = self.m, self.w
        T = tokens.shape[0]
        pos = torch.arange(T, device=tokens.device)
        x = _f32(w["embed"][tokens])
        if m["learned_pos_emb"]:
            x = x + _f32(w["pos_embed"][pos])
        blocks = w["blocks"]
        H, Hkv, D = m["n_heads"], m["n_kv_heads"], m["head_dim"]
        for i in range(m["n_layers"]):
            a = {k: v[i] for k, v in blocks["attn"].items()}
            h = self.norm(x, {k: v[i] for k, v in blocks["ln1"].items()})
            q = self.linear(h, a["wq"], a.get("bq")).reshape(T, H, D)
            k = self.linear(h, a["wk"], a.get("bk")).reshape(T, Hkv, D)
            v = self.linear(h, a["wv"], a.get("bv")).reshape(T, Hkv, D)
            if not m["learned_pos_emb"]:
                q, k = self.rope(q, pos), self.rope(k, pos)
            x = x + self.linear(self.attention(q, k, v).reshape(T, H * D), a["wo"])
            h = self.norm(x, {k_: v_[i] for k_, v_ in blocks["ln2"].items()})
            f = blocks["ffn"]
            x = x + self.linear(self.act(self.linear(h, f["w_up"][i])), f["w_down"][i])
        x = self.norm(x, w["final_norm"])
        head = w["lm_head"]
        return torch.cat([self.linear(x, head[r:r + HEAD_ROWS])
                          for r in range(0, head.shape[0], HEAD_ROWS)], dim=-1)


def gaps(logits: torch.Tensor, served: torch.Tensor) -> torch.Tensor:
    """For each position, how far the served token's logit lies below the
    reference's best: max(logits[j]) - logits[j, served[j]] (>= 0)."""
    best = logits.amax(-1)
    return best - logits.gather(-1, served.long()[:, None])[:, 0]
