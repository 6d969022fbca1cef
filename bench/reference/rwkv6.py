"""Plain PyTorch reference of the rwkv6 configuration, in float32.

It reads the benchmark's weights by their paths (the layout of
``families/rwkv6.py``).  Each layer, on h = RMSNorm(x) and its token
shift h' (h one position back, zeros first):
  m_i = h + (h' - h) mu_i;  r, k, v = m_0 Wr, m_1 Wk, m_2 Wv (heads of N);
  g = silu(m_3 Wg);  log w = -exp(base + tanh(m_4 W1) W2);
  S_t = diag(w_t) S_{t-1} + k_t v_t^T,  y_t = r_t (diag(u) k_t v_t^T + S_{t-1});
  y normed per head (population variance, eps 1e-5 * 8^2);
  x += (y * out_norm * g) Wo;
then h = RMSNorm(x) and its shift: x += sigmoid(m_r Wrecept) * relu(m_k Wkey)^2 Wvalue.
The final RMSNorm and the untied head give the logits.  The departures of
the port's block from the paper's (static mixes, RMSNorm, the embedding
scaled by sqrt(d)) are the configuration file's ``assumed``; this
reference computes the port's block.

``scan`` is the recurrence above computed a chunk of ``CHUNK`` positions
at a time: inside a chunk every pair s < t directly, with the decay
between them as exp of a difference of cumulative log decays, and the
state carried from chunk to chunk.  ``scan_stepwise`` is the per-token
recurrence the tests hold it to.  Imports nothing of the program.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bench.reference.common import leaf, mm, rmsnorm

B = "blocks/layer0/"
CHUNK = 16


def scan_stepwise(r, k, v, logw, u):
    """r, k, v, logw [B, S, H, N]; u [H, N] -> y [B, S, H, N], S_end."""
    Bsz, S, H, N = r.shape
    st = torch.zeros(Bsz, H, N, N, dtype=torch.float32, device=r.device)
    ys = []
    for t in range(S):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append(torch.einsum("bhn,bhnm->bhm", r[:, t],
                               u[None, :, :, None] * kv + st))
        st = torch.exp(logw[:, t])[..., None] * st + kv
    return torch.stack(ys, 1), st


def scan(r, k, v, logw, u):
    Bsz, S, H, N = r.shape
    st = torch.zeros(Bsz, H, N, N, dtype=torch.float32, device=r.device)
    ys = []
    for c0 in range(0, S, CHUNK):
        rc, kc, vc, wc = (t[:, c0:c0 + CHUNK] for t in (r, k, v, logw))
        c = rc.shape[1]
        cum = wc.cumsum(1)                      # sum of log w_j, j <= t
        excl = cum - wc                         # j < t
        # pair (t, s), s < t: the decay of w_{s+1} .. w_{t-1}
        before = torch.ones(c, c, dtype=torch.bool, device=r.device).tril(-1)
        diff = excl[:, :, None] - cum[:, None, :]            # [B, t, s, H, N]
        diff = torch.where(before[None, :, :, None, None], diff,
                           torch.full_like(diff, -math.inf))
        a = (rc[:, :, None] * kc[:, None, :] * torch.exp(diff)).sum(-1)
        y = torch.einsum("btsh,bshm->bthm", a, vc)
        y = y + (rc * u * kc).sum(-1, keepdim=True) * vc
        y = y + torch.einsum("bthn,bhnm->bthm", rc * torch.exp(excl), st)
        last = cum[:, -1]                                    # [B, H, N]
        st = torch.exp(last)[..., None] * st + torch.einsum(
            "bshn,bshm->bhnm", kc * torch.exp(last[:, None] - cum), vc)
        ys.append(y)
    return torch.cat(ys, 1), st


def _shift(h):
    return F.pad(h, (0, 0, 1, 0))[:, :-1]


def hidden(params: dict, c: dict, tokens: torch.Tensor,
           prec: str = "fp32") -> torch.Tensor:
    """Final normed hidden states [B, S, d] (float32) of ``tokens``."""
    L, d, N = c["num_hidden_layers"], c["hidden_size"], c["head_size"]
    H = d // N
    eps = float(c["layer_norm_epsilon"])
    gn_eps = eps * c["head_size_divisor"] ** 2
    Bsz, S = tokens.shape
    x = leaf(params, "embed/tokens")[tokens].float() * math.sqrt(d)
    for r in range(L):
        w = lambda p: leaf(params, B + p)[r]      # noqa: E731
        h = rmsnorm(x, w("norm1/scale"), eps)
        mu = w("rwkv/mu").float()
        hs = _shift(h)
        m = [h + (hs - h) * mu[i] for i in range(5)]
        heads = lambda t: t.view(Bsz, S, H, N)     # noqa: E731
        rr = heads(mm(m[0], w("rwkv/w_r"), prec))
        kk = heads(mm(m[1], w("rwkv/w_k"), prec))
        vv = heads(mm(m[2], w("rwkv/w_v"), prec))
        g = F.silu(mm(m[3], w("rwkv/w_g"), prec))
        lora = mm(torch.tanh(mm(m[4], w("rwkv/decay_w1"), prec)),
                  w("rwkv/decay_w2"), prec)
        logw = heads(-torch.exp(w("rwkv/decay_base").float() + lora))
        y, _ = scan(rr, kk, vv, logw, w("rwkv/bonus_u").float())
        y = (y - y.mean(-1, keepdim=True)) * torch.rsqrt(
            y.var(-1, keepdim=True, correction=0) + gn_eps)
        y = y.reshape(Bsz, S, d) * w("rwkv/out_norm/scale").float()
        x = x + mm(y * g, w("rwkv/w_o"), prec)
        h = rmsnorm(x, w("norm2/scale"), eps)
        hs = _shift(h)
        xk = h + (hs - h) * w("ffn/mu_k").float()
        xr = h + (hs - h) * w("ffn/mu_r").float()
        kf = torch.relu(mm(xk, w("ffn/w_key"), prec))
        x = x + torch.sigmoid(mm(xr, w("ffn/w_recept"), prec)) \
            * mm(kf * kf, w("ffn/w_value"), prec)
    return rmsnorm(x, leaf(params, "final_norm/scale"), eps)


def logits(params: dict, c: dict, h: torch.Tensor,
           prec: str = "fp32") -> torch.Tensor:
    return mm(h, leaf(params, "embed/lm_head"), prec)
