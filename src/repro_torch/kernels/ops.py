"""Top-level kernel dispatch the model layer uses when the attention
implementation is ``"kernel"`` (``models.attention.set_attention_impl``).

Port of ``repro.kernels.ops:15-48``, with the same routing rule for
attention: the flash kernel only for contiguous self-attention
(``Sq == Sk``, shared 1-D positions, no ``k_valid``); per-row positions
go to ``plain_attention``; anything else to ``chunked_attention``.
``rwkv6_scan`` is the RWKV6 time-mix scan and ``mamba_scan`` the Mamba
selective scan, both from a zero state (``models.rwkv.apply_rwkv`` and
``models.mamba.apply_mamba`` call them for every one-shot prefill).  The
kernels run on CUDA tensors; on CPU tensors each wrapper takes its plain
version.
"""
from __future__ import annotations

from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention as _flash
from repro_torch.kernels.mamba_scan.ops import mamba_scan  # noqa: F401
from repro_torch.kernels.rwkv6_scan.ops import rwkv6_scan  # noqa: F401


def flash_attention(q, k, v, q_pos, k_pos, *, causal=True, window=None,
                    cap=None, k_valid=None):
    """Adapter matching ``models.attention.multihead_attention``'s contract.

    The kernel assumes contiguous arange positions (prefill / training
    self-attention); anything else goes to the plain tensor paths."""
    Sq, Sk = q.shape[1], k.shape[1]
    contiguous = (Sq == Sk and q_pos.ndim == 1 and k_valid is None)
    if not contiguous:
        from repro_torch.models import attention as attn
        per_row = (q_pos.ndim > 1 or k_pos.ndim > 1
                   or (k_valid is not None and k_valid.ndim > 1))
        if per_row:
            return attn.plain_attention(q, k, v, q_pos, k_pos,
                                        causal=causal, window=window,
                                        cap=cap, k_valid=k_valid)
        return attn.chunked_attention(q, k, v, q_pos, k_pos, causal=causal,
                                      window=window, cap=cap,
                                      k_valid=k_valid)
    return _flash(q.contiguous(), k.contiguous(), v.contiguous(),
                  causal=causal, window=window, cap=cap)


def flash_decode_attention(q, k, v, bias, *, cap=None):
    """Single-token (Sq == 1) decode attention over a slot-validity bias.

    q: [B, H, hd]; k/v: [B, L, KV, hd] (GQA via H // KV); bias: [B, L]
    additive (0 = attend, NEG_INF = masked).  Returns [B, H, hd]."""
    return decode_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                            bias.contiguous(), cap=cap)
