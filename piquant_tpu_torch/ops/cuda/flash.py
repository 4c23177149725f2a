"""GQA-native flash-attention prefill (counterpart of
piquant_tpu/ops/pallas/flash.py: `flash_prefill_masked` and `_kernel`).

`flash_attn` launches the hand-written kernel (csrc/flash.cu) on CUDA
tensors and runs `flash_attn_plain`, the same function in plain PyTorch, on
CPU tensors.  Both take the causal mask, the sliding window (Mistral,
Gemma: kp > qp - w beside kp <= qp) and the logit softcap (Gemma-2:
cap * tanh(s / cap) on the scaled score, before the mask) at any GQA rep;
the kernel takes head_dim 128 and 256.  The reference's Llama-4 chunk and
the sinks raise NotImplementedError on every device until the kernel takes
them (ROADMAP.md queue 1 item 5).
"""

from __future__ import annotations

from typing import Optional

import torch

from piquant_tpu_torch.ops.cuda import _build

_D = (128, 256)


def flash_attn_plain(q, k, v, sm_scale: float, window: Optional[int] = None,
                     softcap: Optional[float] = None) -> torch.Tensor:
    """q [B,Hkv,rep,T,D], k/v [B,Hkv,T,D] -> [B,Hkv,rep,T,D] f32: bf16
    operands, f32 softmax, the scaled score capped at softcap * tanh(s *
    (1 / softcap)) (the TPU kernel's form), inclusive causal mask kp <= qp
    (and kp > qp - w under a sliding window w), probabilities rounded to
    bf16 for the PV product, denominator from the unrounded ones."""
    t = q.shape[-2]
    qb, kb, vb = (a.to(torch.bfloat16).float() for a in (q, k, v))
    s = torch.einsum("bhrtd,bhsd->bhrts", qb, kb) * sm_scale
    if softcap is not None:
        s = softcap * torch.tanh(s * (1.0 / softcap))
    idx = torch.arange(t, device=q.device)
    dead = idx[None, :] > idx[:, None]
    if window is not None:
        dead |= idx[None, :] <= idx[:, None] - window
    s = s.masked_fill(dead, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhrts,bhsd->bhrtd", p.to(torch.bfloat16).float(), vb)
    return acc / l


def rounding_bound(q, k, v, sm_scale: float, window: Optional[int] = None,
                   softcap: Optional[float] = None) -> torch.Tensor:
    """[B,Hkv,rep,T,D] f32: the most that rounding every probability to
    bf16 (2^-8 relative) can move each context element, 2^-8 * sum(p |v|)
    / l.  The kernels and the plain version each stay within it of the
    context with unrounded probabilities, and within twice it of each other
    (they round against different maxima, and an ulp of difference in a
    score can flip a rounding).  Where a few keys dominate a row, as under
    Gemma-2's peaked scores, it exceeds flash's atol of 2e-3."""
    return 2.0 ** -8 * flash_attn_plain(q, k, v.abs(), sm_scale, window,
                                        softcap)


def flash_attn(q, k, v, sm_scale: float, window: Optional[int] = None,
               softcap: Optional[float] = None) -> torch.Tensor:
    """Kernel wrapper; see `flash_attn_plain` for the function."""
    if not q.is_cuda:
        return flash_attn_plain(q, k, v, sm_scale, window, softcap)
    b, hkv, rep, t, d = q.shape
    if d not in _D:
        raise NotImplementedError(
            f"flash_attn: head_dim {d} (the kernel takes 128 and 256; wider "
            "heads: ROADMAP.md queue 2 item 3)")
    if not 1 <= rep <= 8:
        raise NotImplementedError(f"flash_attn: GQA rep {rep} (the kernel "
                                  "takes 1 to 8)")
    if window is not None and window < 1:
        raise ValueError(f"flash_attn: window {window} < 1")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"flash_attn: softcap {softcap} <= 0")
    if k.shape != (b, hkv, t, d) or v.shape != k.shape:
        raise ValueError("flash_attn: q/k/v shapes disagree")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attn: q/k/v on different devices")
    qb, kb, vb = (a.to(torch.bfloat16).contiguous() for a in (q, k, v))
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    # a window of t is the plain causal mask: every key kp <= qp < t
    # satisfies kp > qp - t
    win = t if window is None else min(window, t)
    err = _build.library().pq_flash_prefill(
        qb.data_ptr(), kb.data_ptr(), vb.data_ptr(), out.data_ptr(), b, hkv,
        rep, t, win, d, float(sm_scale), float(softcap or 0.0),
        _build.stream_ptr(q))
    _build.check(err, "flash_attn")
    flash_attn.launches += 1
    return out


flash_attn.launches = 0


def flash_prefill_masked(
    q: torch.Tensor,                  # [B, Hkv, rep, T, D]
    k: torch.Tensor,                  # [B, Hkv, T, D]
    v: torch.Tensor,                  # [B, Hkv, T, D]
    sm_scale: float,
    *,
    pos0: Optional[torch.Tensor] = None,    # [B] position of index 0
    window: Optional[int] = None,
    chunk: Optional[int] = None,
    softcap: Optional[float] = None,
    sinks: Optional[torch.Tensor] = None,
) -> Optional[torch.Tensor]:
    """[B, Hkv, rep, T, D] f32 context, or None where the reference gate
    has no kernel (head_dim % 128, T % 128, T < 128, a window together
    with a chunk, a window < 1).  `pos0` only moves the reference's chunk
    mask, so the causal, windowed and softcapped functions do not read
    it."""
    d, t = q.shape[-1], q.shape[-2]
    if d % 128 or t % 128 or t < 128:
        return None
    if window is not None and (chunk is not None or window < 1):
        return None
    if chunk is not None or sinks is not None:
        raise NotImplementedError(
            "flash_prefill_masked: chunk / sinks are not ported yet "
            "(ROADMAP.md queue 1 item 5)")
    return flash_attn(q, k, v, sm_scale, window, softcap)
