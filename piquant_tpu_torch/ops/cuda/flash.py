"""GQA-native flash-attention prefill (counterpart of
piquant_tpu/ops/pallas/flash.py: `flash_prefill_masked` and `_kernel`).

`flash_attn` launches the hand-written kernel (csrc/flash.cu at head_dim
128 and 256, csrc/flash_wide.cu at the multiples of 128 from 384 to 1024)
on CUDA tensors and runs `flash_attn_plain`, the same function in plain
PyTorch, on CPU tensors. Both take the causal mask, the sliding window
(Mistral, Gemma, GPT-OSS: kp > qp - w beside kp <= qp), Llama-4's chunk
((pos0 + kp) // C == (pos0 + qp) // C, pos0 [B] the absolute position of
row 0), the logit softcap (Gemma-2: cap * tanh(s / cap) on the scaled
score, before the mask) and attention sinks (GPT-OSS: a logit for each
query head that joins the softmax denominator alone) at any GQA rep.
"""

from __future__ import annotations

from typing import Optional

import torch

from piquant_tpu_torch.ops.cuda import _build

def flash_attn_plain(q, k, v, sm_scale: float, window: Optional[int] = None,
                     softcap: Optional[float] = None,
                     chunk: Optional[int] = None,
                     pos0: Optional[torch.Tensor] = None,
                     sinks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [B,Hkv,rep,T,D], k/v [B,Hkv,T,D] -> [B,Hkv,rep,T,D] f32: bf16
    operands, f32 softmax, the scaled score capped at softcap * tanh(s *
    (1 / softcap)) (the TPU kernel's form), inclusive causal mask kp <= qp
    (and kp > qp - w under a sliding window w; under a chunk C, (pos0 + kp)
    // C == (pos0 + qp) // C with pos0 [B], default 0), probabilities
    rounded to bf16 for the PV product, denominator from the unrounded ones
    plus exp(sink - m) for sinks [Hkv, rep] (m the row's largest live
    score: the TPU kernel's form)."""
    b, t = q.shape[0], q.shape[-2]
    qb, kb, vb = (a.to(torch.bfloat16).float() for a in (q, k, v))
    s = torch.einsum("bhrtd,bhsd->bhrts", qb, kb) * sm_scale
    if softcap is not None:
        s = softcap * torch.tanh(s * (1.0 / softcap))
    idx = torch.arange(t, device=q.device)
    dead = idx[None, :] > idx[:, None]
    if window is not None:
        dead = dead | (idx[None, :] <= idx[:, None] - window)
    if chunk is not None:
        p0 = (torch.zeros(b, dtype=torch.int64, device=q.device)
              if pos0 is None else pos0.to(q.device, torch.int64))
        cid = (p0[:, None] + idx) // chunk                   # [B, T]
        dead = dead | (cid[:, None, :] != cid[:, :, None])[:, None, None]
    s = s.masked_fill(dead, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    if sinks is not None:
        snk = sinks.to(q.device, torch.float32).reshape(q.shape[1:3])
        l = l + torch.exp(snk[None, :, :, None, None] - m)
    acc = torch.einsum("bhrts,bhsd->bhrtd", p.to(torch.bfloat16).float(), vb)
    return acc / l


def rounding_bound(q, k, v, sm_scale: float, window: Optional[int] = None,
                   softcap: Optional[float] = None,
                   chunk: Optional[int] = None,
                   pos0: Optional[torch.Tensor] = None,
                   sinks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B,Hkv,rep,T,D] f32: the most that rounding every probability to
    bf16 (2^-8 relative) can move each context element, 2^-8 * sum(p |v|)
    / l.  The kernels and the plain version each stay within it of the
    context with unrounded probabilities, and within twice it of each other
    (they round against different maxima, and an ulp of difference in a
    score can flip a rounding).  Where a few keys dominate a row, as under
    Gemma-2's peaked scores, it exceeds flash's atol of 2e-3."""
    return 2.0 ** -8 * flash_attn_plain(q, k, v.abs(), sm_scale, window,
                                        softcap, chunk, pos0, sinks)


def flash_attn(q, k, v, sm_scale: float, window: Optional[int] = None,
               softcap: Optional[float] = None, chunk: Optional[int] = None,
               pos0: Optional[torch.Tensor] = None,
               sinks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel wrapper; see `flash_attn_plain` for the function."""
    if not q.is_cuda:
        return flash_attn_plain(q, k, v, sm_scale, window, softcap, chunk,
                                pos0, sinks)
    b, hkv, rep, t, d = q.shape
    entry = _build.attention_entry("pq_flash_prefill", d)
    if window is not None and window < 1:
        raise ValueError(f"flash_attn: window {window} < 1")
    if chunk is not None and (chunk < 1 or window is not None):
        raise ValueError(f"flash_attn: chunk {chunk} (>= 1, and no window "
                         "beside it)")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"flash_attn: softcap {softcap} <= 0")
    if k.shape != (b, hkv, t, d) or v.shape != k.shape:
        raise ValueError("flash_attn: q/k/v shapes disagree")
    if sinks is not None and sinks.numel() != hkv * rep:
        raise ValueError(f"flash_attn: {sinks.numel()} sinks for {hkv * rep} "
                         "query heads")
    if pos0 is not None and pos0.shape != (b,):
        raise ValueError(f"flash_attn: pos0 of shape {tuple(pos0.shape)}, "
                         f"not ({b},)")
    extras = [a for a in (k, v, pos0, sinks) if a is not None]
    if any(a.device != q.device for a in extras):
        raise ValueError("flash_attn: q/k/v/pos0/sinks on different devices")
    qb, kb, vb = (a.to(torch.bfloat16).contiguous() for a in (q, k, v))
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    p0 = None
    if chunk is not None:      # read by the kernel on the device
        p0 = (torch.zeros(b, dtype=torch.int32, device=q.device)
              if pos0 is None else pos0.to(torch.int32).contiguous())
    snk = (None if sinks is None
           else sinks.to(torch.float32).reshape(hkv * rep).contiguous())
    # a window of t is the plain causal mask: every key kp <= qp < t
    # satisfies kp > qp - t
    win = t if window is None else min(window, t)
    err = getattr(_build.library(), entry)(
        qb.data_ptr(), kb.data_ptr(), vb.data_ptr(), out.data_ptr(),
        None if p0 is None else p0.data_ptr(),
        None if snk is None else snk.data_ptr(), b, hkv, rep, t, win,
        chunk or 0, d, float(sm_scale), float(softcap or 0.0),
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
    sinks: Optional[torch.Tensor] = None,   # [Hkv, rep] f32 sink logits
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
    return flash_attn(q, k, v, sm_scale, window, softcap, chunk,
                      None if chunk is None else pos0, sinks)
