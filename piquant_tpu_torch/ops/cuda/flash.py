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

Gradients: on CUDA tensors that require grad, `flash_attn` goes through
`FlashAttnFunction`, whose forward is the same kernel storing each row's
log-sum-exp and whose backward is csrc/flash_bwd.cu's three kernels
(`flash_bwd_delta`, `flash_bwd_dkv`, `flash_bwd_dq`, the counterpart of
the backward of the JAX-shipped flash kernel), at head_dim 128 under the
causal mask, the window and the chunk.  The softcap, the sinks and the
other head dims have no backward kernel and raise under grad (ROADMAP.md
queue 2 item 4); on CPU tensors autograd differentiates
`flash_attn_plain`.
"""

from __future__ import annotations

from typing import Optional

import torch

from piquant_tpu_torch.ops.cuda import _build

def _scores(q, k, sm_scale: float, window, softcap, chunk, pos0
            ) -> torch.Tensor:
    """[B,Hkv,rep,T,T] f32 scaled scores of the bf16-rounded q and k,
    capped, -inf where the mask kills a pair."""
    b, t = q.shape[0], q.shape[-2]
    qb, kb = (a.to(torch.bfloat16).float() for a in (q, k))
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
    return s.masked_fill(dead, float("-inf"))


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
    s = _scores(q, k, sm_scale, window, softcap, chunk, pos0)
    vb = v.to(torch.bfloat16).float()
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


def flash_attn_lse_plain(q, k, sm_scale: float,
                         window: Optional[int] = None,
                         chunk: Optional[int] = None,
                         pos0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B,Hkv,rep,T] f32: each query row's log-sum-exp of its live scaled
    scores, what the kernel stores for the backward (the sinks left
    out)."""
    return torch.logsumexp(_scores(q, k, sm_scale, window, None, chunk,
                                   pos0), dim=-1)


def _check_args(q, k, v, window, softcap, chunk, pos0, sinks) -> None:
    b, hkv, rep, t, d = q.shape
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


def _chunk_pos0(q, chunk, pos0) -> Optional[torch.Tensor]:
    """pos0 as the kernels read it: [B] int32 on the device under a chunk
    (zeros by default), else None."""
    if chunk is None:
        return None
    if pos0 is None:
        return torch.zeros(q.shape[0], dtype=torch.int32, device=q.device)
    return pos0.to(torch.int32).contiguous()


def _forward(qb, kb, vb, sm_scale, window, softcap, chunk, p0, sinks,
             with_lse: bool, entry: str):
    """One launch of the forward kernel on bf16 q/k/v -> (out f32, lse f32
    or None); pos0 as `_chunk_pos0` gives it; `entry` the C entry point
    (`_build.attention_entry`'s, asked once a launch)."""
    b, hkv, rep, t, d = qb.shape
    out = torch.empty(qb.shape, dtype=torch.float32, device=qb.device)
    lse = (torch.empty(qb.shape[:-1], dtype=torch.float32, device=qb.device)
           if with_lse else None)
    snk = (None if sinks is None
           else sinks.to(torch.float32).reshape(hkv * rep).contiguous())
    # a window of t is the plain causal mask: every key kp <= qp < t
    # satisfies kp > qp - t
    win = t if window is None else min(window, t)
    ptrs = [qb.data_ptr(), kb.data_ptr(), vb.data_ptr(), out.data_ptr()]
    if entry == "pq_flash_prefill":     # the wide entry stores no lse
        ptrs.append(None if lse is None else lse.data_ptr())
    err = getattr(_build.library(), entry)(
        *ptrs, None if p0 is None else p0.data_ptr(),
        None if snk is None else snk.data_ptr(), b, hkv, rep, t, win,
        chunk or 0, d, float(sm_scale), float(softcap or 0.0),
        _build.stream_ptr(qb))
    _build.check(err, "flash_attn")
    flash_attn.launches += 1
    return out, lse


def _bf16(*ts):
    return tuple(a.to(torch.bfloat16).contiguous() for a in ts)


class FlashAttnFunction(torch.autograd.Function):
    """flash_attn with a backward, on CUDA tensors at head_dim 128 under the
    causal mask, the window or the chunk: the forward kernel stores each
    row's log-sum-exp beside the context; the backward runs
    `flash_bwd_delta`, `flash_bwd_dkv` and `flash_bwd_dq` on the saved
    bf16 q, k, v, the context and the log-sum-exps, and returns dq, dk, dv
    in the inputs' dtypes."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale, window, chunk, pos0, entry):
        qb, kb, vb = _bf16(q, k, v)
        p0 = _chunk_pos0(q, chunk, pos0)
        out, lse = _forward(qb, kb, vb, sm_scale, window, None, chunk, p0,
                            None, True, entry)
        ctx.save_for_backward(qb, kb, vb, out, lse, p0)
        ctx.args = (sm_scale, window, chunk)
        ctx.dtypes = (q.dtype, k.dtype, v.dtype)
        return out

    @staticmethod
    def backward(ctx, dout):
        qb, kb, vb, out, lse, p0 = ctx.saved_tensors
        sm_scale, window, chunk = ctx.args
        delta, dob = flash_bwd_delta(out, dout)
        dk, dv = flash_bwd_dkv(qb, kb, vb, dob, lse, delta, sm_scale, window,
                               chunk, p0)
        dq = flash_bwd_dq(qb, kb, vb, dob, lse, delta, sm_scale, window,
                          chunk, p0)
        dtq, dtk, dtv = ctx.dtypes
        return (dq.to(dtq), dk.to(dtk), dv.to(dtv), None, None, None, None,
                None)


def flash_attn(q, k, v, sm_scale: float, window: Optional[int] = None,
               softcap: Optional[float] = None, chunk: Optional[int] = None,
               pos0: Optional[torch.Tensor] = None,
               sinks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel wrapper; see `flash_attn_plain` for the function.  Where grad
    mode is on and q, k, v or the sinks require grad it goes through
    `FlashAttnFunction`, and raises NotImplementedError where no backward
    kernel covers the call."""
    if not q.is_cuda:
        return flash_attn_plain(q, k, v, sm_scale, window, softcap, chunk,
                                pos0, sinks)
    d = q.shape[-1]
    entry = _build.attention_entry("pq_flash_prefill", d)
    _check_args(q, k, v, window, softcap, chunk, pos0, sinks)
    if torch.is_grad_enabled() and any(
            a is not None and a.requires_grad for a in (q, k, v, sinks)):
        if softcap is not None or sinks is not None or d != BWD_D:
            raise NotImplementedError(
                f"flash_attn: no backward kernel for head_dim {d}"
                + (", the softcap" if softcap is not None else "")
                + (", the sinks" if sinks is not None else "") +
                f" (the backward takes head_dim {BWD_D} under the causal "
                "mask, a window or a chunk; the rest: ROADMAP.md queue 2 "
                "item 4)")
        return FlashAttnFunction.apply(q, k, v, sm_scale, window, chunk,
                                       pos0, entry)
    out, _ = _forward(*_bf16(q, k, v), sm_scale, window, softcap, chunk,
                      _chunk_pos0(q, chunk, pos0), sinks, False, entry)
    return out


flash_attn.launches = 0

BWD_D = 128    # the head dim of csrc/flash_bwd.cu


# ---------------------------------------------------------------------------
# the backward: plain versions, the kernels' wrappers, the f32 reference
# ---------------------------------------------------------------------------

def flash_bwd_delta_plain(o: torch.Tensor, dout: torch.Tensor):
    """(delta [..., T] f32: each row's dO . O, dO rounded to bf16): delta
    of the rounded dO that dP takes, so that dO's rounding moves dP -
    delta by its error . (v_j - O_i), where the part of v common to the
    keys cancels, not by its error . v_j."""
    dob = dout.to(torch.bfloat16).contiguous()
    return (o.float() * dob.float()).sum(-1), dob


def _bwd_ds(qb, kb, vb, dob, lse, delta, sm_scale, window, chunk, pos0):
    """(P, dS) [B,Hkv,rep,T,T] f32 of the kernels' recipe: P from the
    scores and the saved log-sum-exps, dP from bf16 dO and v."""
    p = torch.exp(_scores(qb, kb, sm_scale, window, None, chunk, pos0)
                  - lse[..., None])
    dp = torch.einsum("bhrtd,bhsd->bhrts", dob.float(),
                      vb.to(torch.bfloat16).float())
    return p, p * (dp - delta[..., None])


def flash_bwd_dkv_plain(qb, kb, vb, dob, lse, delta, sm_scale: float,
                        window=None, chunk=None, pos0=None):
    """(dk, dv) [B,Hkv,T,D] f32, summed over the rep query heads: dV = P^T
    dO with bf16 P and dO, dK = scale dS^T q with bf16 dS."""
    p, ds = _bwd_ds(qb, kb, vb, dob, lse, delta, sm_scale, window, chunk,
                    pos0)
    bf = lambda a: a.to(torch.bfloat16).float()   # noqa: E731
    dv = torch.einsum("bhrts,bhrtd->bhsd", bf(p), dob.float())
    dk = torch.einsum("bhrts,bhrtd->bhsd", bf(ds), bf(qb)) * sm_scale
    return dk, dv


def flash_bwd_dq_plain(qb, kb, vb, dob, lse, delta, sm_scale: float,
                       window=None, chunk=None, pos0=None) -> torch.Tensor:
    """dq [B,Hkv,rep,T,D] f32: scale dS k with bf16 dS."""
    _, ds = _bwd_ds(qb, kb, vb, dob, lse, delta, sm_scale, window, chunk,
                    pos0)
    return torch.einsum("bhrts,bhsd->bhrtd", ds.to(torch.bfloat16).float(),
                        kb.to(torch.bfloat16).float()) * sm_scale


def flash_bwd_delta(o: torch.Tensor, dout: torch.Tensor):
    """Kernel (a) of csrc/flash_bwd.cu; see `flash_bwd_delta_plain`."""
    if not o.is_cuda:
        return flash_bwd_delta_plain(o, dout)
    _build.no_grad("flash_bwd_delta", "bwd", o, dout)
    if o.shape != dout.shape or o.shape[-1] != BWD_D:
        raise ValueError(f"flash_bwd_delta: o {tuple(o.shape)} and dout "
                         f"{tuple(dout.shape)} (head_dim {BWD_D})")
    of, df = (a.to(torch.float32).contiguous() for a in (o, dout))
    delta = torch.empty(o.shape[:-1], dtype=torch.float32, device=o.device)
    dob = torch.empty(o.shape, dtype=torch.bfloat16, device=o.device)
    err = _build.library().pq_flash_bwd_delta(
        of.data_ptr(), df.data_ptr(), delta.data_ptr(), dob.data_ptr(),
        delta.numel(), _build.stream_ptr(o))
    _build.check(err, "flash_bwd_delta")
    flash_bwd_delta.launches += 1
    return delta, dob


def _bwd_launch(name, entry, outs, qb, kb, vb, dob, lse, delta, sm_scale,
                window, chunk, p0):
    b, hkv, rep, t, d = qb.shape
    if (d != BWD_D or kb.shape != (b, hkv, t, d) or vb.shape != kb.shape
            or dob.shape != qb.shape or lse.shape != qb.shape[:-1]
            or delta.shape != lse.shape):
        raise ValueError(f"{name}: shapes q {tuple(qb.shape)}, k "
                         f"{tuple(kb.shape)}, dO {tuple(dob.shape)}, lse "
                         f"{tuple(lse.shape)} (head_dim {BWD_D})")
    if chunk is not None and p0 is None:
        raise ValueError(f"{name}: a chunk needs pos0")
    ins = _bf16(qb, kb, vb, dob) + tuple(
        a.to(torch.float32).contiguous() for a in (lse, delta))
    win = t if window is None else min(window, t)
    err = getattr(_build.library(), entry)(
        *(a.data_ptr() for a in ins + outs),
        None if p0 is None else p0.data_ptr(), b, hkv, rep, t, win,
        chunk or 0, d, float(sm_scale), _build.stream_ptr(qb))
    _build.check(err, name)


def flash_bwd_dkv(qb, kb, vb, dob, lse, delta, sm_scale: float, window=None,
                  chunk=None, pos0=None):
    """Kernel (b) of csrc/flash_bwd.cu; see `flash_bwd_dkv_plain`.  pos0:
    [B] int32 on the device under a chunk."""
    if not qb.is_cuda:
        return flash_bwd_dkv_plain(qb, kb, vb, dob, lse, delta, sm_scale,
                                   window, chunk, pos0)
    _build.no_grad("flash_bwd_dkv", "bwd", qb, kb, vb, dob, lse, delta)
    dk = torch.empty(kb.shape, dtype=torch.float32, device=kb.device)
    dv = torch.empty_like(dk)
    _bwd_launch("flash_bwd_dkv", "pq_flash_bwd_dkv", (dk, dv), qb, kb, vb,
                dob, lse, delta, sm_scale, window, chunk, pos0)
    flash_bwd_dkv.launches += 1
    return dk, dv


def flash_bwd_dq(qb, kb, vb, dob, lse, delta, sm_scale: float, window=None,
                 chunk=None, pos0=None) -> torch.Tensor:
    """Kernel (c) of csrc/flash_bwd.cu; see `flash_bwd_dq_plain`."""
    if not qb.is_cuda:
        return flash_bwd_dq_plain(qb, kb, vb, dob, lse, delta, sm_scale,
                                  window, chunk, pos0)
    _build.no_grad("flash_bwd_dq", "bwd", qb, kb, vb, dob, lse, delta)
    dq = torch.empty(qb.shape, dtype=torch.float32, device=qb.device)
    _bwd_launch("flash_bwd_dq", "pq_flash_bwd_dq", (dq,), qb, kb, vb, dob,
                lse, delta, sm_scale, window, chunk, pos0)
    flash_bwd_dq.launches += 1
    return dq


flash_bwd_delta.launches = flash_bwd_dkv.launches = 0
flash_bwd_dq.launches = 0


def flash_attn_bwd_plain(q, k, v, dout, sm_scale: float, window=None,
                         chunk=None, pos0=None):
    """(dq, dk, dv) f32: torch.autograd.grad of `flash_attn_plain` in f32
    (its bf16 roundings pass the gradient through), the reference the
    kernels are held against."""
    with torch.enable_grad():
        qf, kf, vf = (a.detach().float().requires_grad_() for a in (q, k, v))
        out = flash_attn_plain(qf, kf, vf, sm_scale, window, None, chunk,
                               pos0)
        return torch.autograd.grad(out, (qf, kf, vf), dout.float())


def bwd_rounding_bound(q, k, v, dout, sm_scale: float, window=None,
                       chunk=None, pos0=None):
    """(bq, bk, bv) f32: the most that the kernels' bf16 roundings can move
    each gradient element from `flash_attn_bwd_plain`'s f32 gradient, as
    `rounding_bound` bounds the forward.  With P the probabilities and u =
    2^-8 (bf16's relative rounding): M_v = P^T |dO| sums the |terms| of dV,
    whose P and dO the kernels round and whose P the plain version rounds
    (3u M_v); M_p[i, j] = |dO_i| . |v_j| + S_i, S_i = sum_j' P[i, j']
    |dO_i| . |v_j'|, bounds |dP - delta| and the errors of both (dO
    rounded, in dP and in delta: u |dO_i| . |v_j| + u S_i; delta from the
    forward's context, whose probabilities each version rounds: 2u S_i; in
    all 3u M_p); M_s = P M_p bounds |dS|, which the kernels round (u M_s),
    so dS moves by at most 4u M_s, and dK, dQ by 4u M_k, 4u M_q with M_k =
    scale M_s^T |q|, M_q = scale M_s |k|.  The bound is 5u M for dQ and dK,
    4u M for dV; f32 summation order adds under 2^-20 M.  It holds the
    worst case of each element; `bwd_norm_gap` within BWD_NORM_RTOL is the
    tight check."""
    with torch.no_grad():
        qb, kb, vb = (a.to(torch.bfloat16).float() for a in (q, k, v))
        do = dout.float().abs()
        lse = flash_attn_lse_plain(q, k, sm_scale, window, chunk, pos0)
        p = torch.exp(_scores(q, k, sm_scale, window, None, chunk, pos0)
                      - lse[..., None])
        mv = torch.einsum("bhrts,bhrtd->bhsd", p, do)
        mp = torch.einsum("bhrtd,bhsd->bhrts", do, vb.abs())
        mp = mp + (p * mp).sum(-1, keepdim=True)
        ms = p * mp
        del mp
        mk = torch.einsum("bhrts,bhrtd->bhsd", ms, qb.abs()) * sm_scale
        mq = torch.einsum("bhrts,bhsd->bhrtd", ms, kb.abs()) * sm_scale
        u = 2.0 ** -8
        return 5 * u * mq, 5 * u * mk, 4 * u * mv


# the norm-wise limit of a gradient of the kernels against
# `flash_attn_bwd_plain`'s, of each (b, head) slice: 2u.  Sound kernels and
# the plain versions read about u (the bf16 roundings of P and dS), 1.25u
# with the inputs' bf16 on top; a backward that moves its window's start
# by one key reads 4u and more at a window of 1000 (tests and chip_smoke.py
# plant such faults)
BWD_NORM_RTOL = 2.0 ** -7


def bwd_norm_gap(got, want):
    """(dq, dk, dv) against (dq, dk, dv): for each, the largest ||g - w|| /
    ||w|| over its (b, head) slices (q heads for dq, kv heads for dk and
    dv).  Elementwise, `bwd_rounding_bound` holds each element to the
    summed |terms| it rounds, which a fault on a few low-probability pairs
    stays under; this reads the whole slice against its own size."""
    gaps = []
    for g, w in zip(got, want):
        lead = 3 if g.dim() == 5 else 2
        g, w = g.float().flatten(lead), w.float().flatten(lead)
        gaps.append(float(((g - w).norm(dim=-1)
                           / w.norm(dim=-1).clamp_min(1e-30)).max()))
    return tuple(gaps)


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
