"""The first flash-decode kernel over one layer's kv8 cache (counterpart of
piquant_tpu/ops/pallas/attention.py: `decode_attention` and
`_decode_attn_kernel`).

`decode_attn` launches the hand-written kernel (the V1 mode of
csrc/decode_attn2.cu) on CUDA tensors and runs `decode_attn_plain`, the
same function in plain PyTorch, on CPU tensors.  Both return the
NORMALIZED context over the cache positions 0 <= p <= pos: the current
token is already in the cache.  The model reaches it only on the
non-deferred decode path under PIQUANT_TPU_PALLAS_ATTN=1, as the reference
does (models/llama.py `_attention`).
"""

from __future__ import annotations

from typing import Optional

import torch

from piquant_tpu_torch.ops.cuda import _build
from piquant_tpu_torch.ops.cuda.decode_attn2 import check_head_dim, scratch

S_CHUNK = 512      # the reference's chunk of the online softmax
NEG_INF = -1e30


def decode_attn_plain(q, k_codes, k_scale, v_codes, v_scale, positions,
                      sm_scale: float) -> torch.Tensor:
    """q [B,Hkv,rep,D]; one layer's kv8 cache, codes [B,Hkv,S,D] int8 and
    scales [B,Hkv,S,1] f32; positions [B] -> ctx [B,Hkv,rep,D] f32
    (`_decode_attn_kernel`): the online softmax over chunks of
    min(512, S) positions in order, scores = (bf16 q . codes) * (ks *
    sm_scale) with positions past pos masked, probabilities times the V
    scale rounded to bf16 before the PV product, ctx = acc / l."""
    b, hkv, rep, d = q.shape
    s_len = k_codes.shape[2]
    sc = min(S_CHUNK, s_len)
    qf = q.to(torch.bfloat16).float()
    pos = positions.to(device=q.device, dtype=torch.int64)
    f32 = dict(dtype=torch.float32, device=q.device)
    m = torch.full((b, hkv, rep, 1), NEG_INF, **f32)
    l = torch.zeros((b, hkv, rep, 1), **f32)
    acc = torch.zeros((b, hkv, rep, d), **f32)
    for s0 in range(0, s_len, sc):
        kb = k_codes[:, :, s0:s0 + sc].float()
        scores = torch.einsum("bhrd,bhsd->bhrs", qf, kb)
        scores = scores * (k_scale[:, :, None, s0:s0 + sc, 0] * sm_scale)
        idx = torch.arange(s0, s0 + sc, device=q.device)
        valid = (idx[None, :] <= pos[:, None])[:, None, None, :]
        scores = torch.where(valid, scores, NEG_INF)
        # a chunk wholly past pos leaves the state as it is: its p are 0
        # and its correction exp(0) = 1 (the reference skips it)
        m_new = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
        p = torch.exp(scores - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        m = m_new
        pv = (p * v_scale[:, :, None, s0:s0 + sc, 0]).to(torch.bfloat16)
        acc = acc * corr + torch.einsum(
            "bhrs,bhsd->bhrd", pv.float(), v_codes[:, :, s0:s0 + sc].float())
    return acc / l


def decode_attn(q, k_codes, k_scale, v_codes, v_scale, positions,
                sm_scale: float) -> torch.Tensor:
    """Kernel wrapper; see `decode_attn_plain` for the function."""
    if not q.is_cuda:
        return decode_attn_plain(q, k_codes, k_scale, v_codes, v_scale,
                                 positions, sm_scale)
    name = "decode_attn"
    b, hkv, rep, d = q.shape
    nb, nh, s_len, cd = k_codes.shape
    check_head_dim(name, d)
    if (nb, nh) != (b, hkv) or cd != d:
        raise ValueError(f"{name}: q and cache shapes disagree")
    if (k_codes.dtype != torch.int8 or v_codes.dtype != torch.int8
            or k_scale.dtype != torch.float32
            or v_scale.dtype != torch.float32):
        raise TypeError(f"{name}: kv8 cache expected (int8 codes, f32 "
                        "scales)")
    sshape = (nb, nh, s_len, 1)
    if (tuple(k_scale.shape) != sshape or tuple(v_scale.shape) != sshape
            or v_codes.shape != k_codes.shape):
        raise ValueError(f"{name}: codes and scales must be "
                         f"{list(k_codes.shape)} and {list(sshape)}")
    for t in (k_codes, k_scale, v_codes, v_scale):
        if not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"{name}: cache must be contiguous and on q's "
                             "device")
    qb = q.to(torch.bfloat16).contiguous()
    pos = positions.to(device=q.device, dtype=torch.int32).contiguous()
    ctx = torch.empty((b, hkv, rep, d), dtype=torch.float32,
                      device=q.device)
    tps, part_acc, part_ml, tick = scratch(q, s_len)
    err = _build.library().pq_decode_attn(
        qb.data_ptr(), k_codes.data_ptr(), k_scale.data_ptr(),
        v_codes.data_ptr(), v_scale.data_ptr(), pos.data_ptr(),
        ctx.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(),
        tick.data_ptr(), b, hkv, rep, s_len, d, tps, float(sm_scale),
        _build.stream_ptr(q))
    _build.check(err, name)
    decode_attn.launches += 1
    return ctx


decode_attn.launches = 0


def decode_attention(q: torch.Tensor, k_codes: torch.Tensor,
                     k_scale: torch.Tensor, v_codes: torch.Tensor,
                     v_scale: torch.Tensor, positions: torch.Tensor,
                     sm_scale: float) -> Optional[torch.Tensor]:
    """ctx [B, Hkv, rep, D] f32 over one layer's kv8 cache (q [B, Hkv, rep,
    D], codes [B, Hkv, S, D] int8, scales [B, Hkv, S, 1] f32, positions
    [B]: positions 0 .. pos attend), or None where the reference has no
    kernel for the geometry: head_dim % 128, S % 8, or S not a multiple of
    its chunk min(512, S)."""
    d = q.shape[-1]
    s_len = k_codes.shape[2]
    if d % 128 or s_len % 8:
        return None
    if s_len % min(S_CHUNK, s_len):
        return None
    return decode_attn(q, k_codes, k_scale, v_codes, v_scale, positions,
                       sm_scale)
