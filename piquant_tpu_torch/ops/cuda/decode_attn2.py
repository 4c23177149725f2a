"""Flash-decode over the stacked kv8 cache (counterpart of
piquant_tpu/ops/pallas/decode_attn2.py: `decode_attention_state` and the
kv8 form of `_kernel`).

`decode_attn2` launches the hand-written kernel (csrc/decode_attn2.cu) on
CUDA tensors and runs `decode_attn2_plain`, the same function in plain
PyTorch, on CPU tensors.  Both return the UNNORMALIZED state (acc, m, l)
over the live window start <= p < pos, with m = -1e30, l = 0, acc = 0 for
a row with no live position.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from piquant_tpu_torch.ops.cuda import _build

S_CHUNK = 512      # the reference's chunk; only its shape gate is kept here
NEG_INF = -1e30
_KERNEL_CHUNK = 256   # cache positions per block (csrc/decode_attn2.cu)
_D = 128


def decode_attn2_plain(q, k_codes, k_scale, v_codes, v_scale, positions,
                       starts, sm_scale: float, layer: int):
    """q [B,Hkv,rep,D]; stacked kv8 cache [L,B,Hkv,S,D] int8 with scales
    [L,B,Hkv,S,1] f32; positions/starts [B] int32."""
    kc = k_codes[layer].float()                       # [B,Hkv,S,D]
    vc = v_codes[layer].float()
    ks = k_scale[layer][..., 0]                       # [B,Hkv,S]
    vs = v_scale[layer][..., 0]
    s_len = kc.shape[2]
    scores = torch.einsum("bhrd,bhsd->bhrs",
                          q.to(torch.bfloat16).float(), kc)
    scores = scores * (ks * sm_scale)[:, :, None, :]
    idx = torch.arange(s_len, device=q.device)
    live = ((idx[None, :] >= starts[:, None])
            & (idx[None, :] < positions[:, None]))[:, None, None, :]
    scores = torch.where(live, scores, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(live, torch.exp(scores - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    pv = (p * vs[:, :, None, :]).to(torch.bfloat16).float()
    acc = torch.einsum("bhrs,bhsd->bhrd", pv, vc)
    return acc, m, l


def decode_attn2(q, k_codes, k_scale, v_codes, v_scale, positions, starts,
                 sm_scale: float, layer: int):
    """Kernel wrapper; see `decode_attn2_plain` for the function."""
    if not q.is_cuda:
        return decode_attn2_plain(q, k_codes, k_scale, v_codes, v_scale,
                                  positions, starts, sm_scale, layer)
    b, hkv, rep, d = q.shape
    nl, nb, nh, s_len, cd = k_codes.shape
    if d != _D or cd != _D:
        raise NotImplementedError(
            f"decode_attn2: head_dim {d} (the kernel takes 128)")
    if rep not in (1, 2, 4, 8):
        raise NotImplementedError(f"decode_attn2: GQA rep {rep} "
                                  "(the kernel takes 1, 2, 4 or 8)")
    if (nb, nh) != (b, hkv) or not 0 <= layer < nl:
        raise ValueError("decode_attn2: q and cache shapes disagree")
    if (k_codes.dtype != torch.int8 or v_codes.dtype != torch.int8
            or k_scale.dtype != torch.float32
            or v_scale.dtype != torch.float32):
        raise TypeError("decode_attn2: kv8 cache expected (int8 codes, f32 "
                        "scales)")
    if k_scale.shape != (nl, nb, nh, s_len, 1) or v_scale.shape != k_scale.shape:
        raise ValueError("decode_attn2: scales must be [L, B, Hkv, S, 1]")
    for t in (k_codes, k_scale, v_codes, v_scale):
        if not t.is_contiguous() or t.device != q.device:
            raise ValueError("decode_attn2: cache must be contiguous and on "
                             "q's device")
    qb = q.to(torch.bfloat16).contiguous()
    pos = positions.to(device=q.device, dtype=torch.int32).contiguous()
    st = starts.to(device=q.device, dtype=torch.int32).contiguous()
    nsplit = -(-s_len // _KERNEL_CHUNK)
    f32 = dict(dtype=torch.float32, device=q.device)
    acc = torch.empty((b, hkv, rep, d), **f32)
    m = torch.empty((b, hkv, rep, 1), **f32)
    l = torch.empty((b, hkv, rep, 1), **f32)
    part_acc = torch.empty((b, hkv, nsplit, rep, d), **f32)
    part_ml = torch.empty((b, hkv, nsplit, rep, 2), **f32)
    err = _build.library().pq_decode_attn2(
        qb.data_ptr(), k_codes.data_ptr(), k_scale.data_ptr(),
        v_codes.data_ptr(), v_scale.data_ptr(), pos.data_ptr(),
        st.data_ptr(), acc.data_ptr(), m.data_ptr(), l.data_ptr(),
        part_acc.data_ptr(), part_ml.data_ptr(), layer, b, hkv, rep, s_len,
        float(sm_scale), _build.stream_ptr(q))
    _build.check(err, "decode_attn2")
    decode_attn2.launches += 1
    return acc, m, l


decode_attn2.launches = 0


def decode_attention_state(
    q: torch.Tensor,          # [B, Hkv, rep, D]
    k_codes: torch.Tensor,    # stacked [L, B, Hkv, S, D] int8
    k_scale: torch.Tensor,    # [L, B, Hkv, S, 1] f32
    v_codes: torch.Tensor,
    v_scale: torch.Tensor,
    positions: torch.Tensor,  # [B] int32: cache positions p < pos attend
    sm_scale: float,
    *,
    layer: int,
    starts: Optional[torch.Tensor] = None,  # [B] first attended position
) -> Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """(acc [B,Hkv,rep,D] f32, m [B,Hkv,rep,1], l [B,Hkv,rep,1]) over the
    live window [starts, positions) of one layer of the stacked cache, or
    None where the reference has no kernel for the geometry (head_dim %
    128, or S not a multiple of the reference chunk).  kv8 only: the kv4
    layout is not ported yet (nor the reference's unstacked form)."""
    if k_codes.ndim != 5:
        raise ValueError("decode_attention_state takes the stacked cache "
                         "[L, B, Hkv, S, D]")
    if k_codes.dtype != torch.int8:
        raise NotImplementedError("kv4 caches are not ported yet")
    d = q.shape[-1]
    s_len = k_codes.shape[-2]
    if d % 128 or k_codes.shape[-1] != d:
        return None
    if s_len % min(S_CHUNK, s_len):
        return None
    pos = positions.to(torch.int32)
    st = torch.zeros_like(pos) if starts is None else starts.to(torch.int32)
    return decode_attn2(q, k_codes, k_scale, v_codes, v_scale, pos, st,
                        sm_scale, layer)
