"""Flash-decode over the stacked kv8 or kv4 cache (counterpart of
piquant_tpu/ops/pallas/decode_attn2.py: `decode_attention_state` and both
forms of `_kernel`).

`decode_attn2` (kv8) and `decode_attn2_kv4` (the pair-packed kv4 cache of
quant/kv_cache.py) launch the hand-written kernel (csrc/decode_attn2.cu) on
CUDA tensors and run `decode_attn2_plain`, the same function in plain
PyTorch, on CPU tensors.  All return the UNNORMALIZED state (acc, m, l)
over the live window start <= p < pos, with m = -1e30, l = 0, acc = 0 for
a row with no live position.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from piquant_tpu_torch.ops.cuda import _build
from piquant_tpu_torch.quant.kv_cache import merge_scale_pairs, unpack4_pairs

S_CHUNK = 512      # the reference's chunk; only its shape gate is kept here
NEG_INF = -1e30
_KERNEL_CHUNK = 256   # cache positions per block (csrc/decode_attn2.cu)
_D = (128, 256)      # head dims the kernel takes


def decode_attn2_plain(q, k_codes, k_scale, v_codes, v_scale, positions,
                       starts, sm_scale: float, layer: int):
    """q [B,Hkv,rep,D]; stacked kv8 cache [L,B,Hkv,S,D] int8 with scales
    [L,B,Hkv,S,1] f32, or kv4 cache [L,B,Hkv,S/2,D] uint8 with scales
    [L,B,Hkv,2,S/2] f32 (its codes unpacked to [-7, 7]); positions/starts
    [B] int32; any D (the kernels take 128 and 256)."""
    kc, vc = k_codes[layer], v_codes[layer]
    ks, vs = k_scale[layer], v_scale[layer]
    if kc.dtype == torch.uint8:
        kc, vc = unpack4_pairs(kc), unpack4_pairs(vc)   # [B,Hkv,S,D] int8
        ks, vs = merge_scale_pairs(ks), merge_scale_pairs(vs)
    kc, vc = kc.float(), vc.float()
    ks, vs = ks[..., 0], vs[..., 0]                   # [B,Hkv,S]
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


def _launch(entry, kv4, q, k_codes, k_scale, v_codes, v_scale, positions,
            starts, sm_scale, layer):
    """Shared checks, scratch and launch of the two cache forms."""
    name = entry[3:]
    b, hkv, rep, d = q.shape
    nl, nb, nh, rows, cd = k_codes.shape
    s_len = 2 * rows if kv4 else rows
    if d not in _D or cd != d:
        raise NotImplementedError(
            f"{name}: head_dim {d} (the kernel takes 128 and 256)")
    if not 1 <= rep <= 8:
        raise NotImplementedError(f"{name}: GQA rep {rep} "
                                  "(the kernel takes 1 to 8)")
    if (nb, nh) != (b, hkv) or not 0 <= layer < nl:
        raise ValueError(f"{name}: q and cache shapes disagree")
    cdt = torch.uint8 if kv4 else torch.int8
    if (k_codes.dtype != cdt or v_codes.dtype != cdt
            or k_scale.dtype != torch.float32
            or v_scale.dtype != torch.float32):
        raise TypeError(f"{name}: {'kv4' if kv4 else 'kv8'} cache expected "
                        f"({cdt} codes, f32 scales)")
    sshape = ((nl, nb, nh, 2, rows) if kv4 else (nl, nb, nh, s_len, 1))
    if (k_scale.shape != sshape or v_scale.shape != sshape
            or v_codes.shape != k_codes.shape):
        raise ValueError(f"{name}: codes and scales must be "
                         f"{list(k_codes.shape)} and {list(sshape)}")
    for t in (k_codes, k_scale, v_codes, v_scale):
        if not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"{name}: cache must be contiguous and on "
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
    err = getattr(_build.library(), entry)(
        qb.data_ptr(), k_codes.data_ptr(), k_scale.data_ptr(),
        v_codes.data_ptr(), v_scale.data_ptr(), pos.data_ptr(),
        st.data_ptr(), acc.data_ptr(), m.data_ptr(), l.data_ptr(),
        part_acc.data_ptr(), part_ml.data_ptr(), layer, b, hkv, rep, s_len,
        d, float(sm_scale), _build.stream_ptr(q))
    _build.check(err, name)
    return acc, m, l


def decode_attn2(q, k_codes, k_scale, v_codes, v_scale, positions, starts,
                 sm_scale: float, layer: int):
    """Kernel wrapper for the kv8 cache; see `decode_attn2_plain` for the
    function."""
    if not q.is_cuda:
        return decode_attn2_plain(q, k_codes, k_scale, v_codes, v_scale,
                                  positions, starts, sm_scale, layer)
    out = _launch("pq_decode_attn2", False, q, k_codes, k_scale, v_codes,
                  v_scale, positions, starts, sm_scale, layer)
    decode_attn2.launches += 1
    return out


def decode_attn2_kv4(q, k_codes, k_scale, v_codes, v_scale, positions,
                     starts, sm_scale: float, layer: int):
    """Kernel wrapper for the pair-packed kv4 cache; see
    `decode_attn2_plain` for the function."""
    if not q.is_cuda:
        return decode_attn2_plain(q, k_codes, k_scale, v_codes, v_scale,
                                  positions, starts, sm_scale, layer)
    out = _launch("pq_decode_attn2_kv4", True, q, k_codes, k_scale, v_codes,
                  v_scale, positions, starts, sm_scale, layer)
    decode_attn2_kv4.launches += 1
    return out


decode_attn2.launches = decode_attn2_kv4.launches = 0


def decode_attention_state(
    q: torch.Tensor,          # [B, Hkv, rep, D]
    k_codes: torch.Tensor,    # stacked [L, B, Hkv, S, D] int8, or kv4
                              # [L, B, Hkv, S/2, D] uint8 (pair-packed)
    k_scale: torch.Tensor,    # [L, B, Hkv, S, 1] f32, kv4 [L, B, Hkv, 2, S/2]
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
    128, S not a multiple of the reference chunk, an odd kv4 chunk, kv4
    scales not parity-split).  The reference's (sc/2) % 128 lane gate of a
    compiled kv4 kernel is a TPU block-shape limit and is dropped; its
    unstacked form is not ported."""
    if k_codes.ndim != 5:
        raise ValueError("decode_attention_state takes the stacked cache "
                         "[L, B, Hkv, S, D]")
    kv4 = k_codes.dtype == torch.uint8
    d = q.shape[-1]
    rows = k_codes.shape[-2]
    s_len = 2 * rows if kv4 else rows
    if d % 128 or k_codes.shape[-1] != d:
        return None
    sc = min(S_CHUNK, s_len)
    if s_len % sc:
        return None
    if kv4 and (sc % 2 or k_scale.shape[-2:] != (2, rows)
                or v_scale.shape[-2:] != (2, rows)):
        return None
    pos = positions.to(torch.int32)
    st = torch.zeros_like(pos) if starts is None else starts.to(torch.int32)
    attn = decode_attn2_kv4 if kv4 else decode_attn2
    return attn(q, k_codes, k_scale, v_codes, v_scale, pos, st, sm_scale,
                layer)
