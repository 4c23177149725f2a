"""INT8 / INT4 quantized KV cache (counterpart of
piquant_tpu/quant/kv_cache.py).

K and V are stored as symmetric codes with a per-(batch, head, position)
f32 scale, heads leading so attention reads are contiguous:

    kv8:  k_codes/v_codes : int8  [B, H_kv, S_max,   D]
          k_scale/v_scale : f32   [B, H_kv, S_max,   1]
    kv4:  k_codes/v_codes : uint8 [B, H_kv, S_max/2, D]   (pair-packed)
          k_scale/v_scale : f32   [B, H_kv, 2, S_max/2]   (parity-split)

kv4 storage, byte for byte the reference's: position p's D codes in [-7, 7]
are pack4'ed into D/2 bytes (byte j holds code j + 8 in the low nibble and
code j + D/2 + 8 in the high one), and row t of the codes holds position
2t's bytes in lanes [0, D/2) and position 2t+1's in lanes [D/2, D).  So the
codes viewed as [.., S_max, D/2] are one pack4 row a position, and every
write below is a position write into that view; the scale of position p
sits at [.., p % 2, p // 2].

The model keeps a STACKED cache with one more leading layer axis
([L, B, H_kv, ...]; `length` [L, B]).  Unlike the reference's immutable
arrays, the append functions write into the buffers in place and return
the same cache.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from piquant_tpu_torch._device import DeviceLike, resolve_device

_EPS = 1e-8
_QMAX = 127.0


@dataclasses.dataclass
class KVCache:
    k_codes: torch.Tensor
    v_codes: torch.Tensor
    k_scale: torch.Tensor
    v_scale: torch.Tensor
    length: torch.Tensor   # int32 valid positions per batch row

    @property
    def max_len(self) -> int:
        return cache_max_len(self)

    @property
    def bits(self) -> int:
        # kv4 codes are nibble-packed uint8; kv8 codes are int8
        return 4 if self.k_codes.dtype == torch.uint8 else 8

    def tensors(self):
        return (self.k_codes, self.v_codes, self.k_scale, self.v_scale,
                self.length)


def cache_max_len(cache: KVCache) -> int:
    """Positions of capacity (kv4 stores S/2 code rows)."""
    if cache.bits == 4:
        return cache.k_scale.shape[-1] * 2
    return cache.k_codes.shape[-2]


def pack4(codes: torch.Tensor) -> torch.Tensor:
    """Split-half nibble pack along the last (head_dim) axis: byte i holds
    code i (low nibble) and code i + D/2 (high), both offset by 8."""
    d = codes.shape[-1]
    c = (codes.to(torch.int32) + 8).to(torch.uint8)
    return c[..., : d // 2] | (c[..., d // 2:] << 4)


def unpack4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of pack4: uint8 [..., D/2] -> int8 codes [..., D]."""
    p = packed.to(torch.int32)
    return torch.cat([(p & 15) - 8, (p >> 4) - 8], dim=-1).to(torch.int8)


def pack4_pairs(codes: torch.Tensor) -> torch.Tensor:
    """[..., T, D] codes -> [..., T/2, D] uint8 storage rows, row t =
    [pack4(pos 2t) | pack4(pos 2t+1)]; T must be even."""
    t, d = codes.shape[-2], codes.shape[-1]
    if t % 2:
        raise ValueError("pack4_pairs needs an even position count")
    return pack4(codes).reshape(*codes.shape[:-2], t // 2, d)


def unpack4_pairs(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of pack4_pairs: uint8 [..., S/2, D] -> int8 [..., S, D]."""
    sp, d = packed.shape[-2], packed.shape[-1]
    return unpack4(packed.reshape(*packed.shape[:-2], 2 * sp, d // 2))


def split_scale_pairs(scale: torch.Tensor) -> torch.Tensor:
    """Per-position scales [..., T, 1] -> parity-split [..., 2, T/2]."""
    t = scale.shape[-2]
    return scale.reshape(*scale.shape[:-2], t // 2, 2).transpose(-1, -2)


def merge_scale_pairs(scale2: torch.Tensor) -> torch.Tensor:
    """Inverse of split_scale_pairs: [..., 2, S/2] -> [..., S, 1]."""
    sp = scale2.shape[-1]
    return scale2.transpose(-1, -2).reshape(*scale2.shape[:-2], 2 * sp, 1)


def kv_cache_init(batch: int, n_kv_heads: int, max_len: int, head_dim: int,
                  bits: int = 8, *, device: DeviceLike = None) -> KVCache:
    """bits=4 stores the pair-packed uint8 codes (half the bytes of kv8);
    it needs an even head_dim and an even max_len."""
    if bits not in (4, 8):
        raise ValueError("KV cache bits must be 4 or 8")
    if bits == 4 and head_dim % 2:
        raise ValueError("kv_bits=4 needs an even head_dim")
    if bits == 4 and max_len % 2:
        raise ValueError("kv_bits=4 needs an even max_len")
    dev = resolve_device(device)
    if bits == 4:
        codes = (batch, n_kv_heads, max_len // 2, head_dim)
        scales = (batch, n_kv_heads, 2, max_len // 2)
        cdt = torch.uint8
    else:
        codes = (batch, n_kv_heads, max_len, head_dim)
        scales = codes[:-1] + (1,)
        cdt = torch.int8
    return KVCache(
        k_codes=torch.zeros(codes, dtype=cdt, device=dev),
        v_codes=torch.zeros(codes, dtype=cdt, device=dev),
        k_scale=torch.zeros(scales, dtype=torch.float32, device=dev),
        v_scale=torch.zeros(scales, dtype=torch.float32, device=dev),
        length=torch.zeros((batch,), dtype=torch.int32, device=dev),
    )


def _quantize_sym(x: torch.Tensor, bits: int = 8
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric quantization along the last axis (per token+head): codes
    in [-127, 127] (kv8) or [-7, 7] (kv4, returned pack4'ed, [..., D/2]).
    Rounds half to EVEN like the reference's `jnp.round`, so `torch.round`
    is the matching op here (not round_half_away)."""
    qmax = _QMAX if bits == 8 else 7.0
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=_EPS) / qmax
    codes = torch.clamp(torch.round(xf / scale), -qmax, qmax).to(torch.int8)
    if bits == 4:
        return pack4(codes), scale
    return codes, scale


def _positions_view(codes: torch.Tensor) -> torch.Tensor:
    """The code buffer as one row a position: itself for kv8, the
    [.., S, D/2] view of the pair-packed rows for kv4."""
    if codes.dtype != torch.uint8:
        return codes
    return codes.view(*codes.shape[:-2], 2 * codes.shape[-2],
                      codes.shape[-1] // 2)


def _scale_at(p: torch.Tensor, kv4: bool):
    """Index tuple of the scales of positions p (trailing axes)."""
    return (p % 2, p // 2) if kv4 else (p, torch.zeros_like(p))


def kv_cache_append_stacked(
    cache: KVCache,
    layer: int,
    k_new: torch.Tensor,    # [B, H_kv, T, D] float
    v_new: torch.Tensor,
    positions: torch.Tensor,  # [B, T] int32, each row [start, start + T)
    contiguous_start: int,
) -> KVCache:
    """Quantize one layer's prefill K/V and write it, in place, at
    [start, start + T) of every row (the reference's contiguous path; its
    scattered path serves chunked prefill, which is not ported yet).  A
    kv4 start or T of either parity writes whole positions: the other half
    of a pair row the range only touches keeps its position."""
    bits = cache.bits
    kc, ks = _quantize_sym(k_new, bits)
    vc, vs = _quantize_sym(v_new, bits)
    new_len = torch.maximum(cache.length[layer],
                            positions.amax(dim=-1).to(torch.int32) + 1)
    cache.length[layer] = torch.clamp(new_len, max=cache.max_len)
    t = k_new.shape[2]
    sl = slice(contiguous_start, contiguous_start + t)
    _positions_view(cache.k_codes)[layer, :, :, sl] = kc
    _positions_view(cache.v_codes)[layer, :, :, sl] = vc
    if bits == 4:
        p = torch.arange(contiguous_start, contiguous_start + t,
                         device=ks.device)
        cache.k_scale[layer][:, :, p % 2, p // 2] = ks[..., 0]
        cache.v_scale[layer][:, :, p % 2, p // 2] = vs[..., 0]
    else:
        cache.k_scale[layer, :, :, sl] = ks
        cache.v_scale[layer, :, :, sl] = vs
    return cache


def kv_cache_append_stacked_batch(
    cache: KVCache,
    k_codes: torch.Tensor,   # [L, B, H, T, D] int8, or [L, B, H, T, D/2]
                             # uint8 pack4 codes (kv4); already quantized
    k_scale: torch.Tensor,   # [L, B, H, T, 1] f32
    v_codes: torch.Tensor,
    v_scale: torch.Tensor,
    positions: torch.Tensor,  # [B, T] int32
) -> KVCache:
    """Write ALL layers' pre-quantized K/V in one scatter per buffer (the
    deferred decode append).  In place: one `index_put_` per buffer writes
    straight into the stacked cache, where the reference's functional
    scatter relies on XLA aliasing the buffer.

    A position at or past max_len is dropped, as the reference's scatter
    drops it (the engine's finished slots step on for up to two blocks):
    it is aimed at the last position and writes back what is there.  For
    kv4 that is the odd half of the last pair row and its scale, so the
    even half and its scale are never touched.  That assumes no row also
    writes the last position in the same call, which holds for decode
    (T = 1)."""
    s = cache.max_len
    kv4 = cache.bits == 4
    new_len = torch.maximum(cache.length,
                            positions.amax(dim=-1).to(torch.int32)[None] + 1)
    cache.length.copy_(torch.clamp(new_len, max=s))
    nl, nb, nh = k_codes.shape[:3]
    dev = k_codes.device
    inside = (positions < s)[None, :, None, :]            # [1, B, 1, T]
    lead = (torch.arange(nl, device=dev)[:, None, None, None],
            torch.arange(nb, device=dev)[None, :, None, None],
            torch.arange(nh, device=dev)[None, None, :, None])
    p = positions.clamp(max=s - 1).long()[None, :, None, :]
    cidx = lead + (p,)
    sidx = lead + _scale_at(p, kv4)
    for buf, new in ((cache.k_codes, k_codes), (cache.v_codes, v_codes)):
        view = _positions_view(buf)
        view.index_put_(cidx, torch.where(inside[..., None],
                                          new.to(buf.dtype), view[cidx]))
    for buf, new in ((cache.k_scale, k_scale), (cache.v_scale, v_scale)):
        buf.index_put_(sidx, torch.where(inside, new[..., 0], buf[sidx]))
    return cache


def kv_cache_copy_rows(dst: KVCache, src: KVCache,
                       rows: torch.Tensor) -> KVCache:
    """Copy every position of the stacked cache `src` (a prefill burst's
    own cache, as wide as its padded prompts) into batch rows `rows` of the
    stacked cache `dst`, at its first positions, with its lengths.  In
    place; positions past src's are left as they are."""
    if dst.bits != src.bits:
        raise ValueError("caches of different code widths")
    s = src.max_len
    for big, small in zip((dst.k_codes, dst.v_codes), (src.k_codes,
                                                       src.v_codes)):
        _positions_view(big)[:, rows, :, :s] = _positions_view(small)
    for big, small in zip((dst.k_scale, dst.v_scale), (src.k_scale,
                                                       src.v_scale)):
        if dst.bits == 4:        # parity-split: S/2 columns a parity
            big[:, rows, :, :, :s // 2] = small
        else:
            big[:, rows, :, :s] = small
    dst.length[:, rows] = src.length
    return dst


def kv_cache_append(
    cache: KVCache,
    k_new: torch.Tensor,      # [B, H_kv, T, D] float
    v_new: torch.Tensor,
    positions: torch.Tensor,  # [B, T] int32 absolute positions to write
) -> KVCache:
    """Quantize new K/V and write them, in place, at `positions` of an
    UNSTACKED cache ([B, H_kv, ...]).  Positions at or past max_len are
    dropped, as the reference's scatter drops them, and `length` stays
    within the capacity."""
    bits = cache.bits
    kc, ks = _quantize_sym(k_new, bits)
    vc, vs = _quantize_sym(v_new, bits)
    s = cache.max_len
    new_len = torch.maximum(cache.length,
                            positions.amax(dim=-1).to(torch.int32) + 1)
    cache.length.copy_(torch.clamp(new_len, max=s))
    nh = k_new.shape[1]
    bi, ti = (positions < s).nonzero(as_tuple=True)   # the kept writes
    p = positions[bi, ti].long()
    b_, h_ = bi[:, None], torch.arange(nh, device=p.device)[None]
    p_ = p[:, None]
    for buf, new in ((cache.k_codes, kc), (cache.v_codes, vc)):
        _positions_view(buf)[b_, h_, p_] = new[b_, h_, ti[:, None]]
    for buf, new in ((cache.k_scale, ks), (cache.v_scale, vs)):
        buf[(b_, h_) + _scale_at(p_, bits == 4)] = (
            new[b_, h_, ti[:, None], 0])
    return cache


def kv_cache_read(cache: KVCache, dtype=torch.bfloat16
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dequantize a whole unstacked cache -> (k, v) [B, H_kv, S_max, D]
    each (masking past `length` is the caller's)."""
    kc, vc = cache.k_codes, cache.v_codes
    ks, vs = cache.k_scale, cache.v_scale
    if cache.bits == 4:
        kc, vc = unpack4_pairs(kc), unpack4_pairs(vc)
        ks, vs = merge_scale_pairs(ks), merge_scale_pairs(vs)
    return ((kc.float() * ks).to(dtype), (vc.float() * vs).to(dtype))
