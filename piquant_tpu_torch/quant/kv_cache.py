"""INT8-quantized KV cache: the kv8 subset of piquant_tpu/quant/kv_cache.py.

K and V are stored as int8 codes with a per-(batch, head, position)
symmetric f32 scale, heads leading so attention reads are contiguous:

    k_codes/v_codes : int8 [B, H_kv, S_max, D]
    k_scale/v_scale : f32  [B, H_kv, S_max, 1]

The model keeps a STACKED cache with one more leading layer axis
([L, B, H_kv, S_max, D]; `length` [L, B]).  Unlike the reference's
immutable arrays, the append functions write into the buffers in place and
return the same cache.  The kv4 pair-packed layout is not ported yet.
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
        return self.k_codes.shape[-2]

    def tensors(self):
        return (self.k_codes, self.v_codes, self.k_scale, self.v_scale,
                self.length)


def kv_cache_init(batch: int, n_kv_heads: int, max_len: int, head_dim: int,
                  bits: int = 8, *, device: DeviceLike = None) -> KVCache:
    if bits != 8:
        raise NotImplementedError("only the kv8 cache is ported (kv4 is not)")
    dev = resolve_device(device)
    shape = (batch, n_kv_heads, max_len, head_dim)
    return KVCache(
        k_codes=torch.zeros(shape, dtype=torch.int8, device=dev),
        v_codes=torch.zeros(shape, dtype=torch.int8, device=dev),
        k_scale=torch.zeros(shape[:-1] + (1,), dtype=torch.float32, device=dev),
        v_scale=torch.zeros(shape[:-1] + (1,), dtype=torch.float32, device=dev),
        length=torch.zeros((batch,), dtype=torch.int32, device=dev),
    )


def _quantize_sym(x: torch.Tensor, bits: int = 8
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization along the last axis (per token+head).
    Rounds half to EVEN like the reference's `jnp.round`, so `torch.round`
    is the matching op here (not round_half_away)."""
    if bits != 8:
        raise NotImplementedError("only kv8 quantization is ported")
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=_EPS) / _QMAX
    codes = torch.clamp(torch.round(xf / scale), -_QMAX, _QMAX)
    return codes.to(torch.int8), scale


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
    scattered path serves chunked prefill, which is not ported yet)."""
    kc, ks = _quantize_sym(k_new)
    vc, vs = _quantize_sym(v_new)
    new_len = torch.maximum(cache.length[layer],
                            positions.amax(dim=-1).to(torch.int32) + 1)
    cache.length[layer] = torch.clamp(new_len, max=cache.max_len)
    sl = slice(contiguous_start, contiguous_start + k_new.shape[2])
    cache.k_codes[layer, :, :, sl] = kc
    cache.v_codes[layer, :, :, sl] = vc
    cache.k_scale[layer, :, :, sl] = ks
    cache.v_scale[layer, :, :, sl] = vs
    return cache


def kv_cache_append_stacked_batch(
    cache: KVCache,
    k_codes: torch.Tensor,   # [L, B, H, T, D] int8, already quantized
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
    it is aimed at the last position and writes back what is there.  That
    assumes no row also writes the last position in the same call, which
    holds for decode (T = 1)."""
    s = cache.max_len
    new_len = torch.maximum(cache.length,
                            positions.amax(dim=-1).to(torch.int32)[None] + 1)
    cache.length.copy_(torch.clamp(new_len, max=s))
    nl, nb, nh = k_codes.shape[:3]
    dev = k_codes.device
    inside = (positions < s)[None, :, None, :, None]      # [1, B, 1, T, 1]
    idx = (torch.arange(nl, device=dev)[:, None, None, None],
           torch.arange(nb, device=dev)[None, :, None, None],
           torch.arange(nh, device=dev)[None, None, :, None],
           positions.clamp(max=s - 1).long()[None, :, None, :])
    for buf, new in ((cache.k_codes, k_codes), (cache.v_codes, v_codes),
                     (cache.k_scale, k_scale), (cache.v_scale, v_scale)):
        buf.index_put_(idx, torch.where(inside, new.to(buf.dtype), buf[idx]))
    return cache
