"""Weight-only quantized linear layers: the affine INT2 / INT4 / INT8 subset
of piquant_tpu/quant/linear.py (channelwise, per-tensor and grouped).

Storage is byte-identical to the reference.  A 4-bit weight W[K, N] is the
"split-half" bytes B[K//2, N] with
    B[k, n] = (codes[k, n] & 0xF) | (codes[k + K//2, n] << 4),
and a 2-bit weight the "split-quarter" bytes B[K//4, N] whose byte row k
holds code rows k, k + K/4, k + K/2, k + 3K/4 in bits 0-1, 2-3, 4-5, 6-7,
so a weight packed by either package can be read by the other, and
    x @ W = sum_p x[:, p*K/P:(p+1)*K/P] @ deq(plane p).
The affine zero point folds analytically,
    x @ ((c - zp) * s) = (x @ c) * s - (sum_k x) * (zp * s),
so the products run on the raw codes (exact in bf16) with f32 accumulation.
Grouped weights carry (G, N) scales and zero points, and for the grouped
decode kernel the same values chunk-major as bf16 scales and int8 zero
points (`s_chunk`, `z_chunk`, see `_grouped_cache`).

Activation quantization (`quantized_matmul(act_quant=...)`, W4A8 / W8A8 /
W2A8 and grouped W4A8-g / W2A8-g) quantizes x per token to int8
(`_quantize_act`) and runs exact int32 products against the raw codes:
    y = ((xq @ c) * s - (sum_k xq) * (zp * s)) * xs.
It follows the reference's accelerator route, gate for gate: where a
kernel gate declines, the call runs the weight-only path on the
unquantized x (ROADMAP.md section 3 lists where that differs from the
reference's CPU fallback, which quantizes at every shape).

MoE experts are a QuantizedExpertStack: E weights of one geometry stacked
on a leading axis, which the ragged expert GEMMs (ops/cuda/ragged.py) read
in place and `expert(i)` views as a QuantizedLinear.

NF4 (codebook "nf4") weights store the same split-half bytes, but a code
indexes the 16-entry NormalFloat-4 table: w = NF4_CODEBOOK[c] * scale with
an absmax scale per channel, tensor or group and no zero point.  Their
matmul takes the NF4 GEMV at decode M (`nf4_gemv`, bf16 table values as
the reference's kernel rounds them), one dense bf16 product at M >= 256,
and the f32 table product between (`_matmul_nf4`); int8 activations never
apply to them.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from piquant_tpu_torch.ops.cuda import qmatmul as _qmm
from piquant_tpu_torch.ops.reference import round_half_away

ACT_QUANT_MIN_M = 256   # the reference's prefill-sized M: act_quant=True
                        # quantizes activations at or above it (INT8
                        # weights only there, also under "all"), and
                        # grouped weights at or above it run one dense bf16
                        # product on the weight-only route


# ---------------------------------------------------------------------------
# split-half / split-quarter packing
# ---------------------------------------------------------------------------

def pack_split_half(codes: torch.Tensor) -> torch.Tensor:
    """Pack int4 codes [K, N] -> bytes [K//2, N] (split-half layout)."""
    k = codes.shape[0]
    if k % 2:
        raise ValueError(f"K={k} must be even for split-half packing")
    lo = codes[: k // 2].to(torch.uint8) & 0xF
    hi = codes[k // 2:].to(torch.uint8) & 0xF
    return lo | (hi << 4)


def pack_split_quarter(codes: torch.Tensor) -> torch.Tensor:
    """Pack int2 codes [K, N] -> bytes [K//4, N] (split-quarter layout)."""
    k = codes.shape[0]
    if k % 4:
        raise ValueError(f"K={k} must be divisible by 4 for split-quarter")
    q = k // 4
    c = codes.to(torch.uint8) & 3
    return (c[:q] | (c[q:2 * q] << 2) | (c[2 * q:3 * q] << 4)
            | (c[3 * q:] << 6))


def unpack_split_half(packed: torch.Tensor) -> torch.Tensor:
    """bytes [K//2, N] -> int32 codes [K, N]."""
    b = packed.to(torch.int32)
    return torch.cat([b & 15, (b >> 4) & 15], dim=0)


def unpack_split_quarter(packed: torch.Tensor) -> torch.Tensor:
    """bytes [K//4, N] -> int32 codes [K, N]."""
    b = packed.to(torch.int32)
    return torch.cat([b & 3, (b >> 2) & 3, (b >> 4) & 3, b >> 6], dim=0)


# ---------------------------------------------------------------------------
# NF4 codebook (non-uniform 4-bit)
# ---------------------------------------------------------------------------

# The QLoRA NormalFloat-4 codebook (Dettmers et al., arXiv:2305.14314):
# quantiles of N(0, 1) normalized to [-1, 1], with an exact zero at index 7.
NF4_CODEBOOK = (
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
    -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
    0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
    0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
    0.7229568362236023, 1.0)

CODEBOOKS = {"nf4": NF4_CODEBOOK}


def codebook_lut(codebook: str, dtype=torch.float32,
                 device=None) -> torch.Tensor:
    """The codebook's 16 values as a tensor (f32 values cast to `dtype`)."""
    return torch.tensor(CODEBOOKS[codebook], dtype=torch.float32,
                        device=device).to(dtype)


def codebook_encode(normalized: torch.Tensor, codebook: str) -> torch.Tensor:
    """Nearest-entry indices (int32) of values in [-1, 1]: the number of
    f32 midpoints (lut[i] + lut[i+1]) / 2 that x exceeds strictly, as the
    reference counts them (a tie goes to the lower entry)."""
    lut = CODEBOOKS[codebook]
    x = normalized.float()
    code = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    for i in range(len(lut) - 1):
        mid = np.float32((lut[i] + lut[i + 1]) * 0.5)
        code += (x > float(mid)).to(torch.int32)
    return code


def codebook_decode(codes: torch.Tensor, codebook: str,
                    dtype=torch.float32) -> torch.Tensor:
    """codes in [0, 15] -> the codebook's f32 values, cast to `dtype`."""
    return codebook_lut(codebook, device=codes.device)[codes.long()].to(dtype)


def grouped_chunk_factor(k: int, group_size: int,
                         planes: int = 4) -> Optional[int]:
    """Groups-per-plane chunk factor CH of the grouped decode kernel (the
    reference's chunk-grid layout): CH divides the per-plane group count;
    None if the shape does not fit the kernel."""
    if k % (planes * group_size):
        return None
    gp = (k // planes) // group_size
    for c in ((8, 4) if planes == 4 else (8,)):
        if gp % c == 0:
            return c
    return None


@functools.lru_cache(maxsize=None)
def grouped_chunk_perm(k: int, group_size: int, ch: int,
                       planes: int = 4) -> np.ndarray:
    """Chunk-major group order of the side streams:
    perm[c*planes*CH + p*CH + t] = p*gp + c*CH + t (plane p, chunk c of CH
    groups per plane)."""
    gp = (k // planes) // group_size
    out = np.empty(planes * gp, np.int32)
    i = 0
    for c in range(gp // ch):
        for p in range(planes):
            for t in range(ch):
                out[i] = p * gp + c * ch + t
                i += 1
    return out


def _grouped_cache(scale: torch.Tensor, zp: torch.Tensor, k: int,
                   group_size: int, bits: int):
    """Kernel-ready grouped side streams: chunk-major bf16 scales and
    chunk-major raw int8 zero points, 3 bytes per group entry; (None, None)
    where the shape has no chunk factor.  The groups are the second-last
    axis ([G, N], or [E, G, N] for an expert stack)."""
    if bits not in (2, 4):
        return None, None
    planes = _qmm.PLANES[bits]
    ch = grouped_chunk_factor(k, group_size, planes)
    if ch is None:
        return None, None
    perm = torch.from_numpy(grouped_chunk_perm(k, group_size, ch, planes)
                            ).to(scale.device).long()
    return (scale.to(torch.bfloat16)[..., perm, :],
            zp.to(torch.int8)[..., perm, :])


# ---------------------------------------------------------------------------
# the reference wire ABI (adjacent-element bytes, low field first)
# ---------------------------------------------------------------------------

def wire_to_split_quarter(wire: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """uint2 wire bytes (4 crumbs a byte, LSB first, over the row-major
    [K, N] array) -> split-quarter [K//4, N]."""
    flat = wire.reshape(-1).to(torch.uint8)
    crumbs = torch.stack([(flat >> (2 * i)) & 3 for i in range(4)], dim=1)
    return pack_split_quarter(crumbs.reshape(-1)[: k * n].reshape(k, n))


def split_quarter_to_wire(packed: torch.Tensor) -> torch.Tensor:
    """Split-quarter [K//4, N] -> wire bytes of the [K, N] array."""
    c = unpack_split_quarter(packed).to(torch.uint8).reshape(-1, 4)
    return c[:, 0] | (c[:, 1] << 2) | (c[:, 2] << 4) | (c[:, 3] << 6)


def wire_to_split_half(wire: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """uint4 wire bytes (adjacent pairs, low nibble first, over the
    row-major [K, N] array) -> split-half [K//2, N]."""
    flat = wire.reshape(-1).to(torch.uint8)
    codes = torch.stack([flat & 0xF, flat >> 4], dim=1).reshape(-1)
    return pack_split_half(codes[: k * n].reshape(k, n))


def split_half_to_wire(packed: torch.Tensor) -> torch.Tensor:
    """Split-half [K//2, N] -> wire bytes of the [K, N] array."""
    codes = unpack_split_half(packed).to(torch.uint8).reshape(-1)
    return (codes[0::2] & 0xF) | ((codes[1::2] & 0xF) << 4)


# ---------------------------------------------------------------------------
# QuantizedLinear
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class QuantizedLinear:
    """Packed weight + affine params for y = x @ W.

    data: uint8 [K//4, N] (int2 split-quarter), [K//2, N] (int4
    split-half) or [K, N] (int8).
    scale/zero_point: (1, N) channelwise, (1, 1) per tensor or (G, N)
    grouped (group_size = K // G contraction rows per group), f32 / int32.
    s_chunk/z_chunk: grouped INT2/INT4 only, the kernel's side streams
    (chunk-major bf16 scales, raw int8 zero points; see _grouped_cache).
    codebook: "nf4" for NormalFloat-4 weights (bits 4, absmax scales, a
    zero zero_point kept for shape parity), None for affine ones.
    """

    data: torch.Tensor
    scale: torch.Tensor
    zero_point: torch.Tensor
    bits: int           # 2, 4 or 8
    k: int              # logical contraction dim
    group_size: Optional[int] = None
    s_chunk: Optional[torch.Tensor] = None
    z_chunk: Optional[torch.Tensor] = None
    codebook: Optional[str] = None

    @property
    def n(self) -> int:
        return self.data.shape[-1]

    def _expanded_params(self):
        """scale / zero point broadcast to [K or 1, N] float32."""
        s = self.scale.float()
        z = self.zero_point.float()
        if self.group_size is not None:
            s = s.repeat_interleave(self.group_size, dim=0)
            z = z.repeat_interleave(self.group_size, dim=0)
        return s, z

    def codes(self) -> torch.Tensor:
        """int32 codes [K, N]."""
        if self.bits == 2:
            return unpack_split_quarter(self.data)
        if self.bits == 4:
            return unpack_split_half(self.data)
        return self.data.to(torch.int32)

    def to_wire(self) -> torch.Tensor:
        """Packed codes in the reference wire ABI (adjacent elements of the
        flattened [K, N] array, low field first)."""
        if self.codebook is not None:
            raise ValueError(f"{self.codebook} weights have no reference "
                             "wire ABI (its formats are affine)")
        if self.bits == 2:
            return split_quarter_to_wire(self.data)
        if self.bits == 4:
            return split_half_to_wire(self.data)
        return self.data.reshape(-1)

    @classmethod
    def from_wire(cls, wire: torch.Tensor, scale, zero_point, bits: int,
                  k: int, n: int, group_size: Optional[int] = None
                  ) -> "QuantizedLinear":
        """Build from reference-wire packed codes (inverse of to_wire)."""
        if bits == 2:
            data = wire_to_split_quarter(wire, k, n)
        elif bits == 4:
            data = wire_to_split_half(wire, k, n)
        else:
            data = wire.reshape(k, n)
        scale = torch.as_tensor(scale)
        zero_point = torch.as_tensor(zero_point)
        s_chunk = z_chunk = None
        if bits in (2, 4) and group_size is not None:
            s_chunk, z_chunk = _grouped_cache(scale, zero_point, k,
                                              group_size, bits)
        return cls(data=data, scale=scale, zero_point=zero_point, bits=bits,
                   k=k, group_size=group_size, s_chunk=s_chunk,
                   z_chunk=z_chunk)

    def dequantize(self, dtype=torch.bfloat16) -> torch.Tensor:
        """Materialize the full [K, N] float weight."""
        s, z = self._expanded_params()
        if self.codebook is not None:
            return (codebook_decode(self.codes(), self.codebook) * s).to(dtype)
        return ((self.codes().float() - z) * s).to(dtype)


def with_grouped_cache(ql: QuantizedLinear) -> QuantizedLinear:
    """Attach (or refresh) the grouped side streams; no-op for channelwise,
    INT8 and codebook weights."""
    if ql.bits not in (2, 4) or ql.group_size is None or ql.codebook:
        return ql
    s_chunk, z_chunk = _grouped_cache(ql.scale, ql.zero_point, ql.k,
                                      ql.group_size, ql.bits)
    return dataclasses.replace(ql, s_chunk=s_chunk, z_chunk=z_chunk)


@dataclasses.dataclass
class QuantizedExpertStack:
    """E stacked QuantizedLinear weights of one geometry (MoE experts):
    data [E, rows, N], scale / zero_point [E, G-or-1, N], and for grouped
    INT2/INT4 the stacked side streams s_chunk / z_chunk [E, G, N].
    `expert(i)` is expert i as a 2-D QuantizedLinear (views, no copy)."""

    data: torch.Tensor
    scale: torch.Tensor
    zero_point: torch.Tensor
    bits: int
    k: int
    group_size: Optional[int] = None
    s_chunk: Optional[torch.Tensor] = None
    z_chunk: Optional[torch.Tensor] = None
    codebook: Optional[str] = None

    @property
    def n_experts(self) -> int:
        return self.data.shape[0]

    @property
    def n(self) -> int:
        return self.data.shape[-1]

    def expert(self, i: int) -> QuantizedLinear:
        return QuantizedLinear(
            data=self.data[i], scale=self.scale[i],
            zero_point=self.zero_point[i], bits=self.bits, k=self.k,
            group_size=self.group_size,
            s_chunk=None if self.s_chunk is None else self.s_chunk[i],
            z_chunk=None if self.z_chunk is None else self.z_chunk[i],
            codebook=self.codebook)

    @staticmethod
    def stack(qls) -> "QuantizedExpertStack":
        q0 = qls[0]
        for q in qls[1:]:
            if (q.bits, q.k, q.group_size, tuple(q.data.shape),
                    q.codebook) != (q0.bits, q0.k, q0.group_size,
                                    tuple(q0.data.shape), q0.codebook):
                raise ValueError("experts must share geometry")
        has_cache = all(q.s_chunk is not None for q in qls)
        return QuantizedExpertStack(
            data=torch.stack([q.data for q in qls]),
            scale=torch.stack([q.scale for q in qls]),
            zero_point=torch.stack([q.zero_point for q in qls]),
            bits=q0.bits, k=q0.k, group_size=q0.group_size,
            s_chunk=(torch.stack([q.s_chunk for q in qls]) if has_cache
                     else None),
            z_chunk=(torch.stack([q.z_chunk for q in qls]) if has_cache
                     else None),
            codebook=q0.codebook)


def quantize_linear_weight(
    w: torch.Tensor,
    bits: int = 4,
    *,
    channelwise: bool = True,
    group_size: Optional[int] = None,
    stochastic: bool = False,
    generator: Optional[torch.Generator] = None,
) -> QuantizedLinear:
    """Quantize a [K, N] float weight for weight-only inference: affine
    (scale, zp) per output channel (axis 0 reduced), per tensor, or per
    (group_size x 1) group along K, with the reference's derivation op for
    op (grouped INT2/INT4 scales rounded to bf16 first, as the reference
    rounds them for its kernel's bf16 side stream).  bits="nf4" takes the
    NormalFloat-4 codebook (`_quantize_nf4`, always nearest).

    stochastic rounds the affine codes as floor(w / s + u) with u uniform in
    [0, 1) drawn from `generator` (the reference draws u from a jax.random
    key: the same distribution, other bits)."""
    if w.ndim != 2:
        raise ValueError("quantize_linear_weight expects a 2-D weight")
    if bits == "nf4":
        return _quantize_nf4(w, group_size=group_size,
                             channelwise=channelwise)
    if bits not in (2, 4, 8):
        raise ValueError('bits must be 2, 4, 8, or "nf4"')
    k, n = w.shape
    qmin, qmax = 0, (1 << bits) - 1
    wf = w.float()
    if group_size is not None:
        if k % group_size:
            raise ValueError(f"K={k} not divisible by group_size={group_size}")
        wg = wf.reshape(k // group_size, group_size, n)
        rmin, rmax = wg.amin(dim=1), wg.amax(dim=1)        # (G, N)
    elif channelwise:
        rmin = wf.amin(dim=0, keepdim=True)
        rmax = wf.amax(dim=0, keepdim=True)
    else:
        rmin = wf.amin().reshape(1, 1)
        rmax = wf.amax().reshape(1, 1)
    span = rmax - rmin
    scale = torch.where(span == 0, torch.ones_like(span),
                        span / (qmax - qmin)).float()
    if group_size is not None and bits in (2, 4):
        scale = scale.to(torch.bfloat16).float()
    zp = torch.clamp(round_half_away(qmin - rmin / scale), qmin, qmax)
    zp = torch.where(span == 0, torch.full_like(zp, (qmax + qmin) >> 1),
                     zp).to(torch.int32)
    if group_size is not None:
        s_full = scale.repeat_interleave(group_size, dim=0)
        z_full = zp.repeat_interleave(group_size, dim=0)
    else:
        s_full, z_full = scale, zp
    r = wf / s_full
    if stochastic:
        if generator is None:
            raise ValueError("stochastic quantization requires a generator")
        u = torch.rand(r.shape, generator=generator, device=r.device)
        rounded = torch.floor(r + u)
    else:
        rounded = round_half_away(r)
    codes = torch.clamp(rounded.to(torch.int32) + z_full, qmin, qmax)
    if bits == 2:
        data = pack_split_quarter(codes)
    elif bits == 4:
        data = pack_split_half(codes)
    else:
        data = codes.to(torch.uint8)
    return with_grouped_cache(QuantizedLinear(
        data=data, scale=scale, zero_point=zp, bits=bits, k=k,
        group_size=group_size))


def _quantize_nf4(w: torch.Tensor, *, group_size: Optional[int] = None,
                  channelwise: bool = True) -> QuantizedLinear:
    """NF4 weights, as the reference derives them: scale = max |w| per
    group, channel or tensor (1 where that is 0), codes the nearest
    codebook entries of w / scale, split-half packed."""
    k, n = w.shape
    wf = w.float()
    if group_size is not None:
        if k % group_size:
            raise ValueError(f"K={k} not divisible by group_size={group_size}")
        amax = wf.reshape(k // group_size, group_size, n).abs().amax(dim=1)
    elif channelwise:
        amax = wf.abs().amax(dim=0, keepdim=True)
    else:
        amax = wf.abs().amax().reshape(1, 1)
    scale = torch.where(amax == 0, torch.ones_like(amax), amax).float()
    s_full = (scale.repeat_interleave(group_size, dim=0)
              if group_size is not None else scale)
    codes = codebook_encode(wf / s_full, "nf4")
    return QuantizedLinear(data=pack_split_half(codes), scale=scale,
                           zero_point=torch.zeros(scale.shape,
                                                  dtype=torch.int32,
                                                  device=scale.device),
                           bits=4, k=k, group_size=group_size,
                           codebook="nf4")


# ---------------------------------------------------------------------------
# matmul
# ---------------------------------------------------------------------------

def dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., K] @ b [K, N] with f32 accumulation and f32 output — the
    reference's `jnp.dot(..., preferred_element_type=float32)`.  bf16
    operands multiply exactly in f32 either way; on the GPU the bf16 GEMM
    writes f32 directly instead of upcasting the weight."""
    lead = a.shape[:-1]
    a2 = a.reshape(-1, a.shape[-1])
    if a2.is_cuda and a2.dtype == b.dtype == torch.bfloat16:
        y = torch.mm(a2, b, out_dtype=torch.float32)
    else:
        y = a2.float() @ b.float()
    return y.reshape(*lead, b.shape[-1])


def _matmul_dequant(x: torch.Tensor, ql: QuantizedLinear,
                    out_dtype) -> torch.Tensor:
    """The reference's `_matmul_dequant_jnp`: grouped weights as per-group
    raw-code products with the zero point folded per group; channelwise as
    raw-code products on the packed planes, then the rank-1 fold."""
    scale = ql.scale.float()
    zp = ql.zero_point.float()
    if ql.group_size is not None:
        g, gs = ql.k // ql.group_size, ql.group_size
        lead = x.shape[:-1]
        xg = x.float().reshape(-1, g, gs).transpose(0, 1)     # [G, M, gs]
        cg = ql.codes().float().reshape(g, gs, ql.n)
        acc = torch.bmm(xg, cg)                               # [G, M, N]
        out = (acc * scale[:, None]).sum(0)
        out = out - xg.sum(-1).transpose(0, 1) @ (zp * scale)
        return out.reshape(*lead, ql.n).to(out_dtype)
    xb = x.to(torch.bfloat16)
    planes = _qmm.PLANES[ql.bits]
    rows = ql.k // planes
    acc = None
    for p, plane in enumerate(_qmm.code_planes(ql.data, planes)):
        part = dot_f32(xb[..., p * rows:(p + 1) * rows],
                       plane.to(torch.bfloat16))
        acc = part if acc is None else acc + part
    xsum = x.float().sum(dim=-1, keepdim=True)
    return (acc * scale - xsum * (zp * scale)).to(out_dtype)


def _matmul_nf4(x: torch.Tensor, ql: QuantizedLinear,
                out_dtype) -> torch.Tensor:
    """The reference's `_matmul_nf4_jnp`: the two split-half planes through
    the codebook in f32, scaled per channel or group in f32, and two f32
    products."""
    kh = ql.k // 2
    lo, hi = (codebook_decode(p, ql.codebook)
              for p in _qmm.code_planes(ql.data, 2))
    scale = ql.scale.float()
    xf = x.float()
    if ql.group_size is not None:
        s_full = scale.repeat_interleave(ql.group_size, dim=0)
        if kh % ql.group_size:
            # a group straddles the planes: one product on the whole weight
            return (xf @ (torch.cat([lo, hi]) * s_full)).to(out_dtype)
        w_lo, w_hi = lo * s_full[:kh], hi * s_full[kh:]
    else:
        w_lo, w_hi = lo * scale, hi * scale
    acc = xf[..., :kh] @ w_lo + xf[..., kh:] @ w_hi
    return acc.to(out_dtype)


def _quantize_act(x: torch.Tensor):
    """Dynamic per-token symmetric int8 activation quantization, the
    reference's op for op: xs = max(amax, 1e-8) / 127 in f32 and xq =
    clip(round(x / xs), -127, 127) with a true division and round half to
    even (torch.round, as jnp.round; not the library core's half-away)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    xs = torch.clamp_min(amax, 1e-8) / 127.0
    xq = torch.clamp(torch.round(xf / xs), -127, 127).to(torch.int8)
    return xq, xs


def quantized_matmul(x: torch.Tensor, ql: QuantizedLinear,
                     out_dtype=torch.bfloat16, *,
                     act_quant=False) -> torch.Tensor:
    """y = x @ dequant(W) with the weight kept packed, in the reference's
    order of routes on the accelerator: for codebook (NF4) weights the
    NF4 routes (see the module docstring); with act_quant (True: M >=
    ACT_QUANT_MIN_M; "all": every M; INT8 weights only at M >=
    ACT_QUANT_MIN_M) the int8-activation kernels where their gates take
    the shape; then the decode-sized kernels (ops/cuda/qmatmul.py); for
    grouped weights at prefill-sized M one dense product against the weight
    dequantized to bf16; else the dequant path."""
    if x.shape[-1] != ql.k:
        raise ValueError(f"x last dim {x.shape[-1]} != weight K {ql.k}")
    lead = x.shape[:-1]
    m = 1
    for d in lead:
        m *= d
    if ql.codebook is not None:
        # no zero-point fold and no int8-x form for a codebook: the NF4
        # GEMV, the dense bf16 product at prefill M, else the table product
        y = _qmm.nf4_matmul(x, ql, out_dtype)
        if y is not None:
            return y
        if m >= ACT_QUANT_MIN_M:
            w = ql.dequantize(torch.bfloat16)
            return dot_f32(x.to(torch.bfloat16), w).to(out_dtype)
        return _matmul_nf4(x, ql, out_dtype)
    use_a8 = (bool(act_quant)
              and (ql.group_size is None or ql.s_chunk is not None)
              and ql.bits in (2, 4, 8)
              and (ql.bits != 8 or m >= ACT_QUANT_MIN_M)
              and (act_quant == "all" or m >= ACT_QUANT_MIN_M))
    if use_a8:
        xq, xs = _quantize_act(x.reshape(m, ql.k))
        a8 = {2: _qmm.w2a8_matmul, 4: _qmm.w4a8_matmul,
              8: _qmm.w8a8_matmul}[ql.bits]
        y = a8(xq, xs, ql, out_dtype)
        if y is not None:
            return y.reshape(*lead, ql.n).to(out_dtype)
    y = _qmm.quantized_matmul(x, ql, out_dtype)
    if y is not None:
        return y
    if ql.group_size is not None and m >= ACT_QUANT_MIN_M:
        w = ql.dequantize(torch.bfloat16)
        return dot_f32(x.to(torch.bfloat16), w).to(out_dtype)
    return _matmul_dequant(x, ql, out_dtype)
