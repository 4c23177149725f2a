"""Plain PyTorch versions of every library-core op (counterpart of
piquant_tpu/ops/reference.py).

Each function runs on whatever device its input lies on.  They are the
plain versions the kernel wrappers in `ops/cuda` run for CPU tensors, what
`chip_smoke.py` holds the kernels against on the card, and the path for the
dtype pairs that have no kernel (f64, 32/64-bit codes), as the JAX package
leaves those to jnp.  The arithmetic is the reference's, op for op:

  * nearest rounding is half away from zero, trunc(r + copysign(0.5, r)),
    with r = x * (1/scale) in f32 (f64 for f64 input);
  * the float -> int32 cast saturates and sends NaN to 0, and the zero point
    is then added with int32 wraparound, as XLA does (so +inf at zp 7
    quantizes to uint8 0, and NaN to zp); torch's own cast is undefined
    there, so `_sat_i32` spells it out;
  * stochastic rounding is trunc(r) + sign(r) when u < |r - trunc(r)|.  The
    uniform u comes from a counter hash of (seed, element index) that the
    CUDA kernels compute too (`uniform`), so kernel and plain version agree
    bit for bit; against the JAX package, whose bits come from jax.random,
    the agreement is statistical;
  * dequantize is (code - zp) * scale, rounded to the output type, then
    added to the accumulator for ADD (bf16: two roundings, as the jnp
    reference does).  ADD writes into `out` in place and returns it.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from piquant_tpu_torch.dtypes import QDType, dtype_of

_I32_MIN, _I32_MAX = -(1 << 31), (1 << 31) - 1


def round_half_away(x: torch.Tensor) -> torch.Tensor:
    """Round half away from zero (ties outward), matching C std::round.

    `torch.round` rounds half to even (0.5 -> 0, 2.5 -> 2), so it is not
    this function.  The formula is the reference's, op for op, so the f32
    result is bit-identical (including its ulp behaviour just below .5)."""
    half = torch.where(x >= 0, 0.5, -0.5).to(x.dtype)
    return torch.trunc(x + half)


def inv_scale_f32(scale):
    """1/scale in f32.  A host scalar takes numpy's IEEE reciprocal, as the
    reference does; a tensor takes `torch.reciprocal` on its own device,
    which is IEEE-rounded on the CPU and on CUDA alike (the CUDA kernels use
    `__frcp_rn`, the same rounding), so no scale is read back to the host."""
    if isinstance(scale, torch.Tensor):
        return torch.reciprocal(scale.to(torch.float32))
    return float(np.float32(1.0) / np.float32(scale))


def _as_acc(v, acc: torch.dtype):
    """A scale (host number or tensor) in the arithmetic dtype `acc`."""
    if isinstance(v, torch.Tensor):
        return v.to(acc)
    return float(v) if acc == torch.float64 else float(np.float32(v))


def wrap_i32(z: int) -> int:
    """A host integer wrapped to int32, as the reference's int32 cast."""
    return (int(z) + (1 << 31)) % (1 << 32) - (1 << 31)


def _as_i64(zp):
    """A zero point as int64 (tensor) or int (host), wrapped to 64 bits."""
    if isinstance(zp, torch.Tensor):
        return zp.to(torch.int64)
    z = int(zp) & ((1 << 64) - 1)
    return z - (1 << 64) if z >= 1 << 63 else z


def _sat_i32(r: torch.Tensor) -> torch.Tensor:
    """Integral-valued floats -> int32, saturating, NaN -> 0 (XLA's
    convert; torch's `.to(torch.int32)` is undefined out of range)."""
    hi = r >= 2.0 ** 31
    lo = r < -(2.0 ** 31)
    safe = torch.where(hi | lo | r.isnan(), 0.0, r).to(r.dtype)
    i = safe.to(torch.int32)
    i = torch.where(hi, _I32_MAX, i)
    return torch.where(lo, _I32_MIN, i)


def _check_quant(dt: QDType) -> None:
    if not dt.is_quant:
        raise ValueError(f"destination dtype {dt.name} is not a quantized type")


def _check_float(dt: QDType) -> None:
    if not dt.is_float:
        raise ValueError(f"dtype {dt.name} is not a float type")


# ---------------------------------------------------------------------------
# the stochastic-rounding uniforms (the CUDA kernels compute the same bits)
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """x * c mod 2^32 for int64 x in [0, 2^32), without int64 overflow."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """The 32-bit integer hash `pq::mix32` of csrc/pq_quant.cuh."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def uniform(seed: int, n: int, device, dtype=torch.float32) -> torch.Tensor:
    """n uniforms in [0, 1) with 23 bits each, element i from the hash of
    (seed, i): mix32(mix32(i_lo ^ s_lo) + (s_hi ^ i_hi)) >> 9."""
    s = int(seed) & ((1 << 64) - 1)
    s_lo, s_hi = s & _M32, s >> 32
    i = torch.arange(n, dtype=torch.int64, device=device)
    h = _mix32((_mix32((i & _M32) ^ s_lo) + ((i >> 32) ^ s_hi)) & _M32)
    return (h >> 9).to(dtype) * (1.0 / (1 << 23))


# ---------------------------------------------------------------------------
# storage <-> codes (torch has no arithmetic on uint16/32/64: go through the
# signed type of the same width, which has the same bits)
# ---------------------------------------------------------------------------

_SIGNED_VIEW = {torch.uint16: torch.int16, torch.uint32: torch.int32,
                torch.uint64: torch.int64}


def _to_storage(codes: torch.Tensor, dt: QDType) -> torch.Tensor:
    signed = _SIGNED_VIEW.get(dt.storage)
    if signed is None:
        return codes.to(dt.storage)
    return codes.to(signed).view(dt.storage)


def _from_storage(q: torch.Tensor, dt: QDType) -> torch.Tensor:
    """Storage elements -> codes in the compute dtype.  Only uint16/32/64
    storage needs the signed detour; any other integer tensor converts."""
    signed = _SIGNED_VIEW.get(q.dtype)
    if signed is None:
        return q.to(dt.compute)
    bits = torch.iinfo(signed).bits
    v = q.view(signed).to(torch.int64)
    return (v & ((1 << bits) - 1) if bits < 64 else v).to(dt.compute)


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------

def pack_codes(codes: torch.Tensor, qdtype: Union[QDType, str]) -> torch.Tensor:
    """Flat integer codes -> the wire format (flat storage tensor): sub-byte
    codes LSB-first into bytes with the tail byte's unused bits zero; wider
    codes cast to the storage dtype."""
    dt = dtype_of(qdtype)
    _check_quant(dt)
    if not dt.is_packed:
        return _to_storage(codes, dt)
    pf = dt.pack_factor
    npad = (-codes.numel()) % pf
    # two's-complement truncation to `bits` (signed sub-byte codes), and
    # zero padding after masking, so the tail bits stay zero
    c = codes.to(torch.int32) & ((1 << dt.bits) - 1)
    if npad:
        c = torch.cat([c, c.new_zeros(npad)])
    c = c.reshape(-1, pf)
    packed = c[:, 0]
    for k in range(1, pf):
        packed = packed | (c[:, k] << (k * dt.bits))
    return packed.to(torch.uint8)


def unpack_codes(packed: torch.Tensor, numel: int,
                 qdtype: Union[QDType, str]) -> torch.Tensor:
    """Inverse of pack_codes: flat storage -> flat codes (compute dtype),
    signed sub-byte codes sign-extended from their field."""
    dt = dtype_of(qdtype)
    _check_quant(dt)
    if not dt.is_packed:
        return _from_storage(packed, dt)
    pf = dt.pack_factor
    mask = (1 << dt.bits) - 1
    shifts = torch.arange(pf, dtype=torch.int32, device=packed.device) * dt.bits
    fields = (packed.to(torch.int32)[:, None] >> shifts[None, :]) & mask
    codes = fields.reshape(-1)[:numel]
    if dt.kind == "int":
        half = 1 << (dt.bits - 1)
        codes = torch.where(codes >= half, codes - (1 << dt.bits), codes)
    return codes.to(dt.compute)


# ---------------------------------------------------------------------------
# quantize
# ---------------------------------------------------------------------------

def quantize_codes(x: torch.Tensor, scale, zero_point, qdtype,
                   round_mode: str = "nearest", *,
                   seed: Optional[int] = None) -> torch.Tensor:
    """Floats -> UNPACKED integer codes (compute dtype).  Arithmetic runs in
    f32 for <= 32-bit floats and in f64 for f64 input."""
    dt = dtype_of(qdtype)
    _check_quant(dt)
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    r = x.to(acc) * _as_acc(inv_scale_f32(scale), acc)
    if round_mode == "nearest":
        rounded = round_half_away(r)
    elif round_mode == "stochastic":
        if seed is None:
            raise ValueError("stochastic rounding requires a seed")
        u = uniform(seed, r.numel(), r.device, acc).reshape(r.shape)
        t = torch.trunc(r)
        frac = (r - t).abs()
        step = torch.where(u < frac, torch.where(r < 0, -1.0, 1.0), 0.0)
        rounded = t + step.to(acc)
    else:
        raise ValueError(f"unknown round_mode {round_mode!r}")
    zp = _as_i64(zero_point)
    if dt.bits <= 16:
        # int32 add with wraparound, then the exact clamp
        integral = (_sat_i32(rounded).to(torch.int64) + zp).to(torch.int32)
        return integral.clamp(dt.qmin, dt.qmax)
    # wide codes: range-limit the float first so the int64 cast is defined
    rf = torch.nan_to_num(rounded.to(torch.float64), nan=0.0)
    integral = rf.clamp(-(2.0 ** 62), 2.0 ** 62).to(torch.int64) + zp
    return integral.clamp(dt.qmin, dt.qmax).to(dt.compute)


def quantize(x: torch.Tensor, scale, zero_point, qdtype,
             round_mode: str = "nearest", *,
             seed: Optional[int] = None) -> torch.Tensor:
    """Floats -> flat packed storage tensor."""
    dt = dtype_of(qdtype)
    codes = quantize_codes(x.reshape(-1), scale, zero_point, dt, round_mode,
                           seed=seed)
    return pack_codes(codes, dt)


def _code_diff(codes: torch.Tensor, zero_point, dt: QDType) -> torch.Tensor:
    """codes - zp, exactly, in the integer domain: int32 for <= 16-bit codes
    (as the kernels), int64 with wraparound above (uint64: the bits of the
    reference's uint64 subtraction reinterpreted as int64)."""
    zp = _as_i64(zero_point)
    if dt.bits <= 16:
        if isinstance(zp, torch.Tensor):
            return codes.to(torch.int32) - zp.to(torch.int32)
        return codes.to(torch.int32) - wrap_i32(zp)
    return codes.to(torch.int64) - zp


def _store(out: torch.Tensor, dq: torch.Tensor) -> torch.Tensor:
    out.add_(dq.reshape(out.shape))
    return out


# ---------------------------------------------------------------------------
# dequantize / requantize
# ---------------------------------------------------------------------------

def dequantize(q: torch.Tensor, numel: int, scale, zero_point, qdtype,
               out_dtype="f32", reduce_op: str = "set",
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Flat packed storage -> flat floats.  reduce_op='set' returns the new
    tensor; 'add' adds into `out` in place and returns it."""
    dt = dtype_of(qdtype)
    odt = dtype_of(out_dtype)
    _check_quant(dt)
    _check_float(odt)
    if reduce_op not in ("set", "add"):
        raise ValueError(f"unknown reduce_op {reduce_op!r}")
    codes = unpack_codes(q.reshape(-1), numel, dt)
    acc = torch.float64 if odt.name == "f64" else torch.float32
    diff = _code_diff(codes, zero_point, dt).to(acc)
    dq = (diff * _as_acc(scale, acc)).to(odt.storage)
    if reduce_op == "add":
        if out is None:
            raise ValueError("reduce_op='add' requires an `out` tensor")
        return _store(out, dq)
    return dq


def requantize(x: torch.Tensor, scale, zero_point, qdtype,
               round_mode: str = "nearest", reduce_op: str = "set",
               out: Optional[torch.Tensor] = None, *,
               seed: Optional[int] = None) -> torch.Tensor:
    """Fused quantize -> dequantize (fake-quant), flat, in x's dtype; 'add'
    adds into `out` in place and returns it."""
    dt = dtype_of(qdtype)
    codes = quantize_codes(x.reshape(-1), scale, zero_point, dt, round_mode,
                           seed=seed)
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    diff = _code_diff(codes, zero_point, dt).to(acc)
    dq = (diff * _as_acc(scale, acc)).to(x.dtype)
    if reduce_op == "add":
        if out is None:
            raise ValueError("reduce_op='add' requires an `out` tensor")
        return _store(out, dq)
    if reduce_op != "set":
        raise ValueError(f"unknown reduce_op {reduce_op!r}")
    return dq


# ---------------------------------------------------------------------------
# quant-param derivation
# ---------------------------------------------------------------------------

def params_from_min_max(rmin: torch.Tensor, rmax: torch.Tensor, qdtype):
    """(scale f32, zero_point int32) 0-d tensors from the data's f32 min and
    max, on their device, with no host sync:
        scale = (rmax - rmin) / (qmax - qmin)
        zp    = clamp(round_half_away(qmin - rmin / scale), qmin, qmax)
    and rmax == rmin -> (1.0, (qmax + qmin) >> 1).  Divisors are device
    tensors: torch turns a division by a host scalar into a multiplication
    by its reciprocal, which is not the reference's IEEE quotient."""
    dt = dtype_of(qdtype)
    _check_quant(dt)
    qmin, qmax = float(dt.qmin), float(dt.qmax)
    span = rmax - rmin
    qrange = torch.full((), float(np.float32(qmax - qmin)),
                        dtype=torch.float32, device=span.device)
    scale = span / qrange
    zp = float(np.float32(qmin)) - rmin / scale
    zp = round_half_away(zp).clamp(qmin, qmax)
    degenerate = span == 0
    mid = (dt.qmax + dt.qmin) >> 1
    scale = torch.where(degenerate, 1.0, scale).to(torch.float32)
    zp = torch.where(degenerate, float(np.float32(mid)), zp).to(torch.float32)
    return scale, _sat_i32(zp)


def min_max(x: torch.Tensor) -> torch.Tensor:
    """[min, max] of x in f32 (NaN anywhere gives NaN for both)."""
    xf = x.reshape(-1).to(torch.float32)
    return torch.stack([xf.amin(), xf.amax()])


def compute_quant_params(x: torch.Tensor, qdtype):
    """Asymmetric affine (scale, zero_point) from the data's min and max."""
    mm = min_max(x)
    return params_from_min_max(mm[0], mm[1], qdtype)
