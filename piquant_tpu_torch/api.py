"""Public functional API of the port (counterpart of piquant_tpu/api.py).

The same functions, arguments and ValueErrors as the JAX package, on torch
tensors.  They run where their input lies: a CUDA tensor goes through the
hand-written kernels (ops/dispatch.py says which combinations), a CPU
tensor through the kernels' plain versions.  Three differences, each
forced by PyTorch:
  * stochastic rounding takes `generator=torch.Generator` where JAX takes
    `key=`: one 64-bit seed is drawn from it per call (a CPU generator
    costs no device sync), and the per-element uniforms are a hash of
    (seed, element index), not jax.random's bits;
  * reduce_op='add' adds into `out` IN PLACE and returns it (JAX returns a
    new array), so `out` must already have the result's dtype;
  * `QuantizedTensor` is a dataclass, not a pytree.

Validation contract (the reference's): quantize takes a float input and a
quant target; dequantize takes integer codes whose storage size is exactly
packed_numel(numel, dtype); requantize needs out.numel() == x.numel().
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple, Union

import torch

from piquant_tpu_torch.dtypes import QDType, dtype_of, packed_numel
from piquant_tpu_torch.ops import dispatch as _ops

__all__ = [
    "RoundMode", "ReduceOp", "QuantizedTensor", "quantize", "dequantize",
    "requantize", "quantize_dequantize_fused", "compute_quant_params",
    "quantize_tensor", "dequantize_tensor", "Context",
]

Scalar = Union[float, int, torch.Tensor]


class RoundMode(str, enum.Enum):
    NEAREST = "nearest"
    STOCHASTIC = "stochastic"


class ReduceOp(str, enum.Enum):
    SET = "set"
    ADD = "add"


def _as_float_input(x: torch.Tensor) -> QDType:
    try:
        dt = dtype_of(x.dtype)
    except ValueError:
        dt = None
    if dt is None or not dt.is_float:
        raise ValueError(f"quantize input must be f32/f64/bf16, got {x.dtype}")
    return dt


def _seed(round_mode: str, generator: Optional[torch.Generator]):
    """The call's 64-bit seed for stochastic rounding, drawn from the
    caller's generator (None for nearest)."""
    if round_mode != "stochastic":
        return None
    if generator is None:
        raise ValueError("stochastic rounding requires "
                         "generator=torch.Generator(...)")
    s = torch.randint(-(1 << 63), (1 << 63) - 1, (), generator=generator,
                      device=generator.device, dtype=torch.int64)
    return int(s) & ((1 << 64) - 1)


def _check_out(out: torch.Tensor, dtype: torch.dtype, numel: int) -> None:
    if out.numel() != numel:
        raise ValueError(f"out.numel()={out.numel()} != numel={numel}")
    if out.dtype != dtype:
        raise ValueError(f"reduce_op='add' adds into out in place: out must "
                         f"be {dtype}, got {out.dtype}")


# ---------------------------------------------------------------------------
# flat functional API
# ---------------------------------------------------------------------------

def quantize(x: torch.Tensor, scale: Scalar, zero_point: Scalar,
             dtype: Union[QDType, str], round_mode: Union[str, RoundMode] =
             "nearest", *, generator: Optional[torch.Generator] = None
             ) -> torch.Tensor:
    """Quantize a float tensor.  Sub-byte dtypes give a flat uint8 tensor of
    packed_numel(x.numel(), dtype) bytes in the wire layout; the others keep
    x's shape in the storage dtype."""
    _as_float_input(x)
    dt = dtype_of(dtype)
    if not dt.is_quant:
        raise ValueError(f"quantize target must be a quant dtype, got {dt.name}")
    rm = RoundMode(round_mode).value
    seed = _seed(rm, generator)
    out = _ops.quantize(x.reshape(-1), scale, zero_point, dt, rm, seed=seed)
    return out if dt.is_packed else out.reshape(x.shape)


def dequantize(q: torch.Tensor, scale: Scalar, zero_point: Scalar,
               dtype: Union[QDType, str], *,
               out_dtype: Union[QDType, str] = "f32",
               numel: Optional[int] = None,
               reduce_op: Union[str, ReduceOp] = "set",
               out: Optional[torch.Tensor] = None,
               shape: Optional[Tuple[int, ...]] = None) -> torch.Tensor:
    """Dequantize codes (or packed bytes) back to floats.  `dtype` is the
    QUANT dtype of `q`; `numel` the logical count for packed dtypes (default:
    all the buffer holds).  reduce_op='add' adds into `out` in place."""
    dt = dtype_of(dtype)
    if not dt.is_quant:
        raise ValueError(f"dequantize source must be a quant dtype, got {dt.name}")
    if q.dtype.is_floating_point or q.dtype.is_complex:
        raise ValueError(f"dequantize input must hold integer codes, got "
                         f"{q.dtype}")
    odt = dtype_of(out_dtype)
    if not odt.is_float:
        raise ValueError(f"dequantize output must be a float dtype, got "
                         f"{odt.name}")
    op = ReduceOp(reduce_op).value
    if numel is None:
        numel = out.numel() if out is not None else q.numel() * dt.pack_factor
    if packed_numel(numel, dt) != q.numel():
        raise ValueError(
            f"packed buffer has {q.numel()} storage elements but numel={numel}"
            f" {dt.name} codes need exactly {packed_numel(numel, dt)}")
    if op == "add":
        if out is None:
            raise ValueError("reduce_op='add' requires out=<accumulator>")
        _check_out(out, odt.storage, numel)
    res = _ops.dequantize(q.reshape(-1), numel, scale, zero_point, dt, odt,
                          op, out)
    if op == "add":
        return out.reshape(shape) if shape is not None else out
    if shape is not None:
        return res.reshape(shape)
    return res.reshape(out.shape) if out is not None else res


def requantize(x: torch.Tensor, scale: Scalar, zero_point: Scalar,
               dtype: Union[QDType, str],
               round_mode: Union[str, RoundMode] = "nearest", *,
               reduce_op: Union[str, ReduceOp] = "set",
               out: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Fused quantize -> dequantize (fake-quant), shape-preserving."""
    _as_float_input(x)
    dt = dtype_of(dtype)
    if not dt.is_quant:
        raise ValueError(f"requantize target must be a quant dtype, got "
                         f"{dt.name}")
    rm = RoundMode(round_mode).value
    op = ReduceOp(reduce_op).value
    if rm == "stochastic" and generator is None:
        raise ValueError("stochastic rounding requires "
                         "generator=torch.Generator(...)")
    if op == "add" and out is None:
        raise ValueError("reduce_op='add' requires out=<accumulator>")
    if out is not None:
        if out.numel() != x.numel():
            raise ValueError("requantize requires out.numel() == x.numel()")
        if op == "add":
            _check_out(out, x.dtype, x.numel())
    seed = _seed(rm, generator)
    res = _ops.requantize(x.reshape(-1), scale, zero_point, dt, rm, op,
                          out if op == "add" else None, seed=seed)
    return out if op == "add" else res.reshape(x.shape)


quantize_dequantize_fused = requantize


def compute_quant_params(x: torch.Tensor, dtype: Union[QDType, str]
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scale, zero_point) from the data's min and max for an affine mapping:
    0-d tensors (f32, int32) on x's device, with no host sync."""
    _as_float_input(x)
    dt = dtype_of(dtype)
    if not dt.is_quant:
        raise ValueError(f"target must be a quant dtype, got {dt.name}")
    return _ops.compute_quant_params(x.reshape(-1), dt)


# ---------------------------------------------------------------------------
# QuantizedTensor
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class QuantizedTensor:
    """A packed quantized tensor with its affine parameters: `data` is the
    flat storage buffer, `shape` the logical shape."""

    data: torch.Tensor
    scale: torch.Tensor
    zero_point: torch.Tensor
    qdtype: str
    shape: Tuple[int, ...]

    @property
    def dtype_info(self) -> QDType:
        return dtype_of(self.qdtype)

    @property
    def numel(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    def dequantize(self, out_dtype: Union[QDType, str] = "f32", *,
                   reduce_op: Union[str, ReduceOp] = "set",
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
        res = dequantize(self.data, self.scale, self.zero_point, self.qdtype,
                         out_dtype=out_dtype, numel=self.numel,
                         reduce_op=reduce_op, out=out)
        return res.reshape(self.shape)


def quantize_tensor(x: torch.Tensor, dtype: Union[QDType, str],
                    round_mode: Union[str, RoundMode] = "nearest", *,
                    scale: Optional[Scalar] = None,
                    zero_point: Optional[Scalar] = None,
                    generator: Optional[torch.Generator] = None
                    ) -> QuantizedTensor:
    """One call: derive the parameters (unless given) and pack."""
    dt = dtype_of(dtype)
    if scale is None or zero_point is None:
        scale, zero_point = compute_quant_params(x, dt)
    data = quantize(x, scale, zero_point, dt, round_mode, generator=generator)
    return QuantizedTensor(
        data=data.reshape(-1),
        scale=torch.as_tensor(scale, dtype=torch.float32, device=x.device),
        zero_point=torch.as_tensor(zero_point, dtype=torch.int32,
                                   device=x.device),
        qdtype=dt.name, shape=tuple(x.shape))


def dequantize_tensor(qt: QuantizedTensor,
                      out_dtype: Union[QDType, str] = "f32") -> torch.Tensor:
    return qt.dequantize(out_dtype)


# ---------------------------------------------------------------------------
# Context shim
# ---------------------------------------------------------------------------

class Context:
    """Drop-in analogue of the reference's `piquant.Context`: there is no
    thread pool to configure (the constructor argument is accepted and
    ignored); the methods forward to the functional API."""

    _singleton: Optional["Context"] = None

    def __init__(self, num_threads: Optional[int] = None) -> None:
        del num_threads

    @classmethod
    def get(cls) -> "Context":
        if cls._singleton is None:
            cls._singleton = cls()
        return cls._singleton

    quantize = staticmethod(quantize)
    dequantize = staticmethod(dequantize)
    quantize_dequantize_fused = staticmethod(requantize)
    compute_quant_params = staticmethod(compute_quant_params)
    compute_quant_config_from_data = staticmethod(compute_quant_params)
