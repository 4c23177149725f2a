"""Dtype registry and packed sub-byte layout (counterpart of
piquant_tpu/dtypes.py, with torch storage and compute dtypes).

The registry is the JAX package's, entry for entry: the same names, bit
widths, kinds, code ranges and packing.  Wire ABI (byte-identical to the
reference, so a buffer packed by one package reads in the other):
  * uint4 / int4: two codes per byte, the FIRST element in the LOW nibble;
  * uint2: four codes per byte, LSB-first;
  * unused tail bits of the final byte are zero.

Compute dtypes are int32 for codes of <= 16 bits and int64 above, as in the
reference, except uint64: torch has no arithmetic on uint64, so its codes
compute in int64.  That loses nothing, because uint64 codes are capped at
int64 max (`qmax`) and the zero-point difference is taken with two's-
complement wraparound, which has the same bits in both types.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = [
    "QDType", "DTYPES", "dtype_of", "packed_numel", "tail_mask",
    "f32", "f64", "bf16",
    "uint2", "uint4", "uint8", "uint16", "uint32", "uint64",
    "int4", "int8", "int16", "int32", "int64",
    "FLOAT_DTYPES", "QUANT_DTYPES",
]


@dataclasses.dataclass(frozen=True)
class QDType:
    """One entry of the dtype registry: bit size, kind, and the torch dtypes
    used for storage and for arithmetic."""

    name: str
    bits: int                  # logical bits per element
    kind: str                  # 'float' | 'uint' | 'int'
    storage: torch.dtype       # in-memory carrier (uint8 for packed types)
    compute: torch.dtype       # dtype of arithmetic on codes / values

    @property
    def is_float(self) -> bool:
        return self.kind == "float"

    @property
    def is_quant(self) -> bool:
        return self.kind in ("uint", "int")

    @property
    def is_signed(self) -> bool:
        return self.kind in ("int", "float")

    @property
    def is_packed(self) -> bool:
        """True for sub-byte types stored several codes per byte."""
        return self.is_quant and self.bits < 8

    @property
    def pack_factor(self) -> int:
        """Number of codes per storage byte (1 for unpacked types)."""
        return 8 // self.bits if self.is_packed else 1

    @property
    def qmin(self) -> int:
        if not self.is_quant:
            raise ValueError(f"{self.name} is not a quantized dtype")
        return -(1 << (self.bits - 1)) if self.kind == "int" else 0

    @property
    def qmax(self) -> int:
        if not self.is_quant:
            raise ValueError(f"{self.name} is not a quantized dtype")
        if self.kind == "int":
            return (1 << (self.bits - 1)) - 1
        if self.bits == 64:
            # capped at int64 max so code arithmetic stays exact in int64
            return (1 << 63) - 1
        return (1 << self.bits) - 1

    @property
    def stride(self) -> int:
        """Bytes per storage element (at least 1)."""
        return max(1, self.bits // 8)

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"QDType({self.name})"


f32 = QDType("f32", 32, "float", torch.float32, torch.float32)
f64 = QDType("f64", 64, "float", torch.float64, torch.float64)
bf16 = QDType("bf16", 16, "float", torch.bfloat16, torch.float32)

uint2 = QDType("uint2", 2, "uint", torch.uint8, torch.int32)
uint4 = QDType("uint4", 4, "uint", torch.uint8, torch.int32)
uint8 = QDType("uint8", 8, "uint", torch.uint8, torch.int32)
uint16 = QDType("uint16", 16, "uint", torch.uint16, torch.int32)
uint32 = QDType("uint32", 32, "uint", torch.uint32, torch.int64)
uint64 = QDType("uint64", 64, "uint", torch.uint64, torch.int64)
int4 = QDType("int4", 4, "int", torch.uint8, torch.int32)
int8 = QDType("int8", 8, "int", torch.int8, torch.int32)
int16 = QDType("int16", 16, "int", torch.int16, torch.int32)
int32 = QDType("int32", 32, "int", torch.int32, torch.int64)
int64 = QDType("int64", 64, "int", torch.int64, torch.int64)

DTYPES: dict[str, QDType] = {
    d.name: d
    for d in (f32, f64, bf16,
              uint2, uint4, uint8, uint16, uint32, uint64,
              int4, int8, int16, int32, int64)
}

FLOAT_DTYPES = (f32, f64, bf16)
QUANT_DTYPES = tuple(d for d in DTYPES.values() if d.is_quant)

_TORCH_TO_QDTYPE = {torch.float32: f32, torch.float64: f64,
                    torch.bfloat16: bf16}


def dtype_of(d) -> QDType:
    """Coerce a name / QDType / torch dtype to a registry entry."""
    if isinstance(d, QDType):
        return d
    if isinstance(d, str):
        try:
            return DTYPES[d]
        except KeyError:
            raise ValueError(f"unknown piquant dtype {d!r}; known: "
                             f"{sorted(DTYPES)}") from None
    if isinstance(d, torch.dtype):
        if d in _TORCH_TO_QDTYPE:
            return _TORCH_TO_QDTYPE[d]
        # plain integer torch dtypes share names with the quant entries
        name = str(d).removeprefix("torch.")
        if name in DTYPES:
            return DTYPES[name]
    raise ValueError(f"cannot map {d!r} to a piquant dtype")


def packed_numel(numel: int, dt: QDType) -> int:
    """Number of STORAGE elements needed for `numel` logical codes."""
    pf = dt.pack_factor
    return (numel + pf - 1) // pf


def tail_mask(numel: int, dt: QDType) -> Optional[int]:
    """Bit mask of the valid bits of a packed buffer's final byte, or None
    when the final byte is full (or the type is not packed)."""
    if not dt.is_packed:
        return None
    rem = numel % dt.pack_factor
    if rem == 0:
        return None
    return (1 << (rem * dt.bits)) - 1
