"""Reference rounding helpers (counterpart of piquant_tpu/ops/reference.py).

Only what the serving slice needs is ported so far.
"""

from __future__ import annotations

import torch


def round_half_away(x: torch.Tensor) -> torch.Tensor:
    """Round half away from zero (ties outward), matching C std::round.

    `torch.round` rounds half to even (0.5 -> 0, 2.5 -> 2), so it is not
    this function.  The formula is the reference's, op for op, so the f32
    result is bit-identical (including its ulp behaviour just below .5)."""
    half = torch.where(x >= 0, 0.5, -0.5).to(x.dtype)
    return torch.trunc(x + half)
