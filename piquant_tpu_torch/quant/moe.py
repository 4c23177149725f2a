"""Grouped (megablocks-style) MoE routing for the ragged quantized GEMMs:
the counterpart of piquant_tpu/quant/moe.py.

The A = n_tokens * top_k (token, expert) assignments are sorted by expert
(a stable argsort), and each expert's run is padded to whole `bm`-row
blocks, so every row block of the sorted buffer belongs to exactly one
expert; `block_expert` names it.  The padded row count
    m_pad = ceil((A + E (bm - 1)) / bm) * bm
depends only on the shapes, so nothing here reads a value back to the
host: on the card this is plain torch glue, as it is jnp glue in the
reference.  `live_blocks`, the padded rows' end p_end[-1] over bm, stays
on the device too: the ragged kernels write the blocks past it as zeros
without computing them (the reference's grid covers all m_pad / bm).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class RaggedRouting(NamedTuple):
    dest: torch.Tensor          # [A] row of each sorted assignment in the buffer
    token_idx: torch.Tensor     # [A] source token of each sorted assignment
    gate: torch.Tensor          # [A] routing weight of each sorted assignment
    block_expert: torch.Tensor  # [m_pad // bm] int32 expert of each row block
    m_pad: int                  # padded row count (from the shapes alone)
    live_blocks: torch.Tensor   # [1] int32: row blocks before the padding tail


def build_ragged_routing(topi: torch.Tensor, probs: torch.Tensor,
                         n_experts: int, bm: int) -> RaggedRouting:
    """topi / probs [..., top_k] -> the sorted, padded assignment routing."""
    dev = topi.device
    flat_e = topi.reshape(-1).long()
    a = flat_e.numel()
    k = topi.shape[-1]
    e = n_experts

    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = torch.bincount(flat_e, minlength=e)
    padded = (counts + bm - 1) // bm * bm
    p_end = torch.cumsum(padded, 0)
    p_off = p_end - padded                       # first row of each expert
    s_off = torch.cumsum(counts, 0) - counts
    rank = torch.arange(a, device=dev) - s_off[sorted_e]
    dest = p_off[sorted_e] + rank

    m_pad = ((a + e * (bm - 1)) + bm - 1) // bm * bm
    starts = torch.arange(m_pad // bm, device=dev) * bm
    block_expert = torch.clamp(
        torch.searchsorted(p_end, starts, right=True), max=e - 1)
    return RaggedRouting(dest=dest, token_idx=order // k,
                         gate=probs.reshape(-1)[order],
                         block_expert=block_expert.to(torch.int32),
                         m_pad=m_pad,
                         live_blocks=(p_end[-1:] // bm).to(torch.int32))


def scatter_tokens(x_flat: torch.Tensor, r: RaggedRouting) -> torch.Tensor:
    """Token activations [N_tok, D] -> the padded sorted buffer [m_pad, D]
    (padding rows stay zero; their GEMM outputs are never gathered)."""
    out = torch.zeros((r.m_pad, x_flat.shape[-1]), dtype=x_flat.dtype,
                      device=x_flat.device)
    out[r.dest] = x_flat[r.token_idx]
    return out


def combine_tokens(y_sorted: torch.Tensor, r: RaggedRouting,
                   n_tokens: int) -> torch.Tensor:
    """Padded sorted outputs [m_pad, D] -> the gate-weighted sum per token
    [N_tok, D] in f32, added in the sorted order (with top_k = 2 a token's
    two rows meet in one addition, so the order of the adds cannot change
    a bit)."""
    rows = y_sorted[r.dest].float() * r.gate[:, None].float()
    out = torch.zeros((n_tokens, y_sorted.shape[-1]), dtype=torch.float32,
                      device=y_sorted.device)
    return out.index_add_(0, r.token_idx, rows)
