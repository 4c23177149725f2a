"""Token sampling: greedy / temperature / top-k / top-p / min-p
(counterpart of piquant_tpu/serving/sampler.py).

Random draws come from an explicit `torch.Generator` and use the Gumbel-max
form of a categorical draw, as `jax.random.categorical` does; the bits
differ from JAX's, so tests compare keep-masks exactly and draws by
frequency.  Repetition / frequency / presence penalties are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0   # 0 => greedy
    top_k: int = 0             # 0 => disabled
    top_p: float = 1.0         # 1 => disabled
    min_p: float = 0.0         # 0 => disabled; keep p >= min_p * p_max
    repetition_penalty: float = 1.0  # penalties: not ported (must stay off)
    frequency_penalty: float = 0.0
    presence_penalty: float = 0.0
    logit_bias: tuple = ()
    max_new_tokens: int = 128
    min_new_tokens: int = 0
    eos_token: int = -1        # -1 => never stops on EOS
    stop_tokens: tuple = ()    # additional stop ids
    stop_sequences: tuple = ()  # multi-token stop suffixes (trimmed)


TOPK_CAND = 128  # top-k/top-p candidate window (see sample_batch)


def _categorical(logits: torch.Tensor, gen: Optional[torch.Generator]
                 ) -> torch.Tensor:
    """Gumbel-max draw over the last axis of f32 logits (-inf never wins)."""
    u = torch.rand(logits.shape, generator=gen, device=logits.device,
                   dtype=torch.float32)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def sample(logits: torch.Tensor, params: SamplingParams,
           gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """logits [B, V] -> tokens [B] int32 for one SamplingParams."""
    if params.repetition_penalty != 1.0:
        raise NotImplementedError("repetition_penalty is not ported yet")
    if params.temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    l = logits.float() / params.temperature
    if params.min_p > 0.0:
        thresh = (l.amax(dim=-1, keepdim=True)
                  + torch.log(torch.tensor(max(params.min_p, 1e-10))))
        l = torch.where(l < thresh, -torch.inf, l)
    if params.top_k > 0:
        kth = torch.sort(l, dim=-1).values[:, -params.top_k][:, None]
        l = torch.where(l < kth, -torch.inf, l)
    if params.top_p < 1.0:
        sorted_l = torch.sort(l, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_l, dim=-1), dim=-1)
        # smallest prefix with cumulative mass >= top_p
        cutoff_idx = torch.argmax((cum >= params.top_p).to(torch.int8), dim=-1)
        cutoff = torch.gather(sorted_l, -1, cutoff_idx[:, None])
        l = torch.where(l < cutoff, -torch.inf, l)
    return _categorical(l, gen).to(torch.int32)


def batch_keep_mask(lt: torch.Tensor, top_k: torch.Tensor,
                    top_p: torch.Tensor,
                    min_p: Optional[torch.Tensor] = None):
    """Candidate window of temperature-scaled logits `lt` [B, V]:
    (cand [B, c] descending, cand_idx [B, c], keep [B, c], restricted [B]).
    top-k is exact for k <= TOPK_CAND; the top-p nucleus is truncated at
    TOPK_CAND candidates (the reference's serving behaviour)."""
    c = min(TOPK_CAND, lt.shape[-1])
    cand, cand_idx = torch.topk(lt, c, dim=-1)            # descending
    eff_k = torch.clamp(torch.where(top_k > 0, top_k, c), 1, c)
    pos = torch.arange(c, device=lt.device)[None, :]
    keep = pos < eff_k[:, None]
    probs = torch.softmax(torch.where(keep, cand, -torch.inf), dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    nucleus = (cum - probs) < top_p[:, None]              # mass before < p
    keep = keep & (nucleus | (top_p >= 1.0)[:, None])
    restricted = (top_k > 0) | (top_p < 1.0)
    if min_p is not None:
        thresh = cand[:, :1] + torch.log(torch.clamp(min_p, min=1e-10))[:, None]
        keep = keep & ((cand >= thresh) | (min_p <= 0.0)[:, None])
        restricted = restricted | (min_p > 0.0)
    return cand, cand_idx, keep, restricted


def sample_batch(logits: torch.Tensor, temperature: torch.Tensor,
                 top_k: torch.Tensor, top_p: torch.Tensor,
                 gen: Optional[torch.Generator] = None,
                 min_p: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-row sampling params as tensors (the engine samples every slot
    in one call).  Greedy rows take the exact argmax, pure-temperature rows
    an exact full-vocab draw, restricted rows a draw inside the top
    TOPK_CAND window."""
    l = logits.float()
    greedy = temperature <= 0.0
    lt = l / torch.clamp(temperature, min=1e-6)[:, None]
    full_draw = _categorical(lt, gen)
    arg = torch.argmax(l, dim=-1)
    cand, cand_idx, keep, restricted = batch_keep_mask(lt, top_k, top_p,
                                                       min_p)
    draw_c = _categorical(torch.where(keep, cand, -torch.inf), gen)
    windowed = torch.gather(cand_idx, -1, draw_c[:, None])[:, 0]
    out = torch.where(restricted, windowed, full_draw)
    return torch.where(greedy, arg, out).to(torch.int32)
