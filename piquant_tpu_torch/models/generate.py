"""Generation outside the serving engine: beam search (counterpart of
piquant_tpu/models/generate.py).

The engine's continuous-batching loop only samples; beam search is the
offline counterpart: keep `n_beams` hypotheses and expand the best
`score + log p(token)` candidates each step.  All beams ride ONE
[n_beams] decode batch (the engine's `decode_step`, the cache's batch axis
the beams), and reordering the beams gathers the cache along its batch
axis once a step.  Scoring and bookkeeping run on the host each step: an
offline utility, not the serving hot path.

GNMT length penalty: finished hypotheses rank by
`logprob / ((5 + len) / 6) ** alpha`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from piquant_tpu_torch._device import DeviceLike, resolve_device
from piquant_tpu_torch.models import llama as M
from piquant_tpu_torch.quant.kv_cache import KVCache

__all__ = ["beam_search", "BeamHypothesis"]


@dataclasses.dataclass
class BeamHypothesis:
    tokens: List[int]          # generated tokens (no prompt, no EOS)
    logprob: float             # sum of token logprobs (incl. EOS if hit)
    score: float               # length-penalized ranking score


def _gather_batch(cache: KVCache, idx: torch.Tensor) -> KVCache:
    """Reorder every cache leaf's batch axis (axis 1) by `idx`."""
    return KVCache(*(t[:, idx] for t in cache.tensors()))


def _log_softmax(logits: torch.Tensor) -> np.ndarray:
    return torch.log_softmax(logits.float(), -1).cpu().numpy()


def beam_search(cfg: M.LlamaConfig, params: Dict, prompt: Sequence[int], *,
                n_beams: int = 4, max_new_tokens: int = 64,
                eos_token: int = -1, length_penalty: float = 0.0,
                max_len: Optional[int] = None, device: DeviceLike = None,
                ) -> List[BeamHypothesis]:
    """Beam-search completion of `prompt`; returns hypotheses sorted by
    score (best first).  n_beams=1 reproduces greedy decoding exactly.
    Runs on the card unless `device` says otherwise; `params` must live
    there."""
    if not prompt:
        raise ValueError("prompt must be non-empty")
    dev = resolve_device(device)
    if params["embed"].device != dev:
        raise ValueError(f"params live on {params['embed'].device}, the "
                         f"search on {dev}")
    nb = n_beams
    plen = len(prompt)
    max_len = max_len or min(cfg.max_seq_len, plen + max_new_tokens)
    if plen + max_new_tokens > max_len:
        raise ValueError(f"prompt {plen} + max_new {max_new_tokens} "
                         f"exceeds max_len {max_len}")
    cache = M.init_kv_cache(cfg, nb, max_len=max_len, device=dev)
    rows = torch.tensor([list(prompt)] * nb, dtype=torch.int32, device=dev)
    logits, cache = M.prefill(cfg, params, rows, cache)

    def lpnorm(length: int) -> float:
        return ((5.0 + length) / 6.0) ** length_penalty

    lp0 = _log_softmax(logits)[0]
    order = np.argsort(-lp0)[:nb]
    scores = lp0[order].astype(np.float64)    # [nb] running logprobs
    beams: List[List[int]] = [[int(t)] for t in order]
    tok = torch.tensor([int(t) for t in order], dtype=torch.int32, device=dev)
    pos = torch.full((nb,), plen, dtype=torch.int32, device=dev)
    finished: List[BeamHypothesis] = []
    alive = np.ones((nb,), bool)

    for i, t in enumerate(order):           # first token may already be EOS
        if eos_token >= 0 and int(t) == eos_token:
            finished.append(BeamHypothesis([], scores[i],
                                           scores[i] / lpnorm(1)))
            scores[i] = -np.inf
            alive[i] = False

    for step in range(1, max_new_tokens):
        if not alive.any():
            break
        logits, cache = M.decode_step(cfg, params, tok, pos, cache)
        lp = _log_softmax(logits)
        cand = scores[:, None] + lp          # dead rows are -inf
        flat = cand.reshape(-1)
        # top nb continuations + up to nb EOS finalizations per step
        top = np.argpartition(-flat, min(2 * nb, flat.size - 1))[:2 * nb]
        top = top[np.argsort(-flat[top])]
        new_beams, new_scores, src, toks = [], [], [], []
        for c in top:
            b, t = divmod(int(c), lp.shape[1])
            if not np.isfinite(flat[c]):
                continue
            if eos_token >= 0 and t == eos_token:
                finished.append(BeamHypothesis(
                    list(beams[b]), float(flat[c]),
                    float(flat[c]) / lpnorm(step + 1)))
                continue
            if len(new_beams) < nb:
                new_beams.append(beams[b] + [t])
                new_scores.append(float(flat[c]))
                src.append(b)
                toks.append(t)
        if not new_beams:
            break
        # early stop: the best alive score cannot beat the worst kept
        # finished score once there are nb finished (the standard rule)
        if len(finished) >= nb:
            best_alive = max(new_scores) / lpnorm(plen + max_new_tokens)
            worst_kept = sorted((h.score for h in finished),
                                reverse=True)[nb - 1]
            if best_alive < worst_kept:
                break
        while len(new_beams) < nb:           # pad with a dead copy of row 0
            new_beams.append(new_beams[0])
            new_scores.append(-np.inf)
            src.append(src[0])
            toks.append(toks[0])
        beams = new_beams
        scores = np.asarray(new_scores, np.float64)
        alive = np.isfinite(scores)
        cache = _gather_batch(cache, torch.tensor(src, device=dev))
        tok = torch.tensor(toks, dtype=torch.int32, device=dev)
        pos = pos + 1

    for i in range(nb):                      # finalize still-alive beams
        if alive[i]:
            finished.append(BeamHypothesis(
                list(beams[i]), float(scores[i]),
                float(scores[i]) / lpnorm(len(beams[i]))))
    finished.sort(key=lambda h: -h.score)
    return finished[:nb]
