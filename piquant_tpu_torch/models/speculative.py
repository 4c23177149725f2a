"""Speculative decoding (counterpart of piquant_tpu/models/speculative.py).

Greedy decode emits one token per model call; with speculation the model
verifies G drafted continuation tokens in one T = G + 1 forward against
the cache, emitting 1..G+1 tokens per call.  Drafts come from PROMPT
LOOKUP (the latest earlier occurrence of the current bigram in the token
history predicts the continuation) or from a DRAFT MODEL (G greedy or
sampled decode steps of a smaller model, accepted greedily or by rejection
sampling).  A block of `n_steps` verify steps is a Python loop of device
work: nothing in it reads a tensor back to the host, so the engine reads a
block's tokens in one copy, as it reads a plain decode block's.

Correctness invariant (tested): greedy speculative output is the output of
greedy decoding.  Rejected drafts leave K/V in the cache (and `length`
counts them) and entries in the history, all at positions beyond the new
position: attention masks them until the true tokens overwrite them.  The
identity is exact when the T = 1 decode and the T = G + 1 verify reduce
in the same order; on the card the GEMV's K split follows the row count
and decode folds the current token in from registers while the verify
appends first, so a near-tied argmax may fork (the reference's caveat,
`piquant_tpu/models/speculative.py:18-23`).

Randomness comes from an explicit `torch.Generator` (the acceptance test's
u, the Gumbel-max draws of `serving/sampler.py`, the draft's samples) in
place of the reference's keys: the same distributions, other bits.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from piquant_tpu_torch.models import llama as M
from piquant_tpu_torch.models import model_for
from piquant_tpu_torch.quant.kv_cache import KVCache
from piquant_tpu_torch.serving.sampler import _categorical

__all__ = ["ngram_draft", "spec_block", "draft_spec_block",
           "rejection_sample_step", "draft_spec_block_sample"]


def _verify_forward(cfg, params: Dict, tokens: torch.Tensor,
                    positions: torch.Tensor, cache):
    """The T = G + 1 verify forward against the cache -> (logits [B, T, V]
    f32, cache): materialized attention over the cache after each layer's
    scattered append, or for an MLA config `mla.forward_verify` (the
    absorbed path over the latent cache)."""
    model = model_for(cfg)
    if model is M:
        return M.forward(cfg, params, tokens, positions=positions,
                         cache=cache)
    return model.forward_verify(cfg, params, tokens, positions, cache)


def ngram_draft(hist: torch.Tensor, pos: torch.Tensor, G: int
                ) -> torch.Tensor:
    """Draft G tokens a row by bigram prompt lookup.

    hist [B, S] int32: entries at indices <= pos are valid and hist[b,
    pos[b]] is the current (already emitted) token.  Returns drafts [B, G]
    int32: the G entries after the latest earlier occurrence of the bigram
    (hist[pos - 1], hist[pos]), zeros where there is none (the verify then
    rejects them)."""
    s = hist.shape[1]
    dev = hist.device
    j = torch.arange(s, device=dev)[None, :]             # candidate end index
    p = pos.long()[:, None]
    a_tok = torch.gather(hist, 1, torch.clamp(p - 1, min=0))
    b_tok = torch.gather(hist, 1, p)
    prev = torch.cat([hist[:, :1], hist[:, :-1]], dim=1)  # hist[j - 1]
    match = (j >= 1) & (j < p) & (prev == a_tok) & (hist == b_tok)
    idx = torch.where(match, j, -1).amax(dim=1)          # latest; -1: none
    found = idx >= 0
    base = torch.where(found, idx + 1, 0)
    at = torch.clamp(base[:, None] + torch.arange(G, device=dev)[None, :],
                     0, s - 1)
    drafts = torch.gather(hist, 1, at)
    return torch.where(found[:, None], drafts, torch.zeros_like(drafts))


def _greedy_logprobs(logits: torch.Tensor):
    """[B, T, V] logits -> (argmax [B, T] int32, its log-prob under the raw
    f32 logits [B, T])."""
    lf = logits.float()
    greedy = lf.argmax(dim=-1)
    lp = (torch.gather(lf, -1, greedy[..., None])[..., 0]
          - torch.logsumexp(lf, dim=-1))
    return greedy.to(torch.int32), lp


def _n_accepted(ok: torch.Tensor) -> torch.Tensor:
    """[B, G] bool -> the length of each row's all-true prefix, int32."""
    return torch.cumprod(ok.to(torch.int32), dim=1).sum(
        dim=1, dtype=torch.int32)


def _stacked(emits, lps, counts):
    return torch.stack(emits), torch.stack(lps), torch.stack(counts)


def spec_block(cfg, params: Dict, tok: torch.Tensor, pos: torch.Tensor,
               cache: KVCache, hist: torch.Tensor, active: torch.Tensor,
               n_steps: int, G: int) -> Tuple:
    """`n_steps` prompt-lookup verify steps.  tok [B] int32 is the current
    (already emitted) token at position pos [B]; the cache and the history
    hist [B, S] are updated in place.

    Returns (emit_hist [K, B, G+1], emit_lp [K, B, G+1] (raw-model
    log-probs of the emitted tokens), n_emit [K, B], tok, pos, hist,
    cache): step k emitted emit_hist[k, b, :n_emit[k, b]]."""
    b = tok.shape[0]
    dev = tok.device
    rows = torch.arange(b, device=dev)
    garange = torch.arange(G + 1, dtype=torch.int32, device=dev)
    emits, lps, counts = [], [], []
    for _ in range(n_steps):
        drafts = ngram_draft(hist, pos, G)
        tokens_in = torch.cat([tok[:, None], drafts], dim=1)
        positions = pos[:, None] + garange[None, :]
        logits, cache = _verify_forward(cfg, params, tokens_in, positions,
                                        cache)
        greedy, lp = _greedy_logprobs(logits)
        n_acc = _n_accepted(drafts == greedy[:, :-1])
        # the emitted tokens are the greedy prefix [: n_acc + 1]
        n_emit = torch.where(active, n_acc + 1, 0)
        next_tok = greedy[rows, n_acc]
        new_pos = pos + n_emit
        # the history: the verified inputs, then the correction token (the
        # rejected tail lies beyond new_pos: ignored, later overwritten)
        at = (rows[:, None], positions.long())
        hist[at] = torch.where(active[:, None], tokens_in, hist[at])
        upd = torch.where(active, new_pos, pos).long()
        hist[rows, upd] = torch.where(active, next_tok,
                                      hist[rows, pos.long()])
        tok = torch.where(active, next_tok, tok)
        pos = torch.where(active, new_pos, pos)
        emits.append(greedy)
        lps.append(lp)
        counts.append(n_emit)
    return (*_stacked(emits, lps, counts), tok, pos, hist, cache)


def _draft_round(dcfg, dparams: Dict, tok: torch.Tensor, pos: torch.Tensor,
                 dcache: KVCache, G: int, pick):
    """G draft-model decode steps from tok at pos, each next token
    `pick(f32 logits [B, V])`, then one more step that only writes the last
    draft's K/V at pos + G (its logits unused): when the target accepts all
    G, the next round starts past that position, and the draft must not
    attend to a position it never wrote.  Returns (drafts [B, G] int32,
    the picks, dcache)."""
    step = model_for(dcfg).decode_step
    t, p, drafts, picks = tok, pos, [], []
    for i in range(G + 1):
        dlogits, dcache = step(dcfg, dparams, t, p, dcache)
        if i == G:
            break
        t, extra = pick(dlogits.float())
        p = p + 1
        drafts.append(t)
        picks.append(extra)
    return torch.stack(drafts, dim=1), picks, dcache


def draft_spec_block(cfg, params: Dict, dcfg, dparams: Dict,
                     tok: torch.Tensor, pos: torch.Tensor, cache: KVCache,
                     dcache: KVCache, active: torch.Tensor, n_steps: int,
                     G: int) -> Tuple:
    """Draft-MODEL speculation: G greedy decode steps of the draft model
    propose the continuation, the target verifies them in one T = G + 1
    forward (greedy-exact).  Drafting writes the draft cache at [pos, pos +
    G] (`_draft_round`); the next round feeds the correction token at the
    first rejected position, overwriting it before anything attends to it.

    Returns (emit_hist [K, B, G+1], emit_lp, n_emit [K, B], tok, pos,
    cache, dcache)."""
    b = tok.shape[0]
    dev = tok.device
    rows = torch.arange(b, device=dev)
    garange = torch.arange(G + 1, dtype=torch.int32, device=dev)
    emits, lps, counts = [], [], []
    for _ in range(n_steps):
        drafts, _, dcache = _draft_round(
            dcfg, dparams, tok, pos, dcache, G,
            lambda lf: (lf.argmax(dim=-1).to(torch.int32), None))
        tokens_in = torch.cat([tok[:, None], drafts], dim=1)
        positions = pos[:, None] + garange[None, :]
        logits, cache = _verify_forward(cfg, params, tokens_in, positions,
                                        cache)
        greedy, lp = _greedy_logprobs(logits)
        n_acc = _n_accepted(drafts == greedy[:, :-1])
        n_emit = torch.where(active, n_acc + 1, 0)
        tok = torch.where(active, greedy[rows, n_acc], tok)
        pos = torch.where(active, pos + n_emit, pos)
        emits.append(greedy)
        lps.append(lp)
        counts.append(n_emit)
    return (*_stacked(emits, lps, counts), tok, pos, cache, dcache)


def rejection_sample_step(p: torch.Tensor, q: torch.Tensor,
                          drafts: torch.Tensor, generator: torch.Generator):
    """One round of speculative rejection sampling (Leviathan et al. 2023;
    Chen et al. 2023) over the batch.

    p [B, G+1, V]: target probabilities at the G + 1 verified positions;
    q [B, G, V]: the draft probabilities the G `drafts` [B, G] were drawn
    from.  Draft i is accepted with probability min(1, p_i(d_i) / q_i(d_i));
    at the first rejection the correction token is drawn from norm(max(p_i
    - q_i, 0)), and when all G are accepted a bonus token from p_G.  Every
    emitted token is then distributed as the target samples it.

    Returns (n_acc [B] int32, next_tok [B] int32): the emitted tokens are
    drafts[:n_acc], then next_tok."""
    b, g, _ = q.shape
    rows = torch.arange(b, device=q.device)
    u = torch.rand((b, g), generator=generator, device=q.device,
                   dtype=torch.float32)
    d = drafts.long()[..., None]
    p_d = torch.gather(p[:, :g], -1, d)[..., 0]
    q_d = torch.gather(q, -1, d)[..., 0]
    n_acc = _n_accepted(u * torch.clamp(q_d, min=1e-20) < p_d)
    na = n_acc.long()
    # the correction distribution at the first rejected position; the
    # bonus draws from p_G
    p_j = p[rows, na]
    q_j = torch.where((na < g)[:, None], q[rows, torch.clamp(na, max=g - 1)],
                      0.0)
    resid = torch.clamp(p_j - q_j, min=0.0)
    rs = resid.sum(dim=-1, keepdim=True)
    # a degenerate residual (p <= q everywhere up to rounding) falls back to
    # the target distribution, exact in the limit rs -> 0
    dist = torch.where(rs > 1e-12, resid / torch.clamp(rs, min=1e-20), p_j)
    next_tok = _categorical(torch.log(torch.clamp(dist, min=1e-30)),
                            generator)
    return n_acc, next_tok.to(torch.int32)


def draft_spec_block_sample(cfg, params: Dict, dcfg, dparams: Dict,
                            tok: torch.Tensor, pos: torch.Tensor,
                            cache: KVCache, dcache: KVCache,
                            temps: torch.Tensor, generator: torch.Generator,
                            active: torch.Tensor, n_steps: int,
                            G: int) -> Tuple:
    """Stochastic two-model speculation: drafts SAMPLED from the draft
    model at each row's temperature (temps [B] > 0, pure temperature rows
    only), accepted by `rejection_sample_step`, so the emitted stream is
    distributed as plain temperature sampling from the target.  The draws
    come from `generator`.  Same return contract as draft_spec_block."""
    b = tok.shape[0]
    dev = tok.device
    garange = torch.arange(G + 1, dtype=torch.int32, device=dev)
    t_inv = 1.0 / torch.clamp(temps.float(), min=1e-6)

    def pick(lf):
        dl = lf * t_inv[:, None]
        return (_categorical(dl, generator).to(torch.int32),
                torch.softmax(dl, dim=-1))

    emits, lps, counts = [], [], []
    for _ in range(n_steps):
        drafts, qs, dcache = _draft_round(dcfg, dparams, tok, pos, dcache, G,
                                          pick)
        q = torch.stack(qs, dim=1)                       # [B, G, V]
        tokens_in = torch.cat([tok[:, None], drafts], dim=1)
        positions = pos[:, None] + garange[None, :]
        logits, cache = _verify_forward(cfg, params, tokens_in, positions,
                                        cache)
        lf = logits.float()
        probs = torch.softmax(lf * t_inv[:, None, None], dim=-1)
        n_acc, next_tok = rejection_sample_step(probs, q, drafts, generator)
        # the emitted tokens: drafts[:n_acc], then next_tok at slot n_acc
        emitted = torch.cat([drafts, next_tok[:, None]], dim=1)
        emitted = torch.where(garange[None, :] == n_acc[:, None],
                              next_tok[:, None], emitted)
        lp = (torch.gather(lf, -1, emitted.long()[..., None])[..., 0]
              - torch.logsumexp(lf, dim=-1))
        n_emit = torch.where(active, n_acc + 1, 0)
        tok = torch.where(active, next_tok, tok)
        pos = torch.where(active, pos + n_emit, pos)
        emits.append(emitted)
        lps.append(lp)
        counts.append(n_emit)
    return (*_stacked(emits, lps, counts), tok, pos, cache, dcache)
