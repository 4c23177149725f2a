"""Continuous-batching inference engine (counterpart of
piquant_tpu/serving/engine.py).

A host scheduler drives slot-wise prefill admission and whole-batch decode
blocks over a fixed pool of batch slots backed by the stacked kv8 or kv4
cache of a Llama-family model, or the latent cache of an MLA model
(models/mla.py: its chunks take the absorbed path, `forward_chunk`).
Queued prompts of one pad bucket are admitted in ONE prefill call (bursts
truncated to a power of two, as in the reference), or, with
`prefill_chunk`, one prompt at a time in fixed-size chunks against a
one-slot cache (at most one chunk a tick while slots decode), seeded from
the prefix cache where a pooled prefix matches.  Decode runs in blocks of
`decode_block` steps whose [K, B] tokens come back to the host in one copy
per block, attending over the smallest `attn_windows` bucket that holds
every active context.  The loop is pipelined: block N is launched before
block N-1's tokens are read, so the readback overlaps device work; the
block in flight is the engine's (`_inflight`), so `snapshot` drains it.
With `track_history` every slot keeps its token history (prompt and
generated) on the device, [B, max_seq_len + 2] int32 updated in place each
step, and decode applies the repetition, frequency and presence
penalties, `logit_bias` and the `min_new_tokens` EOS floor before
sampling.

With `speculate` G > 0 a block whose live slots are all greedy (and
unpenalized) runs `decode_block` speculative verify steps instead
(models/speculative.py): drafts from prompt lookup over the token history
(kept for every slot, as with `track_history`), or from a draft model
(`draft=(dcfg, dparams)`, its own cache filled at admission), which with
pure-temperature slots samples its drafts and accepts them by rejection
sampling.  A block's emitted tokens and their counts come back in one
copy, as a plain block's do.

Not ported yet (raise NotImplementedError): guided decoding and LoRA
adapters.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import pickle
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional

import numpy as np
import torch

from piquant_tpu_torch._device import DeviceLike, resolve_device
from piquant_tpu_torch.models import llama as M
from piquant_tpu_torch.models import mla as ML
from piquant_tpu_torch.models import model_for
from piquant_tpu_torch.models import speculative as SP
from piquant_tpu_torch.quant.kv_cache import KVCache, kv_cache_copy_rows
from piquant_tpu_torch.serving.sampler import (TOPK_CAND, SamplingParams,
                                               apply_freq_presence,
                                               apply_repetition_penalty,
                                               sample_batch)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    batch_slots: int = 8
    max_seq_len: int = 2048
    prefill_pad: int = 64      # prompts are right-padded to a multiple of this
    decode_block: int = 16     # decode steps per block (one token readback)
    # speculative decoding: drafts verified a model call (0: off); greedy
    # ticks draft by prompt lookup, or with a draft model (Engine(draft=))
    speculate: int = 0
    # decode attends over the smallest bucket covering the longest active
    # context (an empty tuple: always max_seq_len)
    attn_windows: tuple = ()
    # accepted as the reference's option: eager PyTorch has no executable
    # to compile ahead for a bucket, so warming them does nothing here
    warmup_buckets: bool = True
    # a device-side token history (prompt + generated) for every slot:
    # needed by the penalties, min_new_tokens and logit_bias
    track_history: bool = False
    # prompts prefill in chunks of this many tokens against the cache
    prefill_chunk: Optional[int] = None
    # pinned KV prefixes (needs prefill_chunk); _auto captures every
    # admitted prompt's whole chunks, least recently used out first
    prefix_cache: int = 0
    prefix_cache_auto: bool = False


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    sampling: SamplingParams = SamplingParams()
    guide: Optional[object] = None   # guided decoding: not ported
    adapter_id: int = 0              # multi-LoRA: not ported
    # filled by the engine:
    tokens: List[int] = dataclasses.field(default_factory=list)
    logprobs: List[float] = dataclasses.field(default_factory=list)
    ttft_s: Optional[float] = None
    submitted_at: float = 0.0
    done: bool = False


@dataclasses.dataclass
class EngineMetrics:
    decode_tokens: int = 0
    decode_time_s: float = 0.0
    prefill_tokens: int = 0
    prefill_time_s: float = 0.0
    prefix_hits: int = 0
    prefix_tokens_saved: int = 0
    ttfts: List[float] = dataclasses.field(default_factory=list)

    @property
    def decode_tokens_per_s(self) -> float:
        return self.decode_tokens / self.decode_time_s if self.decode_time_s else 0.0

    def p50_ttft_ms(self) -> float:
        return float(np.median(self.ttfts) * 1e3) if self.ttfts else 0.0

    def p99_ttft_ms(self) -> float:
        return float(np.percentile(self.ttfts, 99) * 1e3) if self.ttfts else 0.0

    def to_dict(self) -> dict:
        """The reference's metrics line: rates and TTFTs rounded to two
        places."""
        return {
            "decode_tokens": self.decode_tokens,
            "decode_tokens_per_s": round(self.decode_tokens_per_s, 2),
            "prefill_tokens": self.prefill_tokens,
            "prefill_tokens_per_s": (
                round(self.prefill_tokens / self.prefill_time_s, 2)
                if self.prefill_time_s else 0.0),
            "p50_ttft_ms": round(self.p50_ttft_ms(), 2),
            "p99_ttft_ms": round(self.p99_ttft_ms(), 2),
            "requests": len(self.ttfts),
            "prefix_hits": self.prefix_hits,
            "prefix_tokens_saved": self.prefix_tokens_saved,
        }

    def emit(self, path: str) -> None:
        """Append one JSON line (a timestamp and `to_dict()`) to `path`."""
        with open(path, "a") as f:
            f.write(json.dumps({"ts": time.time(), **self.to_dict()}) + "\n")


def _copy_rows(dst, src, rows: torch.Tensor, n: Optional[int] = None):
    """Copy a one-request or burst cache's first `n` positions into the
    batch rows `rows` of the engine's cache, in place."""
    if isinstance(dst, KVCache):
        return kv_cache_copy_rows(dst, src, rows, n)
    return ML.copy_cache_rows(dst, src, rows, n)


def _burst_len(model, cfg, width: int) -> int:
    """The positions of a prefill burst's own cache: its padded width, for
    llama's kv4 cache the next even one (whole pair rows)."""
    return width + width % 2 if model is M and cfg.kv_bits == 4 else width


def _cache_like(cache, tensors):
    """A cache of `cache`'s type over `tensors` (its leaves, in order)."""
    return type(cache)(*tensors)


def _tok_logprob(logits: torch.Tensor, toks: torch.Tensor) -> torch.Tensor:
    """log p(tok) under the RAW model distribution ([B, V] f32 logits)."""
    lf = logits.float()
    chosen = torch.gather(lf, 1, toks[:, None].long())[:, 0]
    return chosen - torch.logsumexp(lf, dim=-1)


class Engine:
    def __init__(self, cfg, params: Dict,
                 econfig: EngineConfig, *, rng_seed: int = 0, draft=None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(f"params live on {params['embed'].device}, the "
                             f"engine on {self.device}")
        if econfig.prefill_pad > econfig.max_seq_len:
            econfig = dataclasses.replace(econfig,
                                          prefill_pad=econfig.max_seq_len)
        self._model = model_for(cfg)
        if (self._model is M and cfg.kv_bits == 4
                and econfig.max_seq_len % 2):
            # the reference's init_kv_cache refuses it too (the latent
            # cache packs kv4 along its rank, not its positions)
            raise ValueError("kv_bits=4 needs an even max_seq_len")
        if (econfig.prefill_chunk
                and econfig.prefill_chunk > econfig.max_seq_len):
            raise ValueError(
                f"prefill_chunk={econfig.prefill_chunk} exceeds "
                f"max_seq_len={econfig.max_seq_len}")
        if econfig.prefix_cache and not econfig.prefill_chunk:
            raise ValueError("prefix_cache requires prefill_chunk (the "
                             "suffix resumes through the chunked path)")
        self.cfg = cfg
        self.params = params
        self.ec = econfig
        self.metrics = EngineMetrics()
        self._queue: deque[Request] = deque()
        self._all: List[Request] = []
        b = econfig.batch_slots
        self._slots: List[Optional[Request]] = [None] * b
        self._gen = torch.Generator(device=self.device).manual_seed(rng_seed)
        self.cache = self._model.init_kv_cache(
            cfg, b, max_len=econfig.max_seq_len, device=self.device)
        self._cur_tok = torch.zeros(b, dtype=torch.int32, device=self.device)
        self._positions = torch.zeros(b, dtype=torch.int32, device=self.device)
        self._active = np.zeros((b,), bool)
        # per-slot sampling params, mirrored to the device when they change
        self._temps = np.zeros((b,), np.float32)
        self._topks = np.zeros((b,), np.int32)
        self._topps = np.ones((b,), np.float32)
        self._minps = np.zeros((b,), np.float32)
        self._pens = np.ones((b,), np.float32)
        self._freqs = np.zeros((b,), np.float32)   # frequency penalty
        self._press = np.zeros((b,), np.float32)   # presence penalty
        self._plens = np.zeros((b,), np.int32)     # prompt lengths (the
                                                   # generated-only window)
        self._eos_ids = np.full((b,), -1, np.int32)
        self._minnews = np.zeros((b,), np.int32)   # min_new_tokens floors
        # the [B, V] logit bias has a dirty flag of its own: it is copied to
        # the device only when a request with a bias comes or goes
        self._bias_np = np.zeros((b, cfg.vocab_size), np.float32)
        self._bias_dirty = True
        self._slot_state_dirty = True
        self._host_pos = np.zeros((b,), np.int64)  # for the window buckets
        if econfig.speculate > 0 or econfig.track_history:
            # prompt + generated tokens a slot, written in place on the
            # device: the penalties read it, prompt lookup drafts from it
            self._hist = torch.zeros((b, econfig.max_seq_len
                                      + econfig.speculate + 2),
                                     dtype=torch.int32, device=self.device)
        self._draft = draft
        if draft is not None:
            dcfg, _ = draft
            self._check_draft(dcfg, econfig)
            self._dmodel = model_for(dcfg)
            self._dcache = self._dmodel.init_kv_cache(
                dcfg, b, max_len=econfig.max_seq_len, device=self.device)
        # token-tuple key -> (one-slot cache, prefix length); insertion
        # order is the LRU order
        self._prefix_pool: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._pending_prefill: Optional[dict] = None  # a chunked admission
        self._inflight = None          # the dispatched, unprocessed block

    def _check_draft(self, dcfg, ec: EngineConfig) -> None:
        """The reference's checks of a draft model (a Llama-family or an
        MLA config)."""
        if dcfg.vocab_size != self.cfg.vocab_size:
            raise ValueError(f"draft vocab {dcfg.vocab_size} != target "
                             f"vocab {self.cfg.vocab_size}")
        if ec.speculate <= 0:
            raise ValueError("a draft model needs EngineConfig.speculate > 0 "
                             "(the proposal length)")
        if ec.prefill_chunk or ec.prefix_cache:
            raise ValueError("draft-model speculation supports one-shot "
                             "admission only (no prefill_chunk / "
                             "prefix_cache)")

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        if not req.prompt:
            raise ValueError(f"request {req.rid}: prompt must be non-empty")
        sp = req.sampling
        if sp.top_k > TOPK_CAND:
            raise ValueError(
                f"request {req.rid}: top_k={sp.top_k} exceeds the sampler "
                f"candidate window ({TOPK_CAND})")
        if not self.ec.track_history and (
                sp.repetition_penalty != 1.0 or sp.frequency_penalty != 0.0
                or sp.presence_penalty != 0.0 or sp.min_new_tokens > 0
                or sp.logit_bias):
            raise ValueError(
                f"request {req.rid}: repetition/frequency/presence penalties, "
                "min_new_tokens, and logit_bias need the device-side token "
                "history — set EngineConfig.track_history=True")
        if sp.min_new_tokens > 0 and req.guide is not None:
            raise ValueError(
                f"request {req.rid}: min_new_tokens cannot combine with a "
                "guide (the grammar decides when EOS is legal)")
        for t, _ in sp.logit_bias:
            if not 0 <= t < self.cfg.vocab_size:
                raise ValueError(f"request {req.rid}: logit_bias token {t} "
                                 f"outside vocab {self.cfg.vocab_size}")
        if req.guide is not None or req.adapter_id:
            raise NotImplementedError(
                f"request {req.rid}: guided decoding and LoRA adapters are "
                "not ported yet")
        req.submitted_at = time.perf_counter()
        self._queue.append(req)
        self._all.append(req)

    def _free_slot_excluding(self, taken) -> Optional[int]:
        for i, r in enumerate(self._slots):
            if r is None and i not in taken:
                return i
        return None

    def _padded_len(self, plen: int) -> int:
        pad = min(-plen % self.ec.prefill_pad, self.ec.max_seq_len - plen)
        return plen + pad

    def _admit(self, max_chunks: Optional[int] = None) -> None:
        """Admit queued requests into free slots.  One-shot: the head of
        the queue and every following request of the same pad bucket,
        while slots last, truncated to a power of two (the rest re-queue
        for the next tick).  With `prefill_chunk` one request at a time,
        in chunks, at most `max_chunks` chunks this call (None: to the
        end), the rest on later calls."""
        budget = max_chunks
        while True:
            if self._pending_prefill is None:
                if not self._queue:
                    return
                slot = self._free_slot_excluding(())
                if slot is None:
                    return
                req = self._queue.popleft()
                t0 = time.perf_counter()
                plen = len(req.prompt)
                if plen + req.sampling.max_new_tokens > self.ec.max_seq_len:
                    raise ValueError(
                        f"request {req.rid}: prompt {plen} + max_new "
                        f"{req.sampling.max_new_tokens} exceeds max_seq_len "
                        f"{self.ec.max_seq_len}")
                if not self.ec.prefill_chunk:
                    self._admit_burst(req, slot, plen, t0)
                    continue
                self._pending_prefill = self._start_chunked(req, slot, plen,
                                                            t0)
            p = self._pending_prefill
            c = self.ec.prefill_chunk
            while p["j"] < len(p["starts"]):
                if budget is not None and budget <= 0:
                    return
                s = p["starts"][p["j"]]
                final = p["j"] == len(p["starts"]) - 1
                chunk = p["req"].prompt[s:s + c]
                chunk = chunk + [0] * (c - len(chunk))
                p["last"] = self._prefill_chunk(
                    chunk, s, p["plen"] - 1 - s if final else 0, p["fresh"])
                p["j"] += 1
                if budget is not None:
                    budget -= 1
            self._finish_chunked(p)
            self._pending_prefill = None

    def _admit_burst(self, req: Request, slot: int, plen: int,
                     t0: float) -> None:
        """One-shot admission of `req` and the queued requests of its pad
        bucket."""
        batch = [(req, slot, plen, t0)]
        pad0 = self._padded_len(plen)
        while self._queue:
            nxt = self._queue[0]
            nplen = len(nxt.prompt)
            if nplen + nxt.sampling.max_new_tokens > self.ec.max_seq_len:
                break  # raised on its own admission
            if self._padded_len(nplen) != pad0:
                break
            s2 = self._free_slot_excluding([b[1] for b in batch])
            if s2 is None:
                break
            self._queue.popleft()
            batch.append((nxt, s2, nplen, time.perf_counter()))
        # the re-queued extras restart their prefill clock (t0) when they
        # are admitted, as in the reference
        keep = 1 << (len(batch).bit_length() - 1)
        for extra in reversed(batch[keep:]):
            self._queue.appendleft(extra[0])
        self._admit_one_shot(batch[:keep])

    # ------------------------------------------------------------------
    # chunked prefill and the prefix cache
    # ------------------------------------------------------------------
    def _prefill_chunk(self, tokens: List[int], offset: int, last: int,
                       cache) -> torch.Tensor:
        """One chunk of a prompt through the model against the one-slot
        `cache` (appended in place at `offset`) -> logits [1, V] at chunk
        row `last`; MLA's chunk takes its absorbed path (`forward_chunk`),
        as in the reference."""
        dev = self.device
        c = len(tokens)
        positions = (offset + torch.arange(c, dtype=torch.int32,
                                           device=dev))[None]
        toks = torch.tensor([tokens], dtype=torch.int32, device=dev)
        last_t = torch.tensor([last], dtype=torch.int32, device=dev)
        if self._model is ML:
            logits, _ = ML.forward_chunk(self.cfg, self.params, toks,
                                         positions, cache, last_t, offset)
            return logits
        logits, _ = M.forward(self.cfg, self.params, toks,
                              positions=positions, cache=cache,
                              logit_positions=last_t, kv_write_start=offset)
        return logits[:, 0]

    def _new_slot_cache(self):
        return self._model.init_kv_cache(self.cfg, 1,
                                         max_len=self.ec.max_seq_len,
                                         device=self.device)

    def _complete_chunks(self, n_tokens: int) -> int:
        """The whole prefill_chunk multiples of `n_tokens` a pool entry may
        hold, leaving at least one chunk of room for a suffix."""
        c = self.ec.prefill_chunk
        return min(n_tokens // c, (self.ec.max_seq_len - c) // c) * c

    def preseed_prefix(self, tokens: List[int], adapter_id: int = 0) -> int:
        """Prefill `tokens` once and pin their KV in the prefix pool: every
        later prompt starting with them skips that prefill.  Only whole
        prefill_chunk multiples are kept (a partial tail chunk would write
        pad-token KV a suffix does not overwrite before reading it).
        Entries are keyed by (adapter_id, tokens).  Returns the pooled
        length."""
        if not self.ec.prefix_cache:
            raise ValueError("prefix_cache is 0: enable it in EngineConfig")
        if adapter_id:
            raise NotImplementedError("LoRA adapters are not ported yet")
        c = self.ec.prefill_chunk
        eff = self._complete_chunks(len(tokens))
        if eff <= 0:
            return 0
        fresh = self._new_slot_cache()
        for s in range(0, eff, c):
            self._prefill_chunk(list(tokens[s:s + c]), s, 0, fresh)
        self._pool_put((adapter_id, tuple(tokens[:eff])), fresh, eff)
        return eff

    def _pool_put(self, key: tuple, cache, eff: int) -> None:
        pool = self._prefix_pool
        if key in pool:
            pool.move_to_end(key)
            return
        while len(pool) >= self.ec.prefix_cache:
            pool.popitem(last=False)           # the least recently used
        pool[key] = (cache, eff)

    def _match_prefix(self, prompt: List[int], adapter_id: int = 0):
        """The longest pooled prefix of `prompt` -> (key, cache, eff), or
        None."""
        best = None
        for key, (cache, eff) in self._prefix_pool.items():
            aid, toks = key
            if (aid == adapter_id and len(toks) <= len(prompt)
                    and (best is None or eff > best[2])
                    and list(toks) == prompt[:len(toks)]):
                best = (key, cache, eff)
        if best is not None:
            self._prefix_pool.move_to_end(best[0])
        return best

    def _start_chunked(self, req: Request, slot: int, plen: int,
                       t0: float) -> dict:
        """The state of a chunked admission: its one-slot cache (a copy of
        a matching pool entry, or empty) and its chunk starts, from the
        matched length in prefill_chunk steps, the last one shifted back so
        that it ends at max_seq_len at most (it re-runs a few prefilled
        positions, which write the same KV again)."""
        c = self.ec.prefill_chunk
        m0, fresh = 0, None
        if self.ec.prefix_cache:
            hit = self._match_prefix(req.prompt, req.adapter_id)
            if hit is not None:
                _, pcache, eff = hit
                m0 = min(eff, plen - 1)
                fresh = _cache_like(pcache,
                                    (t.clone() for t in pcache.tensors()))
                self.metrics.prefix_hits += 1
                self.metrics.prefix_tokens_saved += m0
        if fresh is None:
            fresh = self._new_slot_cache()
        starts = list(range(m0, plen, c))
        if starts[-1] + c > self.ec.max_seq_len:
            starts[-1] = self.ec.max_seq_len - c
        return {"req": req, "slot": slot, "plen": plen, "t0": t0,
                "starts": starts, "j": 0, "last": None, "fresh": fresh}

    def _finish_chunked(self, p: dict) -> None:
        """All chunks done: pool the prompt's whole chunks (auto capture),
        copy the slot cache in and sample the first token."""
        req, slot, plen = p["req"], p["slot"], p["plen"]
        if self.ec.prefix_cache and self.ec.prefix_cache_auto:
            # the slot cache is not written again: pool it as it is (a hit
            # copies it out)
            ceff = self._complete_chunks(plen)
            if ceff > 0:
                self._pool_put((req.adapter_id, tuple(req.prompt[:ceff])),
                               p["fresh"], ceff)
        slots = torch.tensor([slot], device=self.device)
        _copy_rows(self.cache, p["fresh"], slots)
        tok, lp = self._sample_first(p["last"], [req])
        self._cur_tok[slots] = tok
        self._positions[slots] = plen
        self._record_first_token(req, int(tok[0]), float(lp[0]), slot, plen,
                                 p["t0"])

    def _admit_one_shot(self, batch) -> None:
        """One prefill call for `batch` = [(req, slot, plen, t0), ...] (all
        of one pad bucket), then the slots' caches and first tokens."""
        dev = self.device
        bq = len(batch)
        width = self._padded_len(batch[0][2])
        rows = np.zeros((bq, width), np.int32)
        for i, (req, _, plen, _) in enumerate(batch):
            rows[i, :plen] = np.asarray(req.prompt, np.int32)
        plens = torch.tensor([plen for _, _, plen, _ in batch],
                             dtype=torch.int32, device=dev)
        slots = torch.tensor([slot for _, slot, _, _ in batch], device=dev)
        # the prompt's KV is built in a cache of its own padded width (kv4:
        # the next even width, whole pair rows) and its first `width`
        # positions are copied into the slots; positions past it are never
        # read before decode writes them
        fresh = self._model.init_kv_cache(
            self.cfg, bq, max_len=_burst_len(self._model, self.cfg, width),
            device=dev)
        last, fresh = self._model.prefill(self.cfg, self.params,
                                          torch.from_numpy(rows).to(dev),
                                          fresh, last_positions=plens - 1)
        _copy_rows(self.cache, fresh, slots, width)
        if self._draft is not None:
            # the draft model needs the prompts' KV too, in the same slots
            dcfg, dparams = self._draft
            dfresh = self._dmodel.init_kv_cache(
                dcfg, bq, max_len=_burst_len(self._dmodel, dcfg, width),
                device=dev)
            _, dfresh = self._dmodel.prefill(dcfg, dparams,
                                             torch.from_numpy(rows).to(dev),
                                             dfresh, last_positions=plens - 1)
            _copy_rows(self._dcache, dfresh, slots, width)
        tok, lp = self._sample_first(last, [req for req, _, _, _ in batch])
        self._cur_tok[slots] = tok
        self._positions[slots] = plens
        toks, lps = tok.cpu().numpy(), lp.cpu().numpy()
        for i, (req, slot, plen, t0) in enumerate(batch):
            self._record_first_token(req, int(toks[i]), float(lps[i]), slot,
                                     plen, t0)

    def _first_bias_row(self, sp: SamplingParams) -> np.ndarray:
        """[V] logit bias of a request's FIRST token: its logit_bias, and
        EOS suppressed when min_new_tokens >= 1."""
        row = np.zeros((self.cfg.vocab_size,), np.float32)
        for t, bv in sp.logit_bias:
            row[t] = bv
        if sp.min_new_tokens > 0 and sp.eos_token >= 0:
            row[sp.eos_token] = -1e30
        return row

    def _sample_first(self, last: torch.Tensor, reqs):
        """First tokens of prompts from their last logits [Bq, V] ->
        (tokens, logprobs of the raw logits) on the device.  With the
        token history, the repetition penalty over each prompt and the
        first bias rows apply first."""
        def vec(vals, dtype):
            return torch.tensor(vals, dtype=dtype, device=self.device)

        sps = [r.sampling for r in reqs]
        logits = last
        if self.ec.track_history:
            width = max(len(r.prompt) for r in reqs)
            rows = np.zeros((len(reqs), width), np.int32)
            for i, r in enumerate(reqs):
                rows[i, :len(r.prompt)] = r.prompt
            logits = apply_repetition_penalty(
                last, torch.from_numpy(rows).to(self.device),
                vec([len(r.prompt) for r in reqs], torch.int32),
                vec([s.repetition_penalty for s in sps], torch.float32))
            logits = logits + torch.from_numpy(np.stack(
                [self._first_bias_row(s) for s in sps])).to(self.device)
        tok = sample_batch(logits,
                           vec([s.temperature for s in sps], torch.float32),
                           vec([s.top_k for s in sps], torch.int32),
                           vec([s.top_p for s in sps], torch.float32),
                           self._gen,
                           vec([s.min_p for s in sps], torch.float32))
        return tok, _tok_logprob(last, tok)

    def _record_first_token(self, req: Request, tok: int, lp: float,
                            slot: int, plen: int, t0: float) -> None:
        now = time.perf_counter()
        req.ttft_s = now - req.submitted_at
        self.metrics.ttfts.append(req.ttft_s)
        self.metrics.prefill_tokens += plen
        self.metrics.prefill_time_s += now - t0
        req.tokens.append(tok)
        req.logprobs.append(lp)
        self._slots[slot] = req
        self._active[slot] = True
        self._temps[slot] = req.sampling.temperature
        self._topks[slot] = req.sampling.top_k
        self._topps[slot] = req.sampling.top_p
        self._minps[slot] = req.sampling.min_p
        self._pens[slot] = req.sampling.repetition_penalty
        self._freqs[slot] = req.sampling.frequency_penalty
        self._press[slot] = req.sampling.presence_penalty
        self._plens[slot] = plen
        self._eos_ids[slot] = req.sampling.eos_token
        self._minnews[slot] = req.sampling.min_new_tokens
        if req.sampling.logit_bias or self._bias_np[slot].any():
            self._bias_np[slot] = 0.0
            for t, bv in req.sampling.logit_bias:
                self._bias_np[slot, t] = bv
            self._bias_dirty = True
        self._slot_state_dirty = True
        self._host_pos[slot] = plen
        if hasattr(self, "_hist"):
            # entries [0, plen] valid: the prompt and the first token
            row = np.asarray(req.prompt + [tok], np.int32)
            self._hist[slot, :plen + 1] = torch.from_numpy(row).to(
                self.device)
        self._maybe_finish(req, slot)

    def _maybe_finish(self, req: Request, slot: int) -> None:
        s = req.sampling
        hit_seq = None
        for seq in s.stop_sequences:
            n = len(seq)
            if n and len(req.tokens) >= n and tuple(req.tokens[-n:]) == tuple(seq):
                hit_seq = n
                break
        if len(req.tokens) >= s.max_new_tokens or hit_seq is not None or (
                s.eos_token >= 0 and req.tokens[-1] == s.eos_token) or (
                s.stop_tokens and req.tokens[-1] in s.stop_tokens):
            if hit_seq is not None:  # trim the matched stop suffix
                del req.tokens[-hit_seq:]
                del req.logprobs[len(req.tokens):]
            req.done = True
            if self._slots[slot] is req:  # bookkeeping runs a block behind
                self._slots[slot] = None  # dispatch: never clobber a
                self._active[slot] = False  # re-admitted slot
                self._slot_state_dirty = True

    # ------------------------------------------------------------------
    def _spec_mode(self) -> Optional[str]:
        """None: no speculation this block; "greedy": greedy verify;
        "sample": rejection sampling (a draft model and pure-temperature
        slots only: truncation samplers would need the same truncation of
        both distributions).  Reads host state only."""
        if self.ec.speculate <= 0:
            return None
        live = [i for i, r in enumerate(self._slots) if r is not None]
        if any(self._pens[i] != 1.0 or self._freqs[i] != 0.0
               or self._press[i] != 0.0 or self._minnews[i] > 0
               or self._bias_np[i].any() for i in live):
            return None      # a penalized slot: the plain decode path
        bound = self.ec.decode_block * (self.ec.speculate + 1) + 1
        if (int(self._host_pos[self._active].max()) + bound
                >= self.ec.max_seq_len):
            return None
        if all(self._temps[i] <= 0 for i in live):
            return "greedy"
        if self._draft is not None and all(
                self._temps[i] > 0 and self._topks[i] == 0
                and self._topps[i] >= 1.0 and self._minps[i] <= 0
                for i in live):
            return "sample"
        return None

    def _readback(self, kind: str, *tensors):
        """Start the block's one device-to-host copy of `tensors`; the
        payload carries the copies and an event to wait on."""
        hosts = [t.to("cpu", non_blocking=True) for t in tensors]
        done = None
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
        return (kind, *hosts, done)

    def _dispatch_block(self):
        """Launch one decode block (plain or speculative) and start its
        token readback; returns the pending readback and the slot snapshot
        for attribution."""
        dev = self.device
        if self._slot_state_dirty:
            self._temps_dev = torch.from_numpy(self._temps).to(dev)
            self._topks_dev = torch.from_numpy(self._topks).to(dev)
            self._topps_dev = torch.from_numpy(self._topps).to(dev)
            self._minps_dev = torch.from_numpy(self._minps).to(dev)
            self._active_dev = torch.from_numpy(self._active).to(dev)
            if self.ec.track_history:
                for f in ("_pens", "_freqs", "_press", "_plens", "_eos_ids",
                          "_minnews"):
                    setattr(self, f + "_dev",
                            torch.from_numpy(getattr(self, f)).to(dev))
            self._slot_state_dirty = False
        if self.ec.track_history and self._bias_dirty:
            self._bias_dev = torch.from_numpy(self._bias_np).to(dev)
            self._bias_dirty = False
        kblk = self.ec.decode_block
        mode = self._spec_mode()
        if mode is not None:
            return self._dispatch_spec(mode, kblk), list(self._slots)
        window = self.ec.max_seq_len
        if self.ec.attn_windows:
            need = int(self._host_pos[self._active].max()) + kblk + 1
            window = min((w for w in self.ec.attn_windows if w >= need),
                         default=self.ec.max_seq_len)
        self._host_pos[self._active] += kblk
        tok, pos = self._cur_tok, self._positions
        step_inc = self._active_dev.to(torch.int32)
        # prompt lookup drafts from the history: plain blocks keep it
        # current (a draft model does not read it)
        keep_hist = self.ec.track_history or (self.ec.speculate > 0
                                              and self._draft is None)
        toks, lps = [], []
        for _ in range(kblk):
            logits, self.cache = self._model.decode_step(
                self.cfg, self.params, tok, pos, self.cache,
                attn_window=window)
            raw = logits
            if self.ec.track_history:
                logits = self._penalize(logits, pos)
            nxt = sample_batch(logits, self._temps_dev, self._topks_dev,
                               self._topps_dev, self._gen, self._minps_dev)
            tok = torch.where(self._active_dev, nxt, tok)
            if keep_hist:
                self._hist_write(tok, pos)
            toks.append(tok)
            lps.append(_tok_logprob(raw, tok))
            pos = pos + step_inc
        self._cur_tok, self._positions = tok, pos
        # ONE [K, B] readback per block, started now and awaited when the
        # block is processed (after the next block has been launched)
        return (self._readback("plain", torch.stack(toks), torch.stack(lps)),
                list(self._slots))

    def _dispatch_spec(self, mode: str, kblk: int):
        """`kblk` speculative verify steps (no attention window, as in the
        reference); the payload of their [K, B, G+1] tokens, log-probs and
        [K, B] emit counts."""
        g = self.ec.speculate
        # a conservative bound; _process_block corrects it to the counts
        self._host_pos[self._active] += kblk * (g + 1)
        tok, pos = self._cur_tok, self._positions
        if mode == "sample":
            dcfg, dparams = self._draft
            (emit, lp, n_emit, tok, pos, self.cache,
             self._dcache) = SP.draft_spec_block_sample(
                self.cfg, self.params, dcfg, dparams, tok, pos, self.cache,
                self._dcache, self._temps_dev, self._gen, self._active_dev,
                kblk, g)
        elif self._draft is not None:
            dcfg, dparams = self._draft
            (emit, lp, n_emit, tok, pos, self.cache,
             self._dcache) = SP.draft_spec_block(
                self.cfg, self.params, dcfg, dparams, tok, pos, self.cache,
                self._dcache, self._active_dev, kblk, g)
        else:
            emit, lp, n_emit, tok, pos, self._hist, self.cache = (
                SP.spec_block(self.cfg, self.params, tok, pos, self.cache,
                              self._hist, self._active_dev, kblk, g))
        self._cur_tok, self._positions = tok, pos
        return self._readback("spec", emit, lp, n_emit)

    def _penalize(self, logits: torch.Tensor, pos: torch.Tensor
                  ) -> torch.Tensor:
        """The reference's history-tracking decode step before sampling:
        the repetition penalty over history entries [0, pos], frequency
        and presence over the generated ones, the logit bias, and each
        slot's EOS suppressed while the count of generated tokens after
        this step (pos + 2 - plen: the first came from the prefill) would
        still be under its min_new_tokens."""
        h = self._hist
        logits = apply_repetition_penalty(logits, h, pos + 1, self._pens_dev)
        logits = apply_freq_presence(logits, h, self._plens_dev, pos + 1,
                                     self._freqs_dev, self._press_dev)
        logits = logits + self._bias_dev
        supp = (((pos + 2 - self._plens_dev) <= self._minnews_dev)
                & (self._eos_ids_dev >= 0))
        rows = torch.arange(logits.shape[0], device=logits.device)
        return logits.index_put_(
            (rows, self._eos_ids_dev.clamp(min=0).long()),
            torch.where(supp, -1e30, 0.0), accumulate=True)

    def _hist_write(self, tok: torch.Tensor, pos: torch.Tensor) -> None:
        """Each active slot's new token into its history at pos + 1 (the
        last entry at most), in place on the device."""
        rows = torch.arange(tok.shape[0], device=tok.device)
        at = torch.clamp(pos + 1, max=self._hist.shape[1] - 1).long()
        self._hist[rows, at] = torch.where(self._active_dev, tok,
                                           self._hist[rows, at])

    def _process_block(self, payload, slots_snapshot) -> None:
        """Read a dispatched block's tokens and do the bookkeeping."""
        kind, *hosts, done = payload
        if done is not None:
            done.synchronize()
        if kind == "spec":
            self._process_spec(*(h.numpy() for h in hosts), slots_snapshot)
            return
        toks_np, lps_np = (h.numpy() for h in hosts)
        for step in range(toks_np.shape[0]):
            for i, req in enumerate(slots_snapshot):
                if req is not None and not req.done:
                    req.tokens.append(int(toks_np[step, i]))
                    req.logprobs.append(float(lps_np[step, i]))
                    self.metrics.decode_tokens += 1
                    self._maybe_finish(req, i)

    def _process_spec(self, emits, lps, counts, slots_snapshot) -> None:
        """A speculative block: step k emitted emits[k, i, :counts[k, i]]
        for slot i; each token may finish its request.  The slot's host
        position drops from the dispatch's bound to the count."""
        g1 = self.ec.speculate + 1
        for step in range(emits.shape[0]):
            for i, req in enumerate(slots_snapshot):
                if req is None or req.done:
                    continue
                for j in range(counts[step, i]):
                    req.tokens.append(int(emits[step, i, j]))
                    req.logprobs.append(float(lps[step, i, j]))
                    self.metrics.decode_tokens += 1
                    self._maybe_finish(req, i)
                    if req.done:
                        break
                self._host_pos[i] -= g1 - int(counts[step, i])

    def _step_decode(self) -> None:
        """Synchronous block step (dispatch, then process); run() pipelines
        them instead."""
        self._drain()
        t0 = time.perf_counter()
        self._process_block(*self._dispatch_block())
        self.metrics.decode_time_s += time.perf_counter() - t0

    def _drain(self) -> None:
        """Process the block in flight, if any."""
        if self._inflight is not None:
            payload, self._inflight = self._inflight, None
            self._process_block(*payload)

    # ------------------------------------------------------------------
    # snapshot / restore
    # ------------------------------------------------------------------
    _SNAP_HOST = ("_temps", "_topks", "_topps", "_minps", "_pens", "_freqs",
                  "_press", "_plens", "_bias_np", "_eos_ids", "_minnews",
                  "_host_pos", "_active")

    def snapshot(self) -> dict:
        """The engine's whole state on the host: the KV cache, per-slot
        sampler state, in-flight requests, the queue, the generator's
        state, the metrics and the prefix pool.  Restoring it into a fresh
        Engine of the same config and params resumes with identical
        tokens.  Call between scheduler ticks: a chunked admission in
        progress cannot be snapshotted.  The block in flight is processed
        first, so its tokens are on their requests (a run_stream in
        progress does not yield them)."""
        if self._pending_prefill is not None:
            raise ValueError("snapshot mid-admission: drain the pending "
                             "chunked prefill first (one _admit() tick)")
        self._drain()

        def host(cache):
            return [t.detach().to("cpu", copy=True) for t in cache.tensors()]

        # the requests and metrics deep-copied together (a slot's request
        # is also in "all"), so the running engine does not change them
        state = copy.deepcopy({
            "slots": self._slots, "queue": list(self._queue),
            "all": self._all, "metrics": self.metrics})
        state.update({
            "cache": host(self.cache),
            "cur_tok": self._cur_tok.to("cpu", copy=True),
            "positions": self._positions.to("cpu", copy=True),
            "generator": self._gen.get_state(),
            "prefix_pool": [(k, host(c), eff)
                            for k, (c, eff) in self._prefix_pool.items()],
        })
        if hasattr(self, "_hist"):
            state["hist"] = self._hist.to("cpu", copy=True)
        if self._draft is not None:
            state["dcache"] = host(self._dcache)
        for f in self._SNAP_HOST:
            state[f] = getattr(self, f).copy()
        return state

    def restore(self, state: dict) -> None:
        """Load a snapshot() into this (freshly built) engine."""
        def dev(ts, like):
            return _cache_like(like, (t.to(self.device, copy=True)
                                      for t in ts))

        like = self.cache
        self.cache = dev(state["cache"], like)
        self._cur_tok = state["cur_tok"].to(self.device, copy=True)
        self._positions = state["positions"].to(self.device, copy=True)
        self._gen.set_state(state["generator"])
        reqs = copy.deepcopy({k: state[k] for k in ("slots", "queue", "all",
                                                     "metrics")})
        self._slots = list(reqs["slots"])
        self._queue = deque(reqs["queue"])
        self._all = list(reqs["all"])
        self.metrics = reqs["metrics"]
        self._prefix_pool = OrderedDict(
            (k, (dev(c, like), eff)) for k, c, eff in state["prefix_pool"])
        for f in self._SNAP_HOST:
            setattr(self, f, state[f].copy())
        if "hist" in state:
            self._hist = state["hist"].to(self.device, copy=True)
        if "dcache" in state and self._draft is not None:
            self._dcache = dev(state["dcache"], self._dcache)
        self._slot_state_dirty = True   # device mirrors rebuilt lazily
        self._bias_dirty = True
        self._pending_prefill = None
        self._inflight = None

    def save(self, path: str) -> None:
        """snapshot() to disk (pickle)."""
        with open(path, "wb") as f:
            pickle.dump(self.snapshot(), f, protocol=4)

    def load(self, path: str) -> None:
        with open(path, "rb") as f:
            self.restore(pickle.load(f))

    # ------------------------------------------------------------------
    def run(self) -> List[Request]:
        """Run until queue and slots drain; returns completed requests."""
        for _ in self.run_stream():
            pass
        return [r for r in self._all if r.done]

    def run_stream(self):
        """Generator form of run(): yields (request, new_token) pairs as
        each block's tokens are read back.  While slots decode, a chunked
        admission advances one chunk a tick."""
        while (self._inflight is not None or self._queue
               or any(r is not None for r in self._slots)
               or self._pending_prefill is not None):
            decoding = any(r is not None for r in self._slots)
            self._admit(max_chunks=1 if (decoding and self.ec.prefill_chunk)
                        else None)
            t0 = time.perf_counter()
            nxt = None
            if any(r is not None for r in self._slots):
                nxt = self._dispatch_block()
            pending, self._inflight = self._inflight, nxt
            if pending is not None:
                before = {id(r): len(r.tokens) for r in self._all}
                self._process_block(*pending)
                self.metrics.decode_time_s += time.perf_counter() - t0
                for r in self._all:
                    for tok in r.tokens[before.get(id(r), 0):]:
                        yield r, tok
            else:
                self.metrics.decode_time_s += time.perf_counter() - t0
