"""Continuous-batching inference engine (counterpart of
piquant_tpu/serving/engine.py).

A host scheduler drives slot-wise prefill admission and whole-batch decode
blocks over a fixed pool of batch slots backed by the stacked kv8 or kv4
cache.
Queued prompts of one pad bucket are admitted in ONE prefill call (bursts
truncated to a power of two, as in the reference), and decode runs in
blocks of `decode_block` steps whose [K, B] tokens come back to the host in
one copy per block.  The loop is pipelined: block N is launched before
block N-1's tokens are read, so the readback overlaps device work.

Not ported yet (raise NotImplementedError): speculation, chunked prefill,
the prefix cache, attention-window buckets, token history and penalties,
guided decoding, LoRA adapters, draft models and snapshot/restore.
"""

from __future__ import annotations

import dataclasses
import json
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from piquant_tpu_torch._device import DeviceLike, resolve_device
from piquant_tpu_torch.models import llama as M
from piquant_tpu_torch.quant.kv_cache import kv_cache_copy_rows
from piquant_tpu_torch.serving.sampler import (TOPK_CAND, SamplingParams,
                                               sample_batch)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    batch_slots: int = 8
    max_seq_len: int = 2048
    prefill_pad: int = 64      # prompts are right-padded to a multiple of this
    decode_block: int = 16     # decode steps per block (one token readback)
    # reference options that are not ported yet: any non-default value
    # raises NotImplementedError (the reference's warmup_buckets and
    # max_guide_states only qualify attn_windows and guided decoding)
    speculate: int = 0
    attn_windows: tuple = ()
    track_history: bool = False
    prefill_chunk: Optional[int] = None
    prefix_cache: int = 0
    prefix_cache_auto: bool = False

    def check_ported(self) -> None:
        todo = [f.name for f in dataclasses.fields(self)[4:]
                if getattr(self, f.name) != f.default]
        if todo:
            raise NotImplementedError(
                f"EngineConfig options not ported yet: {todo}")


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
    prefix_hits: int = 0           # the prefix cache is not ported: 0
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


def _tok_logprob(logits: torch.Tensor, toks: torch.Tensor) -> torch.Tensor:
    """log p(tok) under the RAW model distribution ([B, V] f32 logits)."""
    lf = logits.float()
    chosen = torch.gather(lf, 1, toks[:, None].long())[:, 0]
    return chosen - torch.logsumexp(lf, dim=-1)


class Engine:
    def __init__(self, cfg: M.LlamaConfig, params: Dict,
                 econfig: EngineConfig, *, rng_seed: int = 0, draft=None,
                 device: DeviceLike = None):
        if draft is not None:
            raise NotImplementedError("draft-model speculation is not "
                                      "ported yet")
        econfig.check_ported()
        self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(f"params live on {params['embed'].device}, the "
                             f"engine on {self.device}")
        if econfig.prefill_pad > econfig.max_seq_len:
            econfig = dataclasses.replace(econfig,
                                          prefill_pad=econfig.max_seq_len)
        if cfg.kv_bits == 4 and (econfig.prefill_pad % 2
                                 or econfig.max_seq_len % 2):
            # a prefill's padded width must fill whole kv4 pair rows
            raise ValueError("kv_bits=4 needs an even prefill_pad and "
                             "max_seq_len")
        self.cfg = cfg
        self.params = params
        self.ec = econfig
        self.metrics = EngineMetrics()
        self._queue: deque[Request] = deque()
        self._all: List[Request] = []
        b = econfig.batch_slots
        self._slots: List[Optional[Request]] = [None] * b
        self._gen = torch.Generator(device=self.device).manual_seed(rng_seed)
        self.cache = M.init_kv_cache(cfg, b, max_len=econfig.max_seq_len,
                                     device=self.device)
        self._cur_tok = torch.zeros(b, dtype=torch.int32, device=self.device)
        self._positions = torch.zeros(b, dtype=torch.int32, device=self.device)
        self._active = np.zeros((b,), bool)
        # per-slot sampling params, mirrored to the device when they change
        self._temps = np.zeros((b,), np.float32)
        self._topks = np.zeros((b,), np.int32)
        self._topps = np.ones((b,), np.float32)
        self._minps = np.zeros((b,), np.float32)
        self._slot_state_dirty = True

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        if not req.prompt:
            raise ValueError(f"request {req.rid}: prompt must be non-empty")
        sp = req.sampling
        if sp.top_k > TOPK_CAND:
            raise ValueError(
                f"request {req.rid}: top_k={sp.top_k} exceeds the sampler "
                f"candidate window ({TOPK_CAND})")
        if (sp.repetition_penalty != 1.0 or sp.frequency_penalty != 0.0
                or sp.presence_penalty != 0.0 or sp.min_new_tokens > 0
                or sp.logit_bias):
            raise NotImplementedError(
                f"request {req.rid}: penalties, min_new_tokens and "
                "logit_bias need the token history, which is not ported yet")
        if req.guide is not None or req.adapter_id:
            raise NotImplementedError(
                f"request {req.rid}: guided decoding and LoRA adapters are "
                "not ported yet")
        req.submitted_at = time.perf_counter()
        self._queue.append(req)
        self._all.append(req)

    def snapshot(self) -> dict:
        raise NotImplementedError("snapshot/restore is not ported yet")

    def restore(self, state: dict) -> None:
        raise NotImplementedError("snapshot/restore is not ported yet")

    def _free_slot_excluding(self, taken) -> Optional[int]:
        for i, r in enumerate(self._slots):
            if r is None and i not in taken:
                return i
        return None

    def _padded_len(self, plen: int) -> int:
        pad = min(-plen % self.ec.prefill_pad, self.ec.max_seq_len - plen)
        return plen + pad

    def _admit(self) -> None:
        """Admit queued requests into free slots: the head of the queue and
        every following request of the same pad bucket, while slots last,
        truncated to a power of two (the rest re-queue for the next tick)."""
        while self._queue:
            slot = self._free_slot_excluding(())
            if slot is None:
                return
            req = self._queue.popleft()
            plen = len(req.prompt)
            if plen + req.sampling.max_new_tokens > self.ec.max_seq_len:
                raise ValueError(
                    f"request {req.rid}: prompt {plen} + max_new "
                    f"{req.sampling.max_new_tokens} exceeds max_seq_len "
                    f"{self.ec.max_seq_len}")
            batch = [(req, slot, plen, time.perf_counter())]
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
            # the re-queued extras restart their prefill clock (t0) when
            # they are admitted, as in the reference
            keep = 1 << (len(batch).bit_length() - 1)
            for extra in reversed(batch[keep:]):
                self._queue.appendleft(extra[0])
            self._admit_one_shot(batch[:keep])

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
        # the prompt's KV is built in a cache of its own padded width and
        # copied into the slots' first `width` positions; positions past it
        # are never read before decode writes them
        fresh = M.init_kv_cache(self.cfg, bq, max_len=width, device=dev)
        last, fresh = M.prefill(self.cfg, self.params,
                                torch.from_numpy(rows).to(dev), fresh,
                                last_positions=plens - 1)
        kv_cache_copy_rows(self.cache, fresh, slots)
        sps = [req.sampling for req, _, _, _ in batch]

        def vec(vals, dtype):
            return torch.tensor(vals, dtype=dtype, device=dev)

        tok = sample_batch(last, vec([s.temperature for s in sps], torch.float32),
                           vec([s.top_k for s in sps], torch.int32),
                           vec([s.top_p for s in sps], torch.float32),
                           self._gen,
                           vec([s.min_p for s in sps], torch.float32))
        lp = _tok_logprob(last, tok)
        self._cur_tok[slots] = tok
        self._positions[slots] = plens
        toks, lps = tok.cpu().numpy(), lp.cpu().numpy()
        for i, (req, slot, plen, t0) in enumerate(batch):
            self._record_first_token(req, int(toks[i]), float(lps[i]), slot,
                                     plen, t0)

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
        self._slot_state_dirty = True
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
    def _dispatch_block(self):
        """Launch one decode block and start its token readback; returns
        the pending readback and the slot snapshot for attribution."""
        dev = self.device
        if self._slot_state_dirty:
            self._temps_dev = torch.from_numpy(self._temps).to(dev)
            self._topks_dev = torch.from_numpy(self._topks).to(dev)
            self._topps_dev = torch.from_numpy(self._topps).to(dev)
            self._minps_dev = torch.from_numpy(self._minps).to(dev)
            self._active_dev = torch.from_numpy(self._active).to(dev)
            self._slot_state_dirty = False
        tok, pos = self._cur_tok, self._positions
        step_inc = self._active_dev.to(torch.int32)
        toks, lps = [], []
        for _ in range(self.ec.decode_block):
            logits, self.cache = M.decode_step(self.cfg, self.params, tok, pos,
                                               self.cache)
            nxt = sample_batch(logits, self._temps_dev, self._topks_dev,
                               self._topps_dev, self._gen, self._minps_dev)
            tok = torch.where(self._active_dev, nxt, tok)
            toks.append(tok)
            lps.append(_tok_logprob(logits, tok))
            pos = pos + step_inc
        self._cur_tok, self._positions = tok, pos
        # ONE [K, B] readback per block, started now and awaited when the
        # block is processed (after the next block has been launched)
        tok_host = torch.stack(toks).to("cpu", non_blocking=True)
        lp_host = torch.stack(lps).to("cpu", non_blocking=True)
        done = None
        if dev.type == "cuda":
            done = torch.cuda.Event()
            done.record()
        return (tok_host, lp_host, done), list(self._slots)

    def _process_block(self, payload, slots_snapshot) -> None:
        """Read a dispatched block's tokens and do the bookkeeping."""
        tok_host, lp_host, done = payload
        if done is not None:
            done.synchronize()
        toks_np, lps_np = tok_host.numpy(), lp_host.numpy()
        for step in range(toks_np.shape[0]):
            for i, req in enumerate(slots_snapshot):
                if req is not None and not req.done:
                    req.tokens.append(int(toks_np[step, i]))
                    req.logprobs.append(float(lps_np[step, i]))
                    self.metrics.decode_tokens += 1
                    self._maybe_finish(req, i)

    # ------------------------------------------------------------------
    def run(self) -> List[Request]:
        """Run until queue and slots drain; returns completed requests."""
        for _ in self.run_stream():
            pass
        return [r for r in self._all if r.done]

    def run_stream(self):
        """Generator form of run(): yields (request, new_token) pairs as
        each block's tokens are read back."""
        pending = None
        while (pending is not None or self._queue
               or any(r is not None for r in self._slots)):
            self._admit()
            t0 = time.perf_counter()
            nxt = None
            if any(r is not None for r in self._slots):
                nxt = self._dispatch_block()
            if pending is not None:
                before = {id(r): len(r.tokens) for r in self._all}
                self._process_block(*pending)
                self.metrics.decode_time_s += time.perf_counter() - t0
                for r in self._all:
                    for tok in r.tokens[before.get(id(r), 0):]:
                        yield r, tok
            else:
                self.metrics.decode_time_s += time.perf_counter() - t0
            pending = nxt
