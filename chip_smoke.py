#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (piquant_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # needs one CUDA card

Phases (any failure exits non-zero):
  1. card: name and power limit from nvidia-smi;
  2. build: the hand-written kernels from piquant_tpu_torch/csrc with nvcc;
  3. kernels: each serving kernel's wrapper against its plain PyTorch
     version at the Llama-3-8B main-path shapes (decode batch 8), with its
     time, its bound and a one-call PyTorch yardstick (flash also with its
     achieved TFLOP/s and share of the bound, as at every flash hold, and
     each of its 24 instances' registers, spills and shared memory; the
     GEMV template's 40 instances' registers, spills, shared memory, ring
     stages and rows a stage);
  4. library core: the quantize / dequantize / requantize / min-max kernels
     bit for bit against their plain versions over f32/bf16 x {u8, i8, u16,
     i16, uint4, int4, uint2} at numel 27,264,000 (bench.py's protocol) and
     a ragged tail, with the edge values (ties, NaN, +-inf, 3e9); then the
     public API end to end at that size with launch counts; then each
     kernel's time (graph replay, and events around eager launches as the
     yardstick is timed), bound, plain time and PyTorch yardstick, and
     dequantize at numel 1,048,576;
  5. engine: the port's Engine serving 16 requests on Llama-3-8B at full
     width (random INT4 codes from a seed), launch counts of every kernel,
     engine tokens against the port's own single-request generation, and
     decode / prefill throughput and TTFT;
  6. weight-format kernels: the INT8, INT2 and grouped GEMVs against their
     plain versions at the Llama-3-8B shapes (the INT8 lm_head; INT2 and
     INT4-g128 projections; the INT2-g32 MLP; the INT4-g256 w2) at M = 8,
     1, 33 and 64, with their times, bounds and a torch.matmul yardstick;
  7. CLI: `python -m piquant_tpu_torch.serving --random llama3_8b
     --benchmark 8 --max-new 32` in process (at 4 of its 32 layers since
     phase 11 came, full width), in four weight formats
     (INT4-g128; INT4 attention with an INT2-g32 MLP; INT4-g256; INT2) and
     four activation-quantized runs (--act-quant-prefill at INT4 and INT8;
     --act-quant-decode at INT2 and with the INT2-g32 MLP), each with the
     reference CLI's INT8 lm_head: exact launch counts, greedy tokens
     against single-request generation, and its metrics;
  8. int8 activations: the a8 instances' registers, spills and shared
     memory, both prefill tiles timed at each projection (M = 1024 and
     256), the w4a8, w8a8 and w2a8 kernels bit for bit against their plain
     versions at the Llama-3-8B projections (M = 1024, 8, 1, 33, 1000) with
     each row's share of the int8 peak beside torch._int_mm's, and the
     chunk kernel's int8-x form (INT2-g32 MLP, INT4-g128) at M = 8, 1, 33,
     with times, bounds and yardsticks;
  9. Mixtral-8x7B MoE: (a) the ragged expert GEMMs (wq_ragged,
     wq_ragged_grouped, wq_ragged_a8) against their plain versions at the
     Mixtral expert shapes, routed from a random router over 1024 tokens
     (one expert without a token, one with nearly all), in INT4 / INT2 /
     INT8, INT4-g128 / INT2-g32 and int8-x INT4 / INT2 under the
     routing's live_blocks (live against padded rows), with times, bounds
     and a torch._grouped_mm yardstick; (b) one full-width MoE layer's
     ragged route against its dense-masked route at 256 tokens; (c) `python
     -m piquant_tpu_torch.serving --random mixtral_8x7b --benchmark 8
     --max-new 32` in process at 4 of its 32 layers, full width (INT4,
     --group-size 128, --act-quant-prefill)
     with exact launch counts, greedy tokens against single-request
     generation, its metrics and peak memory;
 10. NF4 weights and the kv4 cache: (a) nf4_gemv against its plain version
     at the seven Llama-3-8B projections, channelwise and grouped g64 /
     g128, at M = 8, 1, 33 and 64 with bf16 and f32 outputs, with times, bounds
     and a torch.matmul yardstick; (b) the kv4 form of decode_attn2 against
     its plain version on a stacked kv4 cache of Llama-3-8B's geometry
     (ragged positions, a row with no live position, odd positions and
     starts), with an SDPA yardstick; (c) the CLI at full Llama-3-8B width
     (at 4 of its 32 layers since phase 14 came) with `--bits nf4` and
     with `--kv-bits 4`, exact launch counts (7 nf4_gemv or one kv4
     decode_attn2 launch a layer a decode step), greedy tokens against
     single-request generation and its metrics;
 11. model families: (a) the flash kernel's sliding window (Mistral-7B's
     T 6144 and window 4096; a window of 1000 off the 128-key tiles) and GQA
     rep 7 (Qwen2-7B) against its plain version, decode_attn2 kv8 and kv4
     on Mistral-7B's 8192-position cache at window starts past 0 and kv8
     at Qwen2-7B's rep 7, w4_gemv at Qwen2-7B's shapes, each with its
     time, bound and an SDPA or torch.matmul yardstick; (b) `python -m
     piquant_tpu_torch.serving --random <preset> --benchmark 8 --max-new
     32` in process for mistral_7b, qwen2_7b, qwen3_8b and phi3_mini (at 4
     of their layers since phase 13 came), and `--benchmark 4 --max-new 8`
     for qwen3_moe_a3b (at 8 of its 48 layers), at their published widths:
     exact launch counts, greedy
     tokens against single-request generation, metrics and peak memory;
     one full-depth qwen3_moe_a3b decode step profiled; (c) one
     6000-token request on
     Mistral-7B (max_seq_len 8192) prefilled through the windowed flash
     kernel and decoded with window starts past 0 on every layer, its
     tokens against single-request generation, its throughput and peak
     memory;
 12. Gemma: (a) the flash kernel at head_dim 256 at each Gemma preset's
     prefill shapes (Gemma-2-9B's softcap of 50 with its 4096 window at T
     6144 and causal at T 2048, Gemma-3-12B's 1024 window, Gemma-2B's rep
     8, Gemma-7B's rep 1) and its softcap at head_dim 128, decode_attn2 kv8
     and kv4 at head_dim 256 (rep 8, rep 1, and rep 2 with Gemma-3's window
     starts on a 4096-position cache), each against its plain version with
     its time, bound and an SDPA yardstick where SDPA can compute it (not
     under a softcap); (b) `python -m piquant_tpu_torch.serving --random
     <preset> --benchmark 4 --max-new 8` in process for gemma_2b, gemma_7b,
     gemma2_9b and gemma3_12b at their published widths (at 6 of their
     layers since phase 13 came, keeping Gemma-2's and Gemma-3's
     patterns): exact
     launch counts (Gemma-2's decode takes the materialized softcap path,
     no decode_attn2), greedy tokens against single-request generation,
     metrics, a profiled decode window and peak memory; (c) one
     6000-token Gemma-2-9B request (max_seq_len 8192: the windowed softcap
     flash on local layers at T 6016, the causal one on global layers) and
     one 3060-token Gemma-3-12B request (T 3072; decode starts past 0 on
     every local layer, none on the global ones), tokens against
     single-request generation;
 13. Llama-4-Scout and GPT-OSS-20B: (a) the flash kernel's chunk branch
     at Scout's long-request shape (T 9088, chunk 8192, rep 5; pos0 0 and
     4000) and at head_dim 256, and its sinks branch at GPT-OSS's geometry
     with head_dim 128 (alone, with the 128 window, with a chunk, with the
     softcap), each against its plain version with its time, bound and an
     SDPA yardstick where one SDPA call computes it; (b) `python -m
     piquant_tpu_torch.serving --random llama4_scout --benchmark 4
     --max-new 8` in process at full width and depth (exact launches:
     every projection and expert on w4_gemv at decode, the INT8 lm_head
     off the w8_gemv gate), tokens against single-request generation; (c)
     one 9060-token Scout request (T 9088, max_seq_len 10240): 48 flash
     launches, 36 with the 8192 chunk, and decode_attn2 with starts of 8192
     on every chunked layer; (d) `--random gpt_oss_20b --benchmark 4
     --max-new 8` at full width (8 of its 24 layers): head_dim 64 and
     d_model 2880 take no kernel, as the reference routes them, and its
     spies show none;
 14. fused projections and the rest of the engine: (a) mlp_fused against
     its plain version at Llama-3-8B's SwiGLU and Gemma-7B's GeGLU MLPs (M
     8, 1, 33, 64; f32 and bf16 out; two runs bit-equal; no row sums of x
     passed, as the dispatch) with its time, bound and the two-kernel
     route's time at M 8, 1 and 64, decode_attn (the first
     flash-decode kernel) at Llama-3-8B's and the Gemma geometries (ragged
     positions, one dominant key) with its time, bound and an SDPA
     yardstick; (b) the Engine on Llama-3-8B at full width and depth,
     fused params (fuse_layer_projections) under PIQUANT_MLP_FUSE=1,
     PIQUANT_DEFER_APPEND=0 and PIQUANT_TPU_PALLAS_ATTN=1, chunked prefill
     of 256, a 2-entry prefix cache with a preseeded 512-token system
     prompt and auto capture, window buckets (512, 1024, 2048): 12 greedy
     requests, exactly 64 w4_gemv, 32 mlp_fused and 32 decode_attn
     launches a decode step (and in a profiled step one fused-MLP kernel
     a layer, no reduction launched just before it), 8 prefix hits, a
     snapshot after the first
     tick restored into a fresh engine with identical tokens, tokens
     against single-request chunked generation on the same route, one
     decode step's logits against the unfused default route, and the same
     requests on that default route for its metrics; (c) `--random
     llama3_8b --prefill-chunk 256 --attn-windows 512,1024,2048
     --benchmark 8 --max-new 32` in process at 4 layers, full width:
     exact launches, tokens and its metrics;
 15. the mesh, the quantized collectives and the int8 ring: (a) one
     data-parallel all-reduce of Llama-3-8B's w1 gradient (4096 x 14336
     f32 a rank) over 8 ranks stacked on the card
     (`rdma_all_reduce_shard` on a single-process mesh), exact ring_hop /
     ring_gather launches, bit for bit against `ring_plain`, replicas
     identical; quantized_all_reduce and quantized_psum in nearest mode,
     uint8 and uint4, at P = 8 with the quantize / dequantize / min-max
     launches of their hop count, within the reference tests' bounds of
     the f32 sum; (b) ring_hop and ring_gather bit for bit against
     `ring_plain` at P = 2, 4, 8 at the reference tests' shapes and
     `rdma_ring_selftest(rows=256)`, and the w1 all-reduce in the
     process-group form (each rank's hop its own launch) bit for bit
     against the stacked replicas; (c) ring_hop's and ring_gather's times
     in both forms beside their bounds (and fill_ beside the gather), the
     whole call's, the plain versions', the kernels' registers, spills
     and cluster size;
 16. token history, penalties and beam search: Llama-3-8B at full width
     and depth, random INT4 codes, INT8 lm_head, kv8: an Engine with
     track_history serves 8 greedy requests with repetition penalties of
     1.1-1.3, frequency and presence penalties of 0.5, a logit_bias ban
     and min_new_tokens with an eos_token, exact launches, tokens against
     the port's penalized single-request generation; the same prompts
     without history for decode tok/s beside; beam_search with 4 beams
     (sorted hypotheses) and 1 beam (greedy generation's tokens);
 17. speculative decoding and requantize_params: w4_gemv at a verify's M
     = 40 against its plain version, with its times; Llama-3-8B at full
     width and depth, random INT4 codes, INT8 lm_head, kv8, 8 slots,
     decode_block 4, speculate 4: (a) prompt lookup on 8 requests (4
     prompts repeating a 96-token segment, 4 random) against plain greedy
     under the near-tie guard, exact launches, no plain version; (b) an
     INT2 requantize_params draft, then the target as its own draft (at
     least 90% of verify rows emit G + 1, each rejection at a near-tie);
     (c) rejection sampling at temperature 0.9 twice from one seed
     (identical), a top-k slot left to plain decode, the Monte-Carlo
     marginal of rejection_sample_step with a CUDA generator; (d) the
     CLI's --speculate, --draft-bits 2 and --draft-group-size 32 at
     CLI_DEPTH layers;
 18. the loader, the weight cache and GQA reps above 8: decode_attn2 (kv8
     and kv4), decode_attn and flash (causal, a 256 window, sinks) against
     their plain versions at reps 9, 12, 16 and 64 (head_dim 128) at
     Qwen3-235B-A22B's decode (B 8, Hkv 4, S 2048) and prefill (B 8, Hkv
     4, T 1024) geometries, each with its time, bound and SDPA's time; (a)
     Llama-3.1-8B at its published widths (config.json, llama3 rope
     scaling) and 4 of its 32 layers, bf16 weights from the seed written by
     the port as two safetensors shards with their index, read back to the
     card (every tensor, and every loaded leaf against
     params_from_state_dict of the tensors in memory, bit for bit),
     quantized to INT4 on the card, through the weight cache and the
     safetensors export and back (bit for bit), served by the Engine from
     both (identical greedy tokens; against single-request generation
     under the near-tie guard) and through the CLI's `--model DIR --bits 4
     --benchmark 8` (exact launches), with the seconds to write, read (GB/s),
     quantize, save and reload; (b) Qwen3-235B-A22B's geometry (64 query
     heads over 4 kv heads, 128 experts top 8) at 2 of its 94 layers
     through params_from_state_dict on the card, served at INT4 with the
     kv8 cache: flash and decode_attn2 launched at rep 16, tokens under the
     guard;
then one JSON line with the kernels, and a last JSON line
{"ok": true, "device": {...}}.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12      # dense bf16 tensor-core peak
INT8_OP_PER_S = 1979e12       # dense int8 tensor-core peak
F32_FLOP_PER_S = 67e12        # f32 outside the tensor cores
NEAR_TIE = 0.02               # tests/token_guard.py MARGIN


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean DEVICE time of fn(i) over `iters` calls: the calls are captured
    into one CUDA graph and its replay is timed with CUDA events, so the
    host's launch cost (Python wrapper, allocation) is not in the number."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(warmup):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def host_ms(fn, iters: int = 50) -> float:
    """Mean wall time of fn(i) called eagerly, synchronised at the end:
    what one call costs on the main path, launch overhead included."""
    import torch

    fn(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(i)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def copy_bandwidth(torch, dev) -> float:
    """Device-to-device copy rate of a 1 GiB buffer (bytes read + written
    per second): the card's own memory-bandwidth reading."""
    src = torch.empty(2**30, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    ms = cuda_ms(lambda i: dst.copy_(src), 10)
    return 2 * src.numel() / (ms * 1e-3)


def event_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn(i) launched eagerly back to back, between two
    CUDA events: for the PyTorch yardsticks, which need not be capturable
    in a CUDA graph."""
    import torch

    for i in range(warmup):
        fn(i)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float, flop_per_s: float = BF16_FLOP_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_share(ms: float, bnd: float) -> str:
    return f"{100 * bnd / ms:.1f}% of the bound"


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def hold(torch, name, got, want, atol, rtol) -> float:
    """Element by element |got - want| <= atol + rtol |want|, failing on
    any NaN or inf; returns the max abs error."""
    torch.testing.assert_close(got, want, atol=atol, rtol=rtol,
                               msg=lambda m: f"{name} disagrees: {m}")
    return float((got - want).abs().max())


# (K, N, uses per decode layer) of the Llama-3-8B projections
W4_SHAPES = ((4096, 4096, 2), (4096, 1024, 2), (4096, 14336, 2),
             (14336, 4096, 1))
HOLD_M = (8, 1, 33, 64)       # decode batch 8, a lone row, a ragged M, the
                              # largest M the GEMVs take (one block, all rows)


def random_qlin(torch, dev, gen, k, n, bits, gs):
    """Random codes with a scale and zero point of their own per column (and
    per group when grouped), so a kernel that reads another column's or
    group's shows; grouped INT2/INT4 weights carry their chunk-major side
    streams."""
    from piquant_tpu_torch.quant.linear import (QuantizedLinear,
                                                with_grouped_cache)

    g = k // gs if gs else 1
    if bits == "nf4":      # absmax scales a column (and group), no zero point
        data = torch.randint(0, 256, (k // 2, n), generator=gen, device=dev,
                             dtype=torch.uint8)
        scale = (torch.rand((g, n), generator=gen, device=dev) + 0.5) / k ** 0.5
        zp = torch.zeros((g, n), dtype=torch.int32, device=dev)
        return QuantizedLinear(data, scale, zp, 4, k, gs, codebook="nf4")
    data = torch.randint(0, 256, (k * bits // 8, n), generator=gen,
                         device=dev, dtype=torch.uint8)
    scale = ((torch.rand((g, n), generator=gen, device=dev) + 0.5)
             * (2.0 / ((1 << bits) - 1) / k ** 0.5))
    zp = torch.randint(0, 1 << bits, (g, n), generator=gen, device=dev,
                       dtype=torch.int32)
    return with_grouped_cache(QuantizedLinear(data, scale, zp, bits, k, gs))


def gemv_operands(name, ql, x):
    """The operands after x that the dispatch hands wrapper `name`, and the
    side-stream bytes a call reads besides the codes."""
    from piquant_tpu_torch.ops.cuda import qmatmul as Q
    from piquant_tpu_torch.quant.linear import grouped_chunk_factor

    n, gs = ql.n, ql.group_size
    if name == "nf4_gemv":
        if gs is None:
            return (ql.data, ql.scale.reshape(-1), 0), n * 4
        return (ql.data, ql.scale, gs), (ql.k // gs) * n * 4
    if name in ("w4_gemv", "w8_gemv", "w2_gemv"):   # as the dispatch: no xsum
        return ((ql.data, ql.scale.reshape(-1), ql.zero_point.reshape(-1),
                 None), n * 8)
    g = ql.k // gs
    if name == "wg_chunk":
        ch = grouped_chunk_factor(ql.k, gs, Q.PLANES[ql.bits])
        return (ql.data, ql.s_chunk, ql.z_chunk, gs, ch), g * n * 3
    return (ql.data, ql.scale, ql.zero_point, gs), g * n * 8


def check_gemv(torch, dev, gen, name, bits, gs, shapes, out_dtype,
               a8=False, hold_f32=False, hold_m=HOLD_M, m_timed=8):
    """Wrapper `name` against its plain version at each (K, N) of `shapes`
    and M in `hold_m` (with hold_f32 at f32 output as well); then its device
    ms at M = `m_timed` summed over the shapes'
    uses (enough weights that the loop streams from HBM, not L2), the plain
    version's, a torch.matmul against the bf16-dequantized weight, the host
    cost of an eager call, and the bound.  a8: x is the per-token int8 of a
    bf16 x with its row scales (the chunk kernel's int8-x form)."""
    from piquant_tpu_torch.ops.cuda import qmatmul as Q
    from piquant_tpu_torch.quant.linear import _quantize_act

    kern, plain = getattr(Q, name), getattr(Q, name + "_plain")
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, eager_ms=0.0,
               nbytes=0.0, flops=0.0)
    err = 0.0
    obytes = 2 if out_dtype == torch.bfloat16 else 4
    wbits = 4 if bits == "nf4" else bits
    hold_dtypes = (out_dtype, torch.float32) if hold_f32 else (out_dtype,)

    def inputs(m, k):
        """(x the wrapper takes, trailing arguments, bf16 x)."""
        xb = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        if not a8:
            return xb, (), xb
        xq, xs = _quantize_act(xb)
        return xq, (xs,), xb

    for k, n, uses in shapes:
        copies = max(1, -(-256 * 2**20 // (k * n * wbits // 8)))
        qls = [random_qlin(torch, dev, gen, k, n, bits, gs)
               for _ in range(copies)]
        for m in hold_m:
            x, extra, _ = inputs(m, k)
            ops, _ = gemv_operands(name, qls[0], x)
            # atol 2e-2, rtol 1e-2: the quantized_matmul bound of the JAX
            # tests (f32 sums in another order, one bf16 output rounding)
            for odt in hold_dtypes:
                e = hold(torch, f"{name} K={k} N={n} M={m} {odt}",
                         kern(x, *ops, odt, *extra).float(),
                         plain(x, *ops, odt, *extra).float(), 2e-2, 1e-2)
                err = max(err, e)
        print(f"{name} K={k} N={n}: max_abs_err {err:.3e} at M {hold_m}",
              flush=True)
        x, extra, xb = inputs(m_timed, k)
        ops = [gemv_operands(name, ql, x) for ql in qls]
        side = ops[0][1]
        call = lambda i: kern(x, *ops[i % copies][0], out_dtype,  # noqa: E731
                              *extra)
        t_k = cuda_ms(call, 50)
        tot["eager_ms"] += uses * host_ms(call)
        # eagerly between events: a plain version may copy from the host
        t_p = event_ms(lambda i: plain(x, *ops[i % copies][0], out_dtype,
                                       *extra), 5)
        w_bf16 = [ql.dequantize(torch.bfloat16) for ql in qls[:2]]
        t_l = cuda_ms(lambda i: torch.matmul(xb, w_bf16[i % len(w_bf16)]), 20)
        print(f"{name} K={k} N={n}: kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
              f"torch.matmul(bf16 W) {t_l:.4f} ms", flush=True)
        tot["ms"] += uses * t_k
        tot["plain_ms"] += uses * t_p
        tot["library_ms"] += uses * t_l
        mt = m_timed
        xbytes = mt * k + mt * 4 if a8 else mt * k * 2
        tot["nbytes"] += uses * (k * n * wbits / 8 + side + xbytes
                                 + mt * n * obytes)
        tot["flops"] += uses * 2 * mt * k * n
        del qls, ops, w_bf16
    b, by = bound_ms(tot["nbytes"], tot["flops"])
    return dict(max_abs_err=err, ms=tot["ms"], plain_ms=tot["plain_ms"],
                bound_ms=b, bound_by=by, library_ms=tot["library_ms"],
                library_call="torch.matmul (bf16 dequantized W)",
                eager_ms=tot["eager_ms"])


def gemv_attributes(torch) -> str:
    """Registers, local (spill) bytes, dynamic shared memory, ring stages
    and packed rows a stage of each instance of csrc/qmatmul_gemv.cu
    (cudaFuncGetAttributes): ten forms at 1, 2, 4 and 8 n8 token tiles, the
    grouped ones at group size 128."""
    from piquant_tpu_torch.ops.cuda import qmatmul as Q

    parts = []
    for form, tag in enumerate(Q.GEMV_FORMS):
        for mt in (1, 2, 4, 8):
            a = Q.gemv_attributes(form, mt, 128)
            parts.append(f"{tag} M<={8 * mt}: {a[0]} registers, {a[1]} B "
                         f"local, {a[2]} B shared, {a[3]} stages of {a[5]} "
                         f"rows")
    return "; ".join(parts)


def gemv_row(torch, dev, gen, name, replaces, timed, bits, gs, shapes,
             out_dtype, hold_f32=False):
    """The kernels-line row of GEMV wrapper `name` (see check_gemv)."""
    res = check_gemv(torch, dev, gen, name, bits, gs, shapes, out_dtype,
                     hold_f32=hold_f32)
    print(f"{name}: kernel {res['ms']:.4f} ms, bound {res['bound_ms']:.4f} ms "
          f"({res['bound_by']}), plain {res['plain_ms']:.4f} ms, torch.matmul "
          f"{res['library_ms']:.4f} ms, eager {res['eager_ms']:.4f} ms "
          f"[{timed}; {card_line()}]", flush=True)
    return dict(name=name, route="cuda",
                source="piquant_tpu_torch/csrc/qmatmul_gemv.cu",
                replaces=f"piquant_tpu/ops/pallas/qmatmul.py:{replaces}",
                timed=timed, **res)


def check_decode_attn2(torch, dev, gen):
    import torch.nn.functional as F

    from piquant_tpu_torch.ops.cuda import decode_attn2 as DA

    nl, b, hkv, rep, s, d = 32, 8, 8, 4, 2048, 128
    shape = (nl, b, hkv, s, d)
    kc = torch.randint(-127, 128, shape, generator=gen, device=dev,
                       dtype=torch.int8)
    vc = torch.randint(-127, 128, shape, generator=gen, device=dev,
                       dtype=torch.int8)
    ks = torch.rand(shape[:-1] + (1,), generator=gen, device=dev) * 0.02
    vs = torch.rand(shape[:-1] + (1,), generator=gen, device=dev) * 0.02
    q = torch.randn((b, hkv, rep, d), generator=gen, device=dev).to(torch.bfloat16)
    pos = torch.tensor([0, 300, 2047, 1000, 1500, 511, 273, 1800],
                       dtype=torch.int32, device=dev)
    start = torch.tensor([0, 0, 0, 0, 1100, 0, 0, 0], dtype=torch.int32,
                         device=dev)
    sm = d ** -0.5
    err = 0.0
    for layer in (0, 17, 31):
        acc, m, l = DA.decode_attn2(q, kc, ks, vc, vs, pos, start, sm, layer)
        pacc, pm, pl = DA.decode_attn2_plain(q, kc, ks, vc, vs, pos, start,
                                             sm, layer)
        torch.cuda.synchronize()
        if not (bool((m[0] == -1e30).all()) and bool((l[0] == 0).all())
                and bool((acc[0] == 0).all())):
            raise AssertionError("decode_attn2: pos=0 row lost the sentinel")
        # m to f32 rounding; l within 2e-2 and the normalized context within
        # atol 2e-3, rtol 2e-2: bf16 probabilities before the PV product at
        # other running maxima in the two
        name = f"decode_attn2 layer {layer}"
        hold(torch, name + " m", m, pm, 1e-5, 1e-5)
        hold(torch, name + " l", l, pl, 0.0, 2e-2)
        e = hold(torch, name + " context", acc[1:] / l[1:],
                 pacc[1:] / pl[1:], 2e-3, 2e-2)
        err = max(err, e)
    print(f"decode_attn2: max_abs_err (normalized context) {err:.3e}",
          flush=True)
    call = lambda i: DA.decode_attn2(q, kc, ks, vc, vs, pos, start,  # noqa: E731
                                     sm, i % nl)
    t_k = cuda_ms(call, 64)
    t_e = host_ms(call)
    t_p = cuda_ms(lambda i: DA.decode_attn2_plain(q, kc, ks, vc, vs, pos,
                                                  start, sm, i % nl), 4)
    # yardstick: SDPA over a pre-dequantized bf16 cache of one layer
    kf = (kc[5].float() * ks[5]).to(torch.bfloat16)
    vf = (vc[5].float() * vs[5]).to(torch.bfloat16)
    idx = torch.arange(s, device=dev)
    mask = ((idx[None] >= start[:, None]) & (idx[None] < pos[:, None])
            | (idx[None] == 0))[:, None, None, :]   # keep row 0 defined
    q4 = q.reshape(b, hkv * rep, 1, d)
    t_l = cuda_ms(lambda i: F.scaled_dot_product_attention(
        q4, kf, vf, attn_mask=mask, enable_gqa=True), 20)
    live_pos = float((pos - start).clamp(min=0).sum())
    nbytes = (live_pos * hkv * (2 * d + 2 * 4) + q.numel() * 2
              + b * hkv * rep * (d + 2) * 4)
    bnd, by = bound_ms(nbytes, 4 * live_pos * rep * hkv * d)
    print(f"decode_attn2: kernel {t_k:.4f} ms ({bound_share(t_k, bnd)} "
          f"{bnd:.4f} ms, {by}), sdpa(bf16 cache) {t_l:.4f} ms, plain "
          f"{t_p:.4f} ms, live positions {live_pos:.0f} [{card_line()}]",
          flush=True)
    print(f"decode_attn2 instances: {decode_attributes(torch)}", flush=True)
    del kc, vc, ks, vs, kf, vf
    return dict(name="decode_attn2", route="cuda",
                source="piquant_tpu_torch/csrc/decode_attn2.cu",
                replaces="piquant_tpu/ops/pallas/decode_attn2.py:76 (_kernel, "
                         "kv8)",
                max_abs_err=err, ms=t_k, plain_ms=t_p, bound_ms=bnd,
                bound_by=by, library_ms=t_l, eager_ms=t_e,
                timed="one layer: B=8, Hkv=8, rep=4, S=2048, mixed positions")


def decode_attributes(torch) -> str:
    """Registers, local (spill) bytes, dynamic shared memory (rep 8, 16
    tiles a split) and ring stages of the six decode_attn2_kernel
    instances (cudaFuncGetAttributes)."""
    import ctypes

    from piquant_tpu_torch.ops.cuda import _build

    parts = []
    for d in (128, 256):
        for form, tag in ((0, "kv8"), (1, "kv4"), (2, "v1")):
            a = (ctypes.c_int * 4)()
            _build.check(_build.library().pq_decode_attn2_attributes(
                d, form, a), "pq_decode_attn2_attributes")
            parts.append(f"D={d} {tag}: {a[0]} registers, {a[1]} B local, "
                         f"{a[2]} B shared, {a[3]} stages")
    return "; ".join(parts)


def flash_rate(flops: float, ms: float, bnd: float) -> str:
    """A flash time's achieved rate over the live pairs and its share of
    the bound."""
    return (f"{flops / (ms * 1e9):.1f} TFLOP/s, {100 * bnd / ms:.1f}% of "
            "the bound")


def flash_attributes(torch) -> str:
    """Registers, local (spill) bytes, dynamic shared memory and K/V
    stages of each of the 24 flash_prefill_kernel instances
    (cudaFuncGetAttributes)."""
    import ctypes

    from piquant_tpu_torch.ops.cuda import _build

    parts = []
    for d in (128, 256):
        for mode, tag in ((0, "causal"), (1, "window"), (2, "chunk")):
            for cap in (0, 1):
                for snk in (0, 1):
                    a = (ctypes.c_int * 4)()
                    _build.check(_build.library().pq_flash_attributes(
                        d, mode, cap, snk, a), "pq_flash_attributes")
                    parts.append(
                        f"D={d} {tag}{' softcap' if cap else ''}"
                        f"{' sinks' if snk else ''}: {a[0]} registers, "
                        f"{a[1]} B local, {a[2]} B shared, {a[3]} stages")
    return "; ".join(parts)


def check_flash(torch, dev, gen):
    import torch.nn.functional as F

    from piquant_tpu_torch.ops.cuda import flash as FL

    b, hkv, rep, t, d = 8, 8, 4, 1024, 128
    q = torch.randn((b, hkv, rep, t, d), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((b, hkv, t, d), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((b, hkv, t, d), generator=gen, device=dev).to(torch.bfloat16)
    sm = d ** -0.5
    got = FL.flash_attn(q, k, v, sm)
    want = FL.flash_attn_plain(q, k, v, sm)
    # element by element, atol 2e-3, rtol 2e-2: bf16 probabilities before
    # the PV product in both, at running maxima of another tile order
    err = hold(torch, "flash_prefill", got, want, 2e-3, 2e-2)
    print(f"flash_prefill: max_abs_err {err:.3e}", flush=True)
    # a ragged T is masked by the kernel itself
    tr = 200
    e_r = hold(torch, "flash_prefill at ragged T",
               FL.flash_attn(q[:1, :, :, :tr], k[:1, :, :tr], v[:1, :, :tr],
                             sm),
               FL.flash_attn_plain(q[:1, :, :, :tr], k[:1, :, :tr],
                                   v[:1, :, :tr], sm), 2e-3, 2e-2)
    print(f"flash_prefill T={tr}: max_abs_err {e_r:.3e}", flush=True)
    err = max(err, e_r)
    del got, want
    t_k = cuda_ms(lambda i: FL.flash_attn(q, k, v, sm), 10)
    t_e = host_ms(lambda i: FL.flash_attn(q, k, v, sm), 10)
    t_p = cuda_ms(lambda i: FL.flash_attn_plain(q, k, v, sm), 2, warmup=1)
    q4 = q.reshape(b, hkv * rep, t, d)
    t_l = cuda_ms(lambda i: F.scaled_dot_product_attention(
        q4, k, v, is_causal=True, enable_gqa=True), 10)
    flops = 4.0 * d * (t * (t + 1) / 2) * b * hkv * rep
    nbytes = q.numel() * 2 + 2 * k.numel() * 2 + q.numel() * 4
    bnd, by = bound_ms(nbytes, flops)
    print(f"flash_prefill: kernel {t_k:.4f} ms ({flash_rate(flops, t_k, bnd)}"
          f"), bound {bnd:.4f} ms ({by}), plain {t_p:.4f} ms, "
          f"sdpa(causal, gqa) {t_l:.4f} ms [{card_line()}]", flush=True)
    print(f"flash_prefill instances: {flash_attributes(torch)}", flush=True)
    return dict(name="flash_prefill", route="cuda",
                source="piquant_tpu_torch/csrc/flash.cu",
                replaces="piquant_tpu/ops/pallas/flash.py:57 (_kernel; also "
                         "the JAX-shipped causal kernel called at "
                         "piquant_tpu/ops/flash_prefill.py:77)",
                max_abs_err=err, ms=t_k, plain_ms=t_p, bound_ms=bnd,
                bound_by=by, library_ms=t_l, eager_ms=t_e,
                tflops=flops / (t_k * 1e9), bound_share=bnd / t_k,
                timed="one layer: B=8, T=1024, Hkv=8, rep=4")


# ---------------------------------------------------------------------------
# phase 4: the library core
# ---------------------------------------------------------------------------

LIB_N = 27_264_000            # bench.py's protocol: f32 -> uint8 at this numel
LIB_CODES = ("uint8", "int8", "uint16", "int16", "uint4", "int4", "uint2")
# ties, the f32 add that rounds 0.49999997 + 0.5 up to 1, NaN, +-inf,
# values past int32, a denormal and -0
EDGE = (0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 0.49999997, -0.49999997,
        float("nan"), float("inf"), float("-inf"), 3e9, -3e9, 1e-45, -0.0,
        7.5, -7.5, 128.5, -128.5)


def kernel_wrappers():
    """Every kernel wrapper by its name in the kernels line; each counts its
    launches in `.launches`."""
    from piquant_tpu_torch.ops.cuda import attention as AT
    from piquant_tpu_torch.ops.cuda import decode_attn2 as DA
    from piquant_tpu_torch.ops.cuda import dequantize as DQ
    from piquant_tpu_torch.ops.cuda import flash as FL
    from piquant_tpu_torch.ops.cuda import minmax as MM
    from piquant_tpu_torch.ops.cuda import qmatmul as Q
    from piquant_tpu_torch.ops.cuda import quantize as QK
    from piquant_tpu_torch.ops.cuda import ragged as R
    from piquant_tpu_torch.ops.cuda import requantize as RQ
    from piquant_tpu_torch.ops.cuda import ring as RG

    return {"w4_gemv": Q.w4_gemv, "decode_attn2": DA.decode_attn2,
            "flash_prefill": FL.flash_attn, "quantize": QK.quantize,
            "dequantize": DQ.dequantize, "requantize": RQ.requantize,
            "min_max": MM.min_max, "w8_gemv": Q.w8_gemv,
            "w2_gemv": Q.w2_gemv, "wg_chunk": Q.wg_chunk,
            "w4_grouped": Q.w4_grouped, "w4a8": Q.w4a8, "w8a8": Q.w8a8,
            "w2a8": Q.w2a8, "wq_ragged": R.wq_ragged,
            "wq_ragged_grouped": R.wq_ragged_grouped,
            "wq_ragged_a8": R.wq_ragged_a8, "nf4_gemv": Q.nf4_gemv,
            "decode_attn2_kv4": DA.decode_attn2_kv4,
            "mlp_fused": Q.mlp_fused, "decode_attn": AT.decode_attn,
            "ring_hop": RG.ring_hop, "ring_gather": RG.ring_gather}


def zero_counts() -> None:
    """Set every wrapper's launch count to 0 (just before a path runs)."""
    for fn in kernel_wrappers().values():
        fn.launches = 0


def same(torch, name, got, want, equal_nan=False) -> float:
    """Bit for bit: floats by assert_close at atol = rtol = 0 (which fails
    on NaN unless asked not to), codes by torch.equal on their bits.
    Returns the max abs difference, measured before the check (0 when it
    passes; equal infinities and, with equal_nan, NaN pairs count 0)."""
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{name}: {got.dtype}{tuple(got.shape)} against "
                             f"{want.dtype}{tuple(want.shape)}")
    if got.dtype.is_floating_point:
        g, w = got.double(), want.double()
        d = torch.where((g == w) | (g.isnan() & w.isnan()), 0.0,
                        (g - w).abs())
        err = float(d.max()) if d.numel() else 0.0
        torch.testing.assert_close(got, want, atol=0, rtol=0,
                                   equal_nan=equal_nan,
                                   msg=lambda m: f"{name} disagrees: {m}")
        return err
    if got.dtype == torch.uint16:    # no comparison kernels for uint16
        got, want = got.view(torch.int16), want.view(torch.int16)
        g, w = got.int() & 0xFFFF, want.int() & 0xFFFF
    else:
        g, w = got.int(), want.int()
    err = float((g - w).abs().max()) if g.numel() else 0.0
    if not torch.equal(got, want):
        bad = int((got != want).sum())
        raise AssertionError(f"{name}: {bad} codes differ")
    return err


def check_library(torch, dev, gen, n_full):
    """Every library-core kernel bit for bit against its plain version on
    the card: f32/bf16 x the seven kernel code types, nearest and
    stochastic, SET and ADD, at n_full and n_full + 77 elements, with the
    edge values at the head of the vector and a device-resident scale and
    zero point; the edge vector alone at host scale 1; min/max with and
    without a NaN.  Returns the max abs error per kernel."""
    from piquant_tpu_torch.dtypes import DTYPES
    from piquant_tpu_torch.ops import reference as ref
    from piquant_tpu_torch.ops.cuda import dequantize as DQ
    from piquant_tpu_torch.ops.cuda import minmax as MM
    from piquant_tpu_torch.ops.cuda import quantize as QK
    from piquant_tpu_torch.ops.cuda import requantize as RQ

    checks = dict.fromkeys(("quantize", "dequantize", "requantize",
                            "min_max"), 0)
    errs = dict.fromkeys(checks, 0.0)

    def hold(kernel, name, got, want, equal_nan=False):
        e = same(torch, f"{kernel} {name}", got, want, equal_nan)
        checks[kernel] += 1
        errs[kernel] = max(errs[kernel], e)

    f32, bf16 = DTYPES["f32"], DTYPES["bf16"]
    edge = torch.tensor(EDGE, device=dev)
    for fd in (torch.float32, torch.bfloat16):
        e = edge.to(fd)
        for qn in LIB_CODES:
            dt = DTYPES[qn]
            for zp in (7, -5):
                for st in (False, True):
                    name = f"edge {fd} -> {qn} zp {zp} stochastic {st}"
                    hold("quantize", name, QK.quantize(e, 1.0, zp, dt, st, 11),
                         QK.quantize_plain(e, 1.0, zp, dt, st, 11))
                    hold("requantize", name,
                         RQ.requantize(e, 1.0, zp, dt, st, 11),
                         RQ.requantize_plain(e, 1.0, zp, dt, st, 11))
    for n in (n_full, n_full + 77):
        clean = torch.rand(n, generator=gen, device=dev) * 8 - 3
        for fd in (torch.float32, torch.bfloat16):
            xc = clean.to(fd)
            got = MM.min_max(xc)
            hold("min_max", f"{fd} n={n}", got, MM.min_max_plain(xc))
            xn = xc.clone()
            xn[n // 3] = float("nan")
            got_n = MM.min_max(xn)
            if not bool(got_n.isnan().all()):
                raise AssertionError("min_max dropped a NaN")
            hold("min_max", f"{fd} NaN n={n}", got_n, MM.min_max_plain(xn),
                 equal_nan=True)
            x = xc.clone()
            x[:len(EDGE)] = edge.to(fd)
            for qn in LIB_CODES:
                dt = DTYPES[qn]
                scale, zp = ref.params_from_min_max(got[0], got[1], dt)
                for st in (False, True):
                    name = f"{fd} -> {qn} n={n} stochastic {st}"
                    codes = QK.quantize(x, scale, zp, dt, st, n)
                    hold("quantize", name, codes,
                         QK.quantize_plain(x, scale, zp, dt, st, n))
                    for add in (False, True):
                        # two copies of one accumulator: ADD is in place
                        acc, acc2 = ((clean.to(fd, copy=True),
                                      clean.to(fd, copy=True)) if add
                                     else (None, None))
                        hold("requantize", f"{name} add {add}",
                             RQ.requantize(x, scale, zp, dt, st, n, acc),
                             RQ.requantize_plain(x, scale, zp, dt, st, n,
                                                 acc2))
                    if fd != torch.float32:
                        continue
                    for odt in (f32, bf16):
                        for add in (False, True):
                            acc, acc2 = ((clean.to(odt.storage, copy=True),
                                          clean.to(odt.storage, copy=True))
                                         if add else (None, None))
                            hold("dequantize", f"{qn} -> {odt.name} n={n} "
                                 f"stochastic {st} add {add}",
                                 DQ.dequantize(codes, n, scale, zp, dt, odt,
                                               acc),
                                 DQ.dequantize_plain(codes, n, scale, zp, dt,
                                                     odt, acc2))
    torch.cuda.synchronize()
    print(f"library: bit for bit against the plain versions, checks "
          f"{checks}, max abs error {errs}", flush=True)
    return errs


def run_library(torch, dev, gen, n, seed):
    """The public API end to end at numel n on f32 input, the path a user
    calls: compute_quant_params -> quantize -> dequantize (SET, then ADD
    into a second buffer); requantize nearest and stochastic;
    quantize_tensor -> dequantize_tensor for uint4.  Returns the launches of
    the library kernels in this run."""
    import piquant_tpu_torch as pq
    from piquant_tpu_torch.ops import reference as ref

    x = torch.rand(n, generator=gen, device=dev) * 8 - 3
    torch.cuda.synchronize()
    zero_counts()
    scale, zp = pq.compute_quant_params(x, "uint8")
    q = pq.quantize(x, scale, zp, "uint8")
    dq = pq.dequantize(q, scale, zp, "uint8")
    acc = torch.ones(n, device=dev)
    pq.dequantize(q, scale, zp, "uint8", reduce_op="add", out=acc)
    fq = pq.requantize(x, scale, zp, "uint8")
    fqs = pq.requantize(x, scale, zp, "uint8", "stochastic",
                        generator=torch.Generator().manual_seed(seed))
    qt = pq.quantize_tensor(x, "uint4")
    dq4 = pq.dequantize_tensor(qt)
    torch.cuda.synchronize()
    expect = {"quantize": 2, "dequantize": 3, "requantize": 2, "min_max": 2}
    launches = {k: kernel_wrappers()[k].launches for k in expect}
    print(f"library: API run at numel {n}, launches {launches}, expected "
          f"{expect}", flush=True)
    if launches != expect:
        raise AssertionError(f"library launches {launches} != {expect}")

    # the parameters are the reference's formula on the data's min and max
    ws, wz = ref.params_from_min_max(x.amin(), x.amax(), "uint8")
    same(torch, "compute_quant_params scale", scale, ws)
    same(torch, "compute_quant_params zero point", zp, wz)
    if q.shape != (n,) or q.dtype != torch.uint8:
        raise AssertionError(f"quantize gave {q.dtype}{tuple(q.shape)}")
    for name, y in (("dequantize", dq), ("requantize", fq), ("uint4", dq4),
                    ("requantize stochastic", fqs)):
        if y.shape != (n,) or not bool(torch.isfinite(y).all()):
            raise AssertionError(f"{name}: non-finite or misshapen output")
    # nearest: within half a step of the input (the data lies inside
    # [rmin, rmax], so nothing clips), plus the f32 roundings of x / scale
    # and of the product
    s = float(scale)
    slack = x.abs() * 2.0 ** -21
    for name, y, st in (("uint8", dq, s), ("uint4", dq4, float(qt.scale))):
        if not bool(((x - y).abs() <= st * 0.5 * (1 + 2.0 ** -20) + slack)
                    .all()):
            raise AssertionError(f"{name}: |x - dq| above scale / 2")
    same(torch, "requantize == dequantize(quantize)", fq, dq)
    same(torch, "dequantize ADD == 1 + dequantize", acc, 1 + dq)
    err = fqs - x
    if not bool((err.abs() <= s * (1 + 2.0 ** -20) + slack).all()):
        raise AssertionError("stochastic requantize: more than a step off")
    bias = float(err.mean())
    if abs(bias) > 6 * s / (2 * n ** 0.5):
        raise AssertionError(f"stochastic requantize biased: {bias}")
    if qt.data.numel() != -(-n // 2):
        raise AssertionError(f"uint4: {qt.data.numel()} bytes for {n} codes")
    print(f"library: scale {s:.9g} zp {int(zp)}, max |x - dq| "
          f"{float((x - dq).abs().max()):.6g} (scale / 2 = {s / 2:.6g}), "
          f"stochastic mean error {bias:.3e}", flush=True)
    return launches


LIB_SMALL_N = 1_048_576       # the quantized collectives' calls


def time_library(torch, dev, gen, n, errs):
    """Device ms of each library kernel at numel n (f32 input, uint8 codes)
    by CUDA-graph replay and, as the yardstick is timed, by events around
    eager launches (`event_ms`); its plain version, its host cost per eager
    call, and one PyTorch call computing the same function as a yardstick
    (never used by the port)."""
    from piquant_tpu_torch.dtypes import DTYPES
    from piquant_tpu_torch.ops import reference as ref
    from piquant_tpu_torch.ops.cuda import dequantize as DQ
    from piquant_tpu_torch.ops.cuda import minmax as MM
    from piquant_tpu_torch.ops.cuda import quantize as QK
    from piquant_tpu_torch.ops.cuda import requantize as RQ

    u8, u4, f32 = DTYPES["uint8"], DTYPES["uint4"], DTYPES["f32"]
    x = torch.rand(n, generator=gen, device=dev) * 8 - 3
    mm = MM.min_max_plain(x)
    scale, zp = ref.params_from_min_max(mm[0], mm[1], u8)
    sf, zi = float(scale), int(zp)
    codes = QK.quantize(x, scale, zp, u8)
    acc = torch.zeros(n, device=dev)
    qx = torch.quantize_per_tensor(x, sf, zi, torch.quint8)
    card = card_line()
    rows = []

    def row(name, source, replaces, call, plain, lib, lib_name, nbytes, ops,
            timed):
        t_k = cuda_ms(call, 50)
        t_ke = event_ms(call, 50)
        t_e = host_ms(call)
        t_p = cuda_ms(plain, 5)
        t_l = event_ms(lib, 50)
        b, by = bound_ms(nbytes, ops * n, F32_FLOP_PER_S)
        print(f"{name}: kernel {t_k:.4f} ms (events {t_ke:.4f} ms), bound "
              f"{b:.4f} ms ({by}), plain {t_p:.4f} ms, {lib_name} {t_l:.4f} "
              f"ms (events), eager {t_e:.4f} ms [{timed}; {card}]",
              flush=True)
        rows.append(dict(name=name, route="cuda",
                         source=f"piquant_tpu_torch/csrc/{source}",
                         replaces=replaces, max_abs_err=errs[name], ms=t_k,
                         event_ms=t_ke, plain_ms=t_p, bound_ms=b,
                         bound_by=by, library_ms=t_l, library_call=lib_name,
                         eager_ms=t_e, timed=timed))
        return t_k

    row("quantize", "quantize.cu",
        "piquant_tpu/ops/pallas/quantize.py:51 (_direct_kernel), "
        "piquant_tpu/ops/pallas/quantize.py:82 (_mxu_pack_kernel)",
        lambda i: QK.quantize(x, scale, zp, u8),
        lambda i: QK.quantize_plain(x, scale, zp, u8),
        lambda i: torch.quantize_per_tensor(x, sf, zi, torch.quint8),
        "torch.quantize_per_tensor (half to even)", 5.0 * n, 6,
        f"f32 -> uint8, numel {n}")

    def variant(tag, call, plain, nbytes):
        """Another path of the last row's kernel: its ms (graph replay and
        events), plain ms, bound."""
        t_k = cuda_ms(call, 50)
        t_ke = event_ms(call, 50)
        t_p = cuda_ms(plain, 5)
        b, _ = bound_ms(nbytes, 0)
        print(f"{rows[-1]['name']} {tag}: kernel {t_k:.4f} ms (events "
              f"{t_ke:.4f} ms), bound {b:.4f} ms, plain {t_p:.4f} ms "
              f"[{card}]", flush=True)
        rows[-1].setdefault("variants", {})[tag] = dict(
            ms=t_k, event_ms=t_ke, plain_ms=t_p, bound_ms=b)

    variant("f32 -> uint4", lambda i: QK.quantize(x, scale, zp, u4),
            lambda i: QK.quantize_plain(x, scale, zp, u4), 4.5 * n)
    codes4 = QK.quantize(x, scale, zp, u4)
    row("dequantize", "dequantize.cu",
        "piquant_tpu/ops/pallas/dequantize.py:39 (_direct_kernel), "
        "piquant_tpu/ops/pallas/dequantize.py:76 (_mxu_unpack_kernel)",
        lambda i: DQ.dequantize(codes, n, scale, zp, u8, f32),
        lambda i: DQ.dequantize_plain(codes, n, scale, zp, u8, f32),
        lambda i: torch.dequantize(qx), "torch.dequantize (quint8)",
        5.0 * n, 2, f"uint8 -> f32 SET, numel {n}")
    variant("uint8 -> f32 ADD",
            lambda i: DQ.dequantize(codes, n, scale, zp, u8, f32, acc),
            lambda i: DQ.dequantize_plain(codes, n, scale, zp, u8, f32, acc),
            9.0 * n)
    variant("uint4 -> f32 SET",
            lambda i: DQ.dequantize(codes4, n, scale, zp, u4, f32),
            lambda i: DQ.dequantize_plain(codes4, n, scale, zp, u4, f32),
            4.5 * n)
    ns = min(n, LIB_SMALL_N)
    small = codes[:ns]
    variant(f"uint8 -> f32 SET numel {ns}",
            lambda i: DQ.dequantize(small, ns, scale, zp, u8, f32),
            lambda i: DQ.dequantize_plain(small, ns, scale, zp, u8, f32),
            5.0 * ns)
    row("requantize", "requantize.cu",
        "piquant_tpu/ops/pallas/requantize.py:34 (_requant_kernel)",
        lambda i: RQ.requantize(x, scale, zp, u8),
        lambda i: RQ.requantize_plain(x, scale, zp, u8),
        lambda i: torch.fake_quantize_per_tensor_affine(x, sf, zi, 0, 255),
        "torch.fake_quantize_per_tensor_affine", 8.0 * n, 8,
        f"f32 uint8 SET, numel {n}")
    row("min_max", "minmax.cu",
        "piquant_tpu/ops/pallas/minmax.py:29 (_minmax_kernel)",
        lambda i: MM.min_max(x), lambda i: MM.min_max_plain(x),
        lambda i: torch.aminmax(x), "torch.aminmax", 4.0 * n, 2,
        f"f32, numel {n}")
    del qx
    return rows


# ---------------------------------------------------------------------------
# phase 5: the engine at full Llama-3-8B width
# ---------------------------------------------------------------------------

def chunk_starts(plen: int, chunk: int, max_len: int):
    """The engine's chunk starts of a prompt prefilled from 0: steps of
    `chunk`, the last shifted back to end at max_len at most."""
    starts = list(range(0, plen, chunk))
    if starts[-1] + chunk > max_len:
        starts[-1] = max_len - chunk
    return starts


def generate_single(torch, M, cfg, params, prompt, n_new, dev, width=None,
                    max_len=None, chunk=None, keep=None):
    """The port's own single-request greedy prefill + decode; with `width`
    the prompt is right-padded to it and prefilled into a cache of
    `max_len` positions, as the engine runs a request admitted alone; with
    `chunk` it is prefilled in the engine's chunks against a cache of
    `max_len` positions.  Returns the tokens and, for each, the top-2
    margin of the logits that chose it (and appends those logits, f32
    [V], to the list `keep`)."""
    toks = list(prompt) + [0] * ((width or len(prompt)) - len(prompt))
    max_len = max_len or len(prompt) + n_new
    if cfg.kv_bits == 4:
        max_len += max_len % 2     # whole pair rows
    cache = M.init_kv_cache(cfg, 1, max_len=max_len, device=dev)
    if chunk:
        starts = chunk_starts(len(prompt), chunk, max_len)
        for s in starts:
            part = list(prompt[s:s + chunk])
            final = s == starts[-1]
            logits, _ = M.forward(
                cfg, params,
                torch.tensor([part + [0] * (chunk - len(part))], device=dev,
                             dtype=torch.int32),
                positions=s + torch.arange(chunk, device=dev,
                                           dtype=torch.int32)[None],
                cache=cache, kv_write_start=s,
                logit_positions=torch.tensor(
                    [len(prompt) - 1 - s if final else 0], device=dev,
                    dtype=torch.int32))
        logits = logits[:, 0]
    else:
        logits, cache = M.prefill(
            cfg, params, torch.tensor([toks], device=dev, dtype=torch.int32),
            cache, last_positions=torch.tensor([len(prompt) - 1], device=dev,
                                               dtype=torch.int32))
    toks, margins = [], []
    pos = len(prompt)
    while True:
        top = logits[0].float().topk(2)
        if keep is not None:
            keep.append(logits[0].float())
        toks.append(int(top.indices[0]))
        margins.append(float(top.values[0] - top.values[1]))
        if len(toks) == n_new:
            return toks, margins
        logits, cache = M.decode_step(
            cfg, params,
            torch.tensor([toks[-1]], device=dev, dtype=torch.int32),
            torch.tensor([pos], device=dev, dtype=torch.int32), cache)
        pos += 1


def bf16_ulp(x: float) -> float:
    """The spacing of bf16 numbers at |x| (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7) if x else 0.0


def locate_fork(torch, M, cfg, params, prompt, n_new, dev, width, max_len,
                rows):
    """Where single-request decode parts from the same request decoded in
    every one of `rows` rows, as the engine's slots decode it.  Both run
    in lockstep from one prefill, each on its own greedy tokens, with row
    0 of every `_mm` (each projection, the lm_head), `rms_norm` and
    `_attention` output recorded, and of each channelwise GEMV's input row
    sum (`xsum`) and output; returns a line naming the first step and call
    whose values differ and, at the first step whose tokens differ, both
    runs' top-2 margins, the top logit and its bf16 ulp."""
    from piquant_tpu_torch.ops.cuda import qmatmul as Q

    toks = list(prompt) + [0] * (width - len(prompt))
    max_len += max_len % 2 if cfg.kv_bits == 4 else 0
    one = M.init_kv_cache(cfg, 1, max_len=max_len, device=dev)
    logits, one = M.prefill(
        cfg, params, torch.tensor([toks], device=dev, dtype=torch.int32),
        one, last_positions=torch.tensor([len(prompt) - 1], device=dev,
                                         dtype=torch.int32))
    many = M.init_kv_cache(cfg, rows, max_len=max_len, device=dev)
    for t_b, t_1 in zip(many.tensors(), one.tensors()):
        t_b.copy_(t_1.expand_as(t_b))
    spied = [(M, n) for n in ("_mm", "rms_norm", "_attention")]
    spied += [(Q, n) for n in ("w4_gemv", "w8_gemv", "w2_gemv")]
    real = {n: getattr(mod, n) for mod, n in spied}
    log, entered = [], [0]       # (name, attention calls entered, row 0)

    def spy(n):
        # the wrappers count their launches on the name they are called by:
        # the spy carries a copy of the counter, so the real one stays put
        @functools.wraps(real[n])
        def call(*a, **kw):
            if n == "_attention":
                entered[0] += 1
            elif n in ("w4_gemv", "w8_gemv", "w2_gemv"):
                xs = (a[4] if a[4] is not None
                      else a[0].float().sum(1, keepdim=True))
                log.append((f"xsum into {n}", entered[0], xs[0].float()))
            out = real[n](*a, **kw)
            log.append((n, entered[0], out[0].float()))
            return out
        return call

    def where(rec, k):
        name, c, _ = rec[k]
        # an attention norm runs before its layer's attention is entered
        pre = name == "rms_norm" and k + 1 < len(rec) and rec[k + 1][1] > c
        last = " (the lm_head)" if k == len(rec) - 1 else ""
        return f"call {k} of {len(rec)}: {name}{last} in layer {c - 1 + pre}"

    tok, parted = [int(logits.argmax(-1)[0])] * 2, None
    try:
        for mod, n in spied:
            setattr(mod, n, spy(n))
        for step in range(1, n_new):
            runs = []
            for i, (cache, b) in enumerate(((one, 1), (many, rows))):
                log.clear()
                entered[0] = 0
                lg, _ = M.decode_step(
                    cfg, params,
                    torch.full((b,), tok[i], device=dev, dtype=torch.int32),
                    torch.full((b,), len(prompt) + step - 1, device=dev,
                               dtype=torch.int32), cache)
                runs.append((list(log), lg[0].float()))
            (rec1, lg1), (rec8, lg8) = runs
            if parted is None:
                for k, (r1, r8) in enumerate(zip(rec1, rec8)):
                    if not torch.equal(r1[2], r8[2]):
                        parted = (f"first parted at step {step}, "
                                  f"{where(rec1, k)}, max |diff| "
                                  f"{float((r1[2] - r8[2]).abs().max()):.3e}")
                        break
            tok = [int(lg1.argmax()), int(lg8.argmax())]
            if tok[0] != tok[1]:
                top1, top8 = lg1.topk(2).values, lg8.topk(2).values
                return (f"{parted}; tokens fork at step {step}: margin "
                        f"{float(top1[0] - top1[1]):.4e} at 1 row, "
                        f"{float(top8[0] - top8[1]):.4e} at {rows}; top "
                        f"logit {float(top1[0]):.4f}, its bf16 ulp "
                        f"{bf16_ulp(float(top1[0])):.4e}")
    finally:
        for mod, n in spied:
            setattr(mod, n, real[n])
    return f"{parted or 'no call parted'}; no fork in {n_new} tokens"


def check_tokens_guarded(got, want, margins):
    """got == want, or they fork first at a step whose margin is below
    NEAR_TIE (tests/token_guard.py's contract), read on the path that chose
    `want`: single-request decode (`generate_single`'s margins)."""
    if got == want:
        return "equal"
    for i, (a, b) in enumerate(zip(got, want)):
        if a != b:
            if margins[i] >= NEAR_TIE:
                raise AssertionError(f"engine diverged at step {i} with a "
                                     f"decisive margin {margins[i]}")
            return f"near-tie fork at step {i} (margin {margins[i]:.4e})"
    raise AssertionError("token lists differ in length")


def profile_decode(torch, M, cfg, params, dev, steps=4):
    """Wall time of an eager decode step at batch 8 (positions ~512), then
    the device busy share and top kernels over `steps` steps from
    torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cache = M.init_kv_cache(cfg, 8, max_len=2048, device=dev)
    tok = torch.ones(8, dtype=torch.int32, device=dev)
    pos = torch.arange(500, 516, 2, dtype=torch.int32, device=dev)
    M.decode_step(cfg, params, tok, pos, cache)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        M.decode_step(cfg, params, tok, pos + i, cache)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            M.decode_step(cfg, params, tok, pos + i, cache)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernel rows only: the CPU-side op rows repeat their kernels' time
    rows = [(e.key, e.device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.device_time_total > 0]
    if not rows:
        print("profile: no device time in the trace (not measured)",
              flush=True)
        return
    busy = sum(r[1] for r in rows)
    launched = sum(r[2] for r in rows)
    print(f"profile: a decode step takes {plain_ms:.2f} ms unprofiled; "
          f"{steps} decode steps, wall {wall_ms:.2f} ms, kernels "
          f"{busy:.2f} ms (device busy {100 * busy / wall_ms:.1f}%), "
          f"{launched} kernel launches, {launched / steps:.0f} device "
          f"kernels a decode step", flush=True)
    for name, ms, n in sorted(rows, key=lambda r: -r[1])[:8]:
        print(f"profile:   {ms:8.3f} ms  x{n:<6d} {name[:90]}", flush=True)


def run_engine(torch, dev, args):
    import numpy as np

    from piquant_tpu_torch.models import llama as M
    from piquant_tpu_torch.ops.cuda import decode_attn2 as DA
    from piquant_tpu_torch.ops.cuda import flash as FL
    from piquant_tpu_torch.ops.cuda import qmatmul as Q
    from piquant_tpu_torch.quant.linear import QuantizedLinear
    from piquant_tpu_torch.serving import (Engine, EngineConfig, Request,
                                           SamplingParams)

    cfg = M.LlamaConfig.llama3_8b()
    t0 = time.perf_counter()
    params = M.random_quantized_params(cfg, seed=args.seed, device=dev)
    torch.cuda.synchronize()
    wbytes = sum(t.numel() * t.element_size() for layer in params["layers"]
                 for w in layer.values() if isinstance(w, QuantizedLinear)
                 for t in (w.data, w.scale, w.zero_point))
    hbytes = params["lm_head"].numel() * params["lm_head"].element_size()
    print(f"engine: Llama-3-8B random INT4 params built in "
          f"{time.perf_counter() - t0:.1f} s; per decode step the weight "
          f"stream is {wbytes / 1e9:.3f} GB INT4 + {hbytes / 1e9:.3f} GB "
          f"bf16 lm_head, floor {(wbytes + hbytes) / args.bw * 1e3:.3f} ms "
          f"at the measured copy bandwidth", flush=True)
    ec = EngineConfig(batch_slots=8, max_seq_len=2048, prefill_pad=128,
                      decode_block=16)
    eng = Engine(cfg, params, ec, rng_seed=args.seed, device=dev)
    rng = np.random.default_rng(args.seed)
    n_new = 64
    reqs = []
    for i in range(16):
        plen = int(rng.integers(128, 1025))
        prompt = [int(t) for t in rng.integers(1, cfg.vocab_size, plen)]
        sp = (SamplingParams(max_new_tokens=n_new) if i % 2 == 0 else
              SamplingParams(temperature=0.8, top_p=0.95,
                             max_new_tokens=n_new))
        reqs.append(Request(rid=i, prompt=prompt, sampling=sp))

    counts = {"blocks": 0, "prefills": 0}
    dispatch, admit = eng._dispatch_block, eng._admit_one_shot

    def counted_dispatch():
        counts["blocks"] += 1
        return dispatch()

    def counted_admit(batch):
        counts["prefills"] += 1
        return admit(batch)

    eng._dispatch_block, eng._admit_one_shot = counted_dispatch, counted_admit
    for r in reqs:
        eng.submit(r)
    zero_counts()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"w4_gemv": Q.w4_gemv.launches,
                "decode_attn2": DA.decode_attn2.launches,
                "flash_prefill": FL.flash_attn.launches}

    if len(done) != len(reqs):
        raise AssertionError(f"{len(done)} of {len(reqs)} requests finished")
    for r in done:
        if len(r.tokens) != n_new:
            raise AssertionError(f"request {r.rid}: {len(r.tokens)} tokens")
        if not all(0 <= t < cfg.vocab_size for t in r.tokens):
            raise AssertionError(f"request {r.rid}: token outside the vocab")
        if not all(np.isfinite(lp) and lp <= 0 for lp in r.logprobs):
            raise AssertionError(f"request {r.rid}: non-finite logits")
    steps = counts["blocks"] * ec.decode_block
    expect = {"w4_gemv": 7 * cfg.n_layers * steps,
              "decode_attn2": cfg.n_layers * steps,
              "flash_prefill": cfg.n_layers * counts["prefills"]}
    print(f"engine: {counts['blocks']} decode blocks ({steps} steps), "
          f"{counts['prefills']} prefill calls, launches {launches}, "
          f"expected {expect}", flush=True)
    if launches != expect:
        raise AssertionError(f"kernel launches {launches} != {expect}")

    for r in [r for r in done if r.sampling.temperature <= 0][:2]:
        want, margins = generate_single(torch, M, cfg, params, r.prompt,
                                        n_new, dev)
        verdict = check_tokens_guarded(r.tokens, want, margins)
        print(f"engine: request {r.rid} (prompt {len(r.prompt)}) vs "
              f"single-request generation: {verdict}", flush=True)

    profile_decode(torch, M, cfg, params, dev)
    m = eng.metrics
    summary = {"card": card_line(), **m.to_dict(), "wall_s": wall,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30}
    print("engine_metrics " + json.dumps(summary), flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 6: the weight-format kernels against their plain versions
# ---------------------------------------------------------------------------

MLP_SHAPES = ((4096, 14336, 2), (14336, 4096, 1))


def check_weight_formats(torch, dev, gen):
    """Phase 6: one kernels-line row per new wrapper, at the shapes the CLI
    runs give it (decode batch 8)."""
    rows = [
        gemv_row(torch, dev, gen, "w8_gemv", "1044 (_w8_kernel)",
                 "INT8 lm_head: M=8, K=4096, N=128256, f32 out", 8, None,
                 ((4096, 128256, 1),), torch.float32),
        gemv_row(torch, dev, gen, "w2_gemv", "914 (_w2_kernel)",
                 "one decode layer at --bits 2: 7 projections at M=8", 2,
                 None, W4_SHAPES, torch.bfloat16),
        gemv_row(torch, dev, gen, "wg_chunk",
                 "657 (_wg_chunk_kernel, bf16-x form)",
                 "one decode layer at --group-size 128: 7 INT4-g128 "
                 "projections at M=8", 4, 128, W4_SHAPES, torch.bfloat16)]
    mlp = check_gemv(torch, dev, gen, "wg_chunk", 2, 32, MLP_SHAPES,
                     torch.bfloat16)
    rows[-1]["max_abs_err"] = max(rows[-1]["max_abs_err"], mlp["max_abs_err"])
    rows[-1]["variants"] = {"INT2-g32 MLP (w1, w3, w2) at M=8": mlp}
    print(f"wg_chunk INT2-g32 MLP: kernel {mlp['ms']:.4f} ms, bound "
          f"{mlp['bound_ms']:.4f} ms, plain {mlp['plain_ms']:.4f} ms, "
          f"torch.matmul {mlp['library_ms']:.4f} ms [{card_line()}]",
          flush=True)
    rows.append(gemv_row(torch, dev, gen, "w4_grouped",
                         "613 (_w4_grouped_kernel)",
                         "--group-size 256 w2: M=8, K=14336, N=4096, G=56",
                         4, 256, ((14336, 4096, 1),), torch.bfloat16))
    return rows


# ---------------------------------------------------------------------------
# phase 8: int8 activations
# ---------------------------------------------------------------------------

A8_HOLD_M = (1024, 8, 1, 33, 1000)   # prefill, decode batch, a lone row,
                                     # ragged decode and prefill tiles
A8_TIMED_M = (1024, 8)


def check_a8(torch, dev, gen, name, bits, shapes):
    """a8 wrapper `name` bit for bit against its plain version (f32 and
    bf16 output) at each (K, N) of `shapes` and M in A8_HOLD_M; then at M =
    1024 and M = 8 its device ms summed over the shapes' uses, the plain
    version's, a yardstick (torch._int_mm on the int8-unpacked codes at the
    prefill M, torch.matmul on the bf16 dequantized weight at M = 8), the host
    cost of an eager call and the bound.  Returns {M: numbers}."""
    from piquant_tpu_torch.ops.cuda import qmatmul as Q
    from piquant_tpu_torch.quant.linear import _quantize_act

    kern, plain = getattr(Q, name), getattr(Q, name + "_plain")
    shift = 128 if bits == 8 else 0
    tot = {m: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, eager_ms=0.0,
                   nbytes=0.0, ops=0.0) for m in A8_TIMED_M}
    err = 0.0

    def operands(m, k, ql):
        xb = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        xq, xs = _quantize_act(xb)
        return (xq, xs, ql.data, *Q.a8_operands(xq, ql, shift)), xb

    for k, n, uses in shapes:
        copies = max(1, -(-256 * 2**20 // (k * n * bits // 8)))
        qls = [random_qlin(torch, dev, gen, k, n, bits, None)
               for _ in range(copies)]
        for m in A8_HOLD_M:
            ops, _ = operands(m, k, qls[0])
            for odt in (torch.float32, torch.bfloat16):
                err = max(err, same(torch, f"{name} K={k} N={n} M={m} {odt}",
                                    kern(*ops, odt), plain(*ops, odt)))
        torch.cuda.synchronize()
        print(f"{name} K={k} N={n}: bit for bit at M {A8_HOLD_M}", flush=True)
        for m in A8_TIMED_M:
            xb = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
            xq, xs = _quantize_act(xb)
            ops = [(xq, xs, ql.data, *Q.a8_operands(xq, ql, shift))
                   for ql in qls]
            call = lambda i: kern(*ops[i % copies],  # noqa: E731
                                  torch.bfloat16)
            t_k = cuda_ms(call, 20)
            t_e = host_ms(call, 20)
            t_p = event_ms(lambda i: plain(*ops[i % copies], torch.bfloat16),
                           2, warmup=1)
            if m > 16:
                # the codes column-major (cuBLAS's int8 layout), copied
                # once outside the timed loop
                codes = [(ql.codes() - shift).to(torch.int8).t().contiguous()
                         for ql in qls[:2]]
                t_l = event_ms(lambda i: torch._int_mm(xq, codes[i % 2].t()),
                               20)
                lib = "torch._int_mm (int8-unpacked codes, column-major)"
            else:
                codes = [ql.dequantize(torch.bfloat16) for ql in qls[:2]]
                t_l = cuda_ms(lambda i: torch.matmul(xb, codes[i % 2]), 20)
                lib = "torch.matmul (bf16 dequantized W)"
            print(f"{name} K={k} N={n} M={m}: kernel {t_k:.4f} ms, plain "
                  f"{t_p:.4f} ms, {lib} {t_l:.4f} ms", flush=True)
            t = tot[m]
            t["ms"] += uses * t_k
            t["plain_ms"] += uses * t_p
            t["library_ms"] += uses * t_l
            t["eager_ms"] += uses * t_e
            t["library_call"] = lib
            t["nbytes"] += uses * (m * k + k * n * bits / 8 + 8 * n + 8 * m
                                   + 2 * m * n)
            t["ops"] += uses * 2.0 * m * n * k
            del codes, ops
        del qls
    res = {}
    for m, t in tot.items():
        b, by = bound_ms(t["nbytes"], t["ops"], INT8_OP_PER_S)
        res[m] = dict(max_abs_err=err, ms=t["ms"], plain_ms=t["plain_ms"],
                      bound_ms=b, bound_by=by, library_ms=t["library_ms"],
                      library_call=t["library_call"], eager_ms=t["eager_ms"],
                      ops=t["ops"])
    return res


def a8_row(torch, dev, gen, name, replaces, bits, shapes, what):
    """The kernels-line row of a8 wrapper `name`: timed at the prefill M,
    with the decode M as a variant."""
    res = check_a8(torch, dev, gen, name, bits, shapes)
    card = card_line()
    for m, r in res.items():
        print(f"{name} M={m}: kernel {r['ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), plain "
              f"{r['plain_ms']:.4f} ms, {r['library_call']} "
              f"{r['library_ms']:.4f} ms, eager {r['eager_ms']:.4f} ms "
              f"[{what}; {card}]", flush=True)
    prefill, decode = A8_TIMED_M
    r = res[prefill]
    peak = INT8_OP_PER_S * 1e-3          # operations a millisecond
    print(f"{name} M={prefill}: {r['ops'] / r['ms'] * 1e-9:.1f} TOP/s, "
          f"{100 * r['ops'] / r['ms'] / peak:.1f}% of the int8 peak; "
          f"{r['library_call']} {100 * r['ops'] / r['library_ms'] / peak:.1f}"
          f"% [{card}]", flush=True)
    return dict(name=name, route="cuda",
                source="piquant_tpu_torch/csrc/qmatmul_a8.cu",
                replaces=f"piquant_tpu/ops/pallas/qmatmul.py:{replaces}",
                timed=f"{what} at M={prefill}", **res[prefill],
                variants={f"{what} at M={decode}": res[decode]})


def a8_attributes(torch) -> str:
    """Registers, local (spill) bytes, shared memory and ring stages of each
    a8 instance (cudaFuncGetAttributes): the mma.sync decode tiles (16 and
    64 rows) and the wgmma prefill tiles (128 and 256 tokens) at P = 1, 2,
    4."""
    import ctypes

    from piquant_tpu_torch.ops.cuda import _build

    parts = []
    for planes in (1, 2, 4):
        for bm in (16, 64, 128, 256):
            a = (ctypes.c_int * 4)()
            _build.check(_build.library().pq_a8_attributes(planes, bm, a),
                         "pq_a8_attributes")
            parts.append(f"P={planes} bm={bm}: {a[0]} registers, {a[1]} B "
                         f"local, {a[2]} B shared, {a[3]} stages")
    return "; ".join(parts)


def a8_tiles(torch, dev, gen, m=1024):
    """Both prefill tiles (128 tokens x 256 columns, 256 x 128) of each a8
    entry at each Llama-3-8B shape and M = m, K split as a8_split chooses
    for the tile: device ms a call and the tile `a8_prefill_bm` picks,
    one line a P (the evidence for that choice)."""
    from piquant_tpu_torch.ops.cuda import _build
    from piquant_tpu_torch.ops.cuda import qmatmul as Q
    from piquant_tpu_torch.quant.linear import _quantize_act

    lib = _build.library()
    card = card_line()
    for bits, entry in ((8, "pq_w8a8"), (4, "pq_w4a8"), (2, "pq_w2a8")):
        planes = Q.PLANES[bits]
        parts = []
        for k, n, _ in W4_SHAPES:
            if bits == 8 and k > 8192:
                continue
            ql = random_qlin(torch, dev, gen, k, n, bits, None)
            xq, xs = _quantize_act(torch.randn(
                (m, k), generator=gen, device=dev).to(torch.bfloat16))
            ops = (xq, xs, ql.data,
                   *Q.a8_operands(xq, ql, 128 if bits == 8 else 0))
            out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
            times = [f"picks {Q.a8_prefill_bm(m, k, planes)}"]
            for bm in (128, 256):
                bm, ksplit, per = Q.a8_split(m, k, n, _build.sm_count(
                    dev.index or 0), planes, bm)
                part = torch.empty((ksplit, m, n), dtype=torch.int32,
                                   device=dev)

                def call(i, bm=bm, ksplit=ksplit, per=per, part=part):
                    _build.check(getattr(lib, entry)(
                        *(t.data_ptr() for t in ops), out.data_ptr(),
                        part.data_ptr(), m, k, n, bm, ksplit, per, 1,
                        torch.cuda.current_stream().cuda_stream), entry)
                times.append(f"bm {bm} (ksplit {ksplit}) "
                             f"{cuda_ms(call, 20):.4f}")
            parts.append(f"K={k} N={n}: {', '.join(times)}")
            del ql, ops, out
        print(f"a8 tiles P={planes} M={m} (device ms): {'; '.join(parts)} "
              f"[{card}]", flush=True)


def check_act_quant(torch, dev, gen, wg_row):
    """Phase 8: one kernels-line row per a8 wrapper at the shapes the
    act-quant CLI runs give it; the chunk kernel's int8-x form joins the
    wg_chunk row (`wg_row`) as variants."""
    print(f"a8 instances: {a8_attributes(torch)}", flush=True)
    a8_tiles(torch, dev, gen)
    a8_tiles(torch, dev, gen, 256)
    rows = [
        a8_row(torch, dev, gen, "w4a8",
               "408 (_w4a8_kernel), piquant_tpu/ops/pallas/qmatmul.py:450 "
               "(_w4a8_kernel_ksplit)", 4, W4_SHAPES,
               "one layer's 7 INT4 projections"),
        a8_row(torch, dev, gen, "w8a8", "551 (_w8a8_kernel)", 8,
               W4_SHAPES[:3], "one layer's 6 INT8 projections with K <= 8192"),
        a8_row(torch, dev, gen, "w2a8", "954 (_w2a8_kernel)", 2, W4_SHAPES,
               "one layer's 7 INT2 projections")]
    card = card_line()
    for tag, bits, gs, shapes in (
            ("int8-x INT2-g32 MLP (w1, w3, w2) at M=8", 2, 32, MLP_SHAPES),
            ("int8-x, one layer's 7 INT4-g128 projections at M=8", 4, 128,
             W4_SHAPES)):
        r = check_gemv(torch, dev, gen, "wg_chunk", bits, gs, shapes,
                       torch.bfloat16, a8=True)
        wg_row["max_abs_err"] = max(wg_row["max_abs_err"], r["max_abs_err"])
        wg_row["variants"][tag] = r
        print(f"wg_chunk {tag}: kernel {r['ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"torch.matmul {r['library_ms']:.4f} ms [{card}]", flush=True)
    return rows


# ---------------------------------------------------------------------------
# phase 7: the serving CLI at full Llama-3-8B width
# ---------------------------------------------------------------------------

def _gemv_only(per_layer):
    """Weight-only formats: decode steps and prefill calls of at most 64
    rows take the decode-M GEMVs; larger prefills take no kernel (the dense
    bf16 product or the dequant path)."""
    return {"small": per_layer, "mid": {}, "big": {}}


# flags of each run, and the wrappers each layer's projections take as the
# dispatch gates say, by the rows M of a call: "small" (decode steps at 8
# slots, prefill calls of M <= 64), "mid" (64 < M < 256), "big" (M >= 256);
# the INT8 lm_head besides takes w8_gemv once a decode step and a prefill
CLI_RUNS = (
    (("--group-size", "128"), _gemv_only({"wg_chunk": 7})),
    (("--mlp-bits", "2", "--mlp-group-size", "32"),
     _gemv_only({"w4_gemv": 4, "wg_chunk": 3})),
    # w2 at g256: 28 groups a plane, no chunk factor of 8
    (("--group-size", "256"), _gemv_only({"wg_chunk": 6, "w4_grouped": 1})),
    (("--bits", "2"), _gemv_only({"w2_gemv": 7})),
    # int8 activations at M >= 256 only
    (("--act-quant-prefill",),
     {"small": {"w4_gemv": 7}, "mid": {}, "big": {"w4a8": 7}}),
    # w2 (K = 14336 > 8192) declines w8a8 and takes the dequant path
    (("--bits", "8", "--act-quant-prefill"),
     {"small": {"w8_gemv": 7}, "mid": {}, "big": {"w8a8": 6}}),
    # int8 activations at every M
    (("--bits", "2", "--act-quant-decode"),
     {c: {"w2a8": 7} for c in ("small", "mid", "big")}),
    # the grouped MLP takes the int8-x chunk kernel up to 64 rows, then the
    # weight-only route
    (("--mlp-bits", "2", "--mlp-group-size", "32", "--act-quant-decode"),
     {"small": {"w4a8": 4, "wg_chunk": 3}, "mid": {"w4a8": 4},
      "big": {"w4a8": 4}}),
)
CLI_KERNELS = ("w4_gemv", "w8_gemv", "w2_gemv", "wg_chunk", "w4_grouped",
               "w4a8", "w8a8", "w2a8", "nf4_gemv", "decode_attn2",
               "decode_attn2_kv4", "flash_prefill")


def run_cli(torch, dev, args, runs=CLI_RUNS,
            counted=("w8_gemv", "w2_gemv", "wg_chunk", "w4_grouped", "w4a8",
                     "w8a8", "w2a8"), model=("--random", "llama3_8b"),
            padded=False):
    """Phase 7 (and 10 (c), 18 (a)): each configuration of `runs` through
    the CLI's own build and benchmark of `model` (the flags that name it:
    a --random preset's lm_head is INT8 and takes w8_gemv, a --model
    checkpoint's stays bf16), with its launches, tokens and metrics
    checked (`padded`: the single-request generation the tokens are
    held against prefills at the engine's padded width).  Returns the
    launches of the `counted` wrappers summed over the runs."""
    import numpy as np

    from piquant_tpu_torch.models import llama as M
    from piquant_tpu_torch.serving import __main__ as S

    total = dict.fromkeys(counted, 0)
    int8_head = model[0] == "--random"
    for flags, per_layer in runs:
        argv = [*model, "--benchmark", "8", "--max-new", "32", *flags]
        cli_args = S.build_parser().parse_args(argv)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        cfg, params, eng, sp = S.build(cli_args)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        counts = {"blocks": 0, "prefills": 0, "small": 0, "mid": 0, "big": 0,
                  "flash_prefills": 0}
        dispatch, admit = eng._dispatch_block, eng._admit_one_shot

        def counted_dispatch():
            counts["blocks"] += 1
            return dispatch()

        def counted_admit(batch):
            counts["prefills"] += 1
            width = eng._padded_len(batch[0][2])
            # a prefill's projections see len(batch) * width rows: at most
            # M_MAX take the decode-M GEMVs, 256 or more the prefill routes;
            # flash prefill takes widths of whole 128-row tiles (the CLI
            # pads prompts to 64)
            rows = len(batch) * width
            counts["small" if rows <= 64 else "big" if rows >= 256
                   else "mid"] += 1
            counts["flash_prefills"] += width % 128 == 0
            return admit(batch)

        eng._dispatch_block, eng._admit_one_shot = (counted_dispatch,
                                                    counted_admit)
        zero_counts()
        metrics, done = S.benchmark(cli_args, cfg, eng, sp)
        torch.cuda.synchronize()
        wr = kernel_wrappers()
        launches = {k: wr[k].launches for k in CLI_KERNELS}
        nl = cfg.n_layers
        steps = counts["blocks"] * eng.ec.decode_block
        calls = {"small": steps + counts["small"], "mid": counts["mid"],
                 "big": counts["big"]}
        expect = dict.fromkeys(CLI_KERNELS, 0)
        for cls, kernels in per_layer.items():
            for k, per in kernels.items():
                expect[k] += per * nl * calls[cls]
        expect["w8_gemv"] += (steps + counts["prefills"]) * int8_head
        expect["decode_attn2_kv4" if cfg.kv_bits == 4 else "decode_attn2"] = (
            nl * steps)
        expect["flash_prefill"] = nl * counts["flash_prefills"]
        tag = " ".join(flags)
        print(f"cli [{tag}]: built in {t_build:.1f} s; {counts['blocks']} "
              f"decode blocks ({steps} steps), {counts['prefills']} prefill "
              f"calls ({counts['small']} at M <= 64, {counts['mid']} at "
              f"64 < M < 256, {counts['big']} at M >= 256, "
              f"{counts['flash_prefills']} of whole 128-row tiles), launches "
              f"{launches}, expected {expect}", flush=True)
        if launches != expect:
            raise AssertionError(f"cli [{tag}]: launches {launches} != "
                                 f"{expect}")
        if metrics["completed"] != cli_args.benchmark:
            raise AssertionError(f"cli [{tag}]: {metrics['completed']} of "
                                 f"{cli_args.benchmark} requests finished")
        for r in done:
            # a --model checkpoint's requests may stop at its EOS id
            if (len(r.tokens) != cli_args.max_new
                    and r.tokens[-1:] != [sp.eos_token]) or not all(
                        0 <= t < cfg.vocab_size for t in r.tokens):
                raise AssertionError(f"cli [{tag}] request {r.rid}: tokens "
                                     f"{len(r.tokens)} or outside the vocab")
            if not all(np.isfinite(lp) and lp <= 0 for lp in r.logprobs):
                raise AssertionError(f"cli [{tag}] request {r.rid}: "
                                     "non-finite logits")
        # a prompt of >= 256 tokens: its prefill takes the M >= 256 route
        # alone as in the burst (under --act-quant-prefill the route, and
        # with it the numerics, depends on M)
        r = next(r for r in done if len(r.prompt) >= 256)
        pad = (dict(width=eng._padded_len(len(r.prompt)),
                    max_len=eng.ec.max_seq_len) if padded else {})
        want, margins = generate_single(torch, M, cfg, params, r.prompt,
                                        len(r.tokens), dev, **pad)
        verdict = check_tokens_guarded(r.tokens, want, margins)
        print(f"cli [{tag}]: request {r.rid} (prompt {len(r.prompt)}) vs "
              f"single-request generation: {verdict}", flush=True)
        profile_decode(torch, M, cfg, params, dev)
        print("cli_metrics " + json.dumps(
            {"card": card_line(), "flags": tag, **metrics,
             "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30}),
            flush=True)
        for k in total:
            total[k] += launches[k]
        # the counting wrappers close over the engine's bound methods: a
        # reference cycle, freed only by the collector
        del params, eng, done, dispatch, admit
        gc.collect()
        torch.cuda.empty_cache()
    return total


# Depth of the CLI runs of phases 7 and 9 (of Llama-3-8B's and
# Mixtral-8x7B's 32 layers), since phase 13 came of phase 11's four dense
# family presets, and since phase 14 came of phase 10's and phase 14's
# (widths unchanged): the later phases need the time, and phases 5 and 14
# (b) and the long requests serve the full depth.
CLI_DEPTH = 4


@contextlib.contextmanager
def cut_depth(preset: str, n_layers: int):
    """The CLI builds `preset` at `n_layers` layers, at its full width,
    while the block runs."""
    from piquant_tpu_torch.models import llama as M

    full = getattr(M.LlamaConfig, preset)
    setattr(M.LlamaConfig, preset, staticmethod(
        lambda: dataclasses.replace(full(), n_layers=n_layers)))
    try:
        yield
    finally:
        setattr(M.LlamaConfig, preset, staticmethod(full))


# ---------------------------------------------------------------------------
# phase 9: Mixtral-8x7B MoE
# ---------------------------------------------------------------------------

MOE_T = 1024                  # tokens routed for the kernel checks
MOE_E, MOE_K = 8, 2           # Mixtral: 8 experts, top 2
# (K, N, calls per MoE layer) of the expert projections: w1 / w3, w2
MOE_SHAPES = ((4096, 14336, 2), (14336, 4096, 1))


def moe_routing(torch, dev, gen, t, n_e=MOE_E, top_k=MOE_K, d=4096):
    """The routing of t tokens of width d, top_k of n_e experts, by a random
    router whose logits carry a per-expert bias: expert 0 gets no token and
    expert 1 nearly every one; with the per-expert padded ends
    (torch._grouped_mm's offsets)."""
    from piquant_tpu_torch.quant import moe as MO

    x = torch.randn((t, d), generator=gen, device=dev)
    router = torch.randn((d, n_e), generator=gen, device=dev) * 0.02
    bias = torch.zeros(n_e, device=dev)
    bias[0], bias[1] = -1e4, 4.0
    probs, topi = torch.softmax(x @ router + bias, dim=-1).topk(top_k, dim=-1)
    probs = probs / probs.sum(dim=-1, keepdim=True)
    r = MO.build_ragged_routing(topi[None], probs[None], n_e, 128)
    counts = torch.bincount(topi.reshape(-1), minlength=n_e)
    ends = torch.cumsum((counts + 127) // 128 * 128, 0).to(torch.int32)
    return r, counts, ends


def check_live_blocks(r, counts) -> int:
    """The routing's live_blocks against the count reckoning (each expert's
    tokens rounded up to 128-row blocks); returns the live rows."""
    want = int(((counts + 127) // 128).sum())
    if int(r.live_blocks) != want:
        raise AssertionError(f"live_blocks {int(r.live_blocks)} != {want} "
                             "from the counts")
    return 128 * want


def ragged_attributes(torch) -> str:
    """Registers, local (spill) bytes, dynamic shared memory and stages of
    each ragged_gemm instance (cudaFuncGetAttributes)."""
    import ctypes

    from piquant_tpu_torch.ops.cuda import _build

    parts = []
    for mode, tag in ((0, "channel"), (1, "group-step"), (2, "group-row")):
        for planes in (1, 2, 4):
            a = (ctypes.c_int * 4)()
            _build.check(_build.library().pq_ragged_attributes(planes, mode,
                                                               a),
                         "pq_ragged_attributes")
            parts.append(f"P={planes} {tag}: {a[0]} registers, {a[1]} B "
                         f"local, {a[2]} B shared, {a[3]} stages")
    return "; ".join(parts)


def random_stack(torch, dev, gen, k, n, bits, gs, n_e=MOE_E):
    """A stack of n_e experts of random codes with a scale and zero point of
    their own per expert, column (and group)."""
    from piquant_tpu_torch.quant.linear import QuantizedExpertStack

    return QuantizedExpertStack.stack(
        [random_qlin(torch, dev, gen, k, n, bits, gs) for _ in range(n_e)])


def check_ragged(torch, dev, gen, name, bits, gs, r, counts, ends,
                 shapes=None, t=None):
    """Wrapper `name` (through its dispatch) against its plain version at
    each expert shape of `shapes` (K, N, calls per MoE layer; default
    MOE_SHAPES), bf16 and f32 output, for t tokens (default MOE_T) routed
    as `r`; then its device ms, the plain version's, the yardstick's and
    the bound, summed over one MoE layer's calls.  The bound counts the A routed assignments' operations (2 A K N
    at the bf16 peak, the int8 peak for int8 x) and bytes (their x, the
    stacks of the experts that have a token with their side streams, the
    bf16 output).  The kernels take the routing's live_blocks: the padding
    rows must come out zero, computed or not; their TFLOP/s (TOP/s) are
    reckoned on the routed rows and on the live rows (each expert's rows
    rounded up to 128, what the kernel computes)."""
    from piquant_tpu_torch.ops.cuda import ragged as R
    from piquant_tpu_torch.quant import moe as MO
    from piquant_tpu_torch.quant.linear import _quantize_act

    a8 = name == "wq_ragged_a8"
    kern, plain = getattr(R, name), getattr(R, name + "_plain")
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, nbytes=0.0, ops=0.0)
    err = 0.0
    a = int(counts.sum())
    used = int((counts > 0).sum())
    n_e = counts.numel()
    live_rows = check_live_blocks(r, counts)
    live = (r.live_blocks,)
    live_ops = 0.0
    for k, n, uses in shapes or MOE_SHAPES:
        st = random_stack(torch, dev, gen, k, n, bits, gs, n_e)
        xs = MO.scatter_tokens(torch.randn((t or MOE_T, k), generator=gen,
                                           device=dev).to(torch.bfloat16), r)
        be = r.block_expert
        if a8:
            xq, xsc = _quantize_act(xs)
            s, zs = R._channel_side(st)
            ops = (xq, xsc, st.data, s, zs, xq.float().sum(1, keepdim=True),
                   be)
        elif gs:
            ops = (xs, st.data, st.scale, st.zero_point, gs, be)
        else:
            s, zs = R._channel_side(st)
            ops = (xs, st.data, s, zs, xs.float().sum(1, keepdim=True), be)
        for odt in (torch.bfloat16, torch.float32):
            if a8:
                got = R.wq_ragged_matmul_a8(xq, xsc, st, be, odt, *live)
                e = same(torch, f"{name} K={k} N={n} {odt}", got,
                         plain(*ops, odt, *live))
            else:
                got = R.wq_ragged_matmul(xs, st, be, odt, *live)
                # atol 2e-2, rtol 1e-2: bf16 operands in both, f32 sums in
                # another order, one bf16 output rounding
                e = hold(torch, f"{name} K={k} N={n} {odt}", got.float(),
                         plain(*ops, odt).float(), 2e-2, 1e-2)
            err = max(err, e)
            pad = torch.ones(xs.shape[0], dtype=torch.bool, device=dev)
            pad[r.dest] = False
            if got[pad].any():
                raise AssertionError(f"{name}: a padding row is not zero")
        t_k = cuda_ms(lambda i: kern(*ops, torch.bfloat16, *live), 10)
        t_p = event_ms(lambda i: plain(*ops, torch.bfloat16), 2, warmup=1)
        # yardstick, never called by the port: one torch._grouped_mm over
        # the bf16-dequantized stack with the experts' padded ends
        w = torch.stack([st.expert(i).dequantize(torch.bfloat16)
                         for i in range(n_e)])
        t_l = event_ms(lambda i: torch._grouped_mm(xs, w, offs=ends), 10)
        print(f"{name} K={k} N={n}: max_abs_err {err:.3e}; kernel {t_k:.4f} "
              f"ms, plain {t_p:.4f} ms, torch._grouped_mm {t_l:.4f} ms",
              flush=True)
        tot["ms"] += uses * t_k
        tot["plain_ms"] += uses * t_p
        tot["library_ms"] += uses * t_l
        g = k // gs if gs else 1
        side = used * g * n * 8
        tot["nbytes"] += uses * (a * k * (1 if a8 else 2) + a * 8
                                 + used * k * n * bits / 8 + side
                                 + a * n * 2)
        tot["ops"] += uses * 2.0 * a * k * n
        live_ops += uses * 2.0 * live_rows * k * n
        del st, xs, ops, w
    b, by = bound_ms(tot["nbytes"], tot["ops"],
                     INT8_OP_PER_S if a8 else BF16_FLOP_PER_S)
    return dict(max_abs_err=err, ms=tot["ms"], plain_ms=tot["plain_ms"],
                bound_ms=b, bound_by=by, library_ms=tot["library_ms"],
                library_call="torch._grouped_mm (bf16 dequantized stack)",
                routed_rows=a, live_rows=live_rows,
                tflops_routed=tot["ops"] / tot["ms"] * 1e-9,
                tflops_live=live_ops / tot["ms"] * 1e-9)


def check_moe_kernels(torch, dev, gen):
    """Phase 9 (a): one kernels-line row per ragged wrapper, its main format
    first and the others as variants."""
    r, counts, ends = moe_routing(torch, dev, gen, MOE_T)
    print(f"moe: {MOE_T} tokens routed top {MOE_K} of {MOE_E}: tokens per "
          f"expert {counts.tolist()}, m_pad {r.m_pad}", flush=True)
    if int(counts[0]) or int(counts[1]) < MOE_T * 9 // 10:
        raise AssertionError("moe: the routing lost its zero-token or its "
                             "nearly-all expert")
    card = card_line()
    rows = []
    for name, replaces, formats in (
            ("wq_ragged", "90 (_wq_ragged_kernel)",
             (("INT4", 4, None), ("INT2", 2, None), ("INT8", 8, None))),
            ("wq_ragged_grouped", "152 (_wq_ragged_grouped_kernel)",
             (("INT4-g128", 4, 128), ("INT2-g32", 2, 32))),
            ("wq_ragged_a8", "240 (_wq_ragged_a8_kernel)",
             (("int8-x INT4", 4, None), ("int8-x INT2", 2, None)))):
        res = {}
        for tag, bits, gs in formats:
            res[tag] = check_ragged(torch, dev, gen, name, bits, gs, r,
                                    counts, ends)
            x = res[tag]
            print(f"{name} {tag}: kernel {x['ms']:.4f} ms, bound "
                  f"{x['bound_ms']:.4f} ms ({x['bound_by']}), plain "
                  f"{x['plain_ms']:.4f} ms, {x['library_call']} "
                  f"{x['library_ms']:.4f} ms; {x['routed_rows']} routed, "
                  f"{x['live_rows']} live of {r.m_pad} rows: "
                  f"{x['tflops_routed']:.1f} / {x['tflops_live']:.1f} "
                  f"TFLOP/s [one Mixtral MoE layer, {MOE_T} tokens; {card}]",
                  flush=True)
            torch.cuda.empty_cache()
        main, *rest = formats
        row = dict(name=name, route="cuda",
                   source=("piquant_tpu_torch/csrc/qmatmul_a8.cu"
                           if name == "wq_ragged_a8" else
                           "piquant_tpu_torch/csrc/qmatmul_ragged.cu"),
                   replaces=f"piquant_tpu/ops/pallas/qmatmul.py:{replaces}",
                   timed=f"one Mixtral MoE layer at {main[0]} (w1, w3, w2), "
                         f"{MOE_T} tokens, m_pad {r.m_pad}",
                   **res[main[0]],
                   variants={f[0]: res[f[0]] for f in rest})
        row["max_abs_err"] = max(v["max_abs_err"] for v in res.values())
        rows.append(row)
    print(f"ragged_gemm instances: {ragged_attributes(torch)}", flush=True)
    return rows


def check_moe_routes(torch, dev, args):
    """Phase 9 (b): one full-width Mixtral MoE layer, its ragged route
    against its dense-masked route at 256 tokens (the same function): INT4
    and INT4-g128 within 2e-2, and int8 activations (--act-quant-prefill)
    within 3e-2, the bounds of the reference's tests/test_moe.py."""
    import dataclasses

    from piquant_tpu_torch.models import llama as M
    from piquant_tpu_torch.ops.cuda import ragged as R

    base = dataclasses.replace(M.LlamaConfig.mixtral_8x7b(), n_layers=1)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    x = torch.randn((1, 256, 4096), generator=gen,
                    device=dev).to(torch.bfloat16)
    for tag, kw, aqp, bound, kern in (
            ("INT4", {}, False, 2e-2, R.wq_ragged),
            ("INT4-g128", {"group_size": 128}, False, 2e-2,
             R.wq_ragged_grouped),
            ("int8-x INT4", {}, True, 3e-2, R.wq_ragged_a8)):
        cfg = dataclasses.replace(base, act_quant_prefill=aqp)
        layer = M.random_quantized_params(cfg, args.seed, device=dev,
                                          **kw)["layers"][0]
        probs, topi = torch.softmax(x.float() @ layer["router"].float(),
                                    dim=-1).topk(2, dim=-1)
        probs = probs / probs.sum(dim=-1, keepdim=True)
        before = kern.launches
        ragged = M._moe_ragged_try(cfg, layer, x, probs, topi)
        if ragged is None or kern.launches != before + 3:
            raise AssertionError(f"moe routes [{tag}]: the ragged route "
                                 "did not run its kernel")
        dense = M._moe_dense(cfg, layer, x, probs, topi, M._act_quant(cfg))
        err = hold(torch, f"moe ragged vs dense [{tag}]", ragged, dense,
                   bound, bound)
        print(f"moe routes [{tag}]: ragged vs dense-masked at 256 tokens, "
              f"max_abs_err {err:.3e} (max |dense| "
              f"{float(dense.abs().max()):.3e}, bound {bound})", flush=True)
        del layer
        torch.cuda.empty_cache()


# flags of each Mixtral CLI run and the wrappers each layer takes by call:
# "decode" (steps at 8 slots: the dense-masked MoE, 24 expert GEMVs, and 4
# attention projections), "small" / "mid" / "big" prefill calls of M <= 64,
# 64 < M < 256 and M >= 256 rows (the ragged MoE from 32 tokens on, under
# --act-quant-prefill from 256)
MOE_CLI_RUNS = (
    (("--random", "mixtral_8x7b"),
     {"decode": {"w4_gemv": 28}, "small": {"w4_gemv": 4, "wq_ragged": 3},
      "mid": {"wq_ragged": 3}, "big": {"wq_ragged": 3}}),
    (("--random", "mixtral_8x7b", "--group-size", "128"),
     {"decode": {"wg_chunk": 28},
      "small": {"wg_chunk": 4, "wq_ragged_grouped": 3},
      "mid": {"wq_ragged_grouped": 3}, "big": {"wq_ragged_grouped": 3}}),
    (("--random", "mixtral_8x7b", "--act-quant-prefill"),
     {"decode": {"w4_gemv": 28}, "small": {"w4_gemv": 28}, "mid": {},
      "big": {"w4a8": 4, "wq_ragged_a8": 3}}),
)
MOE_KERNELS = ("w4_gemv", "w8_gemv", "wg_chunk", "w4a8", "wq_ragged",
               "wq_ragged_grouped", "wq_ragged_a8", "decode_attn2",
               "flash_prefill")
RAGGED_KERNELS = ("wq_ragged", "wq_ragged_grouped", "wq_ragged_a8")


def run_preset_cli(torch, dev, args, runs, kernels, label, counted=()):
    """Phases 9 (c) and 11 (b): each (flags, per_layer) of `runs` through
    the CLI's own build and benchmark (`--benchmark 8 --max-new 32` unless
    the flags say otherwise) at the preset's full width, with its launches,
    tokens, metrics and peak memory checked.  per_layer gives the launches
    a layer by call class: "decode" (a decode step at 8 slots), "small" /
    "mid" / "big" (a prefill call of M <= 64, 64 < M < 256, M >= 256 rows);
    besides, w8_gemv takes an INT8 lm_head once a decode step and a
    prefill call where the vocab is a multiple of 128, and at head_dim 128
    or 256 flash_prefill takes every layer's prefill attention and
    decode_attn2 every layer's decode attention (none under a softcap).
    Returns the launches of the `counted` wrappers summed over the
    runs."""
    import numpy as np

    from piquant_tpu_torch.models import llama as M
    from piquant_tpu_torch.serving import __main__ as S

    total = dict.fromkeys(counted, 0)
    for flags, per_layer in runs:
        argv = ["--benchmark", "8", "--max-new", "32", *flags]
        cli_args = S.build_parser().parse_args(argv)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        cfg, params, eng, sp = S.build(cli_args)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        counts = {"blocks": 0, "prefills": 0, "small": 0, "mid": 0, "big": 0,
                  "flash_prefills": 0}
        alone = set()        # requests whose prefill call held them alone
        dispatch, admit = eng._dispatch_block, eng._admit_one_shot

        def counted_dispatch():
            counts["blocks"] += 1
            return dispatch()

        def counted_admit(batch):
            counts["prefills"] += 1
            width = eng._padded_len(batch[0][2])
            rows = len(batch) * width
            counts["small" if rows <= 64 else "big" if rows >= 256
                   else "mid"] += 1
            counts["flash_prefills"] += width % 128 == 0
            if len(batch) == 1:
                alone.add(batch[0][0].rid)
            return admit(batch)

        eng._dispatch_block, eng._admit_one_shot = (counted_dispatch,
                                                    counted_admit)
        zero_counts()
        t0 = time.perf_counter()
        metrics, done = S.benchmark(cli_args, cfg, eng, sp)
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t0
        wr = kernel_wrappers()
        launches = {k: wr[k].launches for k in kernels}
        nl = cfg.n_layers
        steps = counts["blocks"] * eng.ec.decode_block
        calls = {"decode": steps, "small": counts["small"],
                 "mid": counts["mid"], "big": counts["big"]}
        expect = dict.fromkeys(kernels, 0)
        for cls, per in per_layer.items():
            for k, n in per.items():
                expect[k] += n * nl * calls[cls]
        # the INT8 lm_head's GEMV gate: N % 128, K % 256 (GPT-OSS's d_model
        # 2880 and Llama-4-Scout's vocab 202,048 miss it)
        if (cfg.vocab_size % 128 == 0 and cfg.d_model % 256 == 0
                and hasattr(params["lm_head"], "bits")):
            expect["w8_gemv"] += steps + counts["prefills"]
        if cfg.head_dim in (128, 256):
            # under a softcap decode takes the materialized path
            expect["decode_attn2"] = 0 if cfg.attn_softcap else nl * steps
            expect["flash_prefill"] = nl * counts["flash_prefills"]
        tag = " ".join(flags) or "INT4"
        print(f"{label} [{tag}]: built in {t_build:.1f} s, served in "
              f"{t_run:.1f} s; {counts['blocks']} decode blocks ({steps} "
              f"steps), {counts['prefills']} prefill calls "
              f"({counts['small']} at M <= 64, {counts['mid']} at 64 < M < "
              f"256, {counts['big']} at M >= 256, {counts['flash_prefills']} "
              f"of whole 128-row tiles), launches {launches}, expected "
              f"{expect}", flush=True)
        if launches != expect:
            raise AssertionError(f"{label} [{tag}]: launches {launches} != "
                                 f"{expect}")
        if metrics["completed"] != cli_args.benchmark:
            raise AssertionError(f"{label} [{tag}]: {metrics['completed']} "
                                 f"of {cli_args.benchmark} requests finished")
        for r in done:
            if len(r.tokens) != cli_args.max_new or not all(
                    0 <= t < cfg.vocab_size for t in r.tokens):
                raise AssertionError(f"{label} [{tag}] request {r.rid}: "
                                     "tokens missing or outside the vocab")
            if not all(np.isfinite(lp) and lp <= 0 for lp in r.logprobs):
                raise AssertionError(f"{label} [{tag}] request {r.rid}: "
                                     "non-finite logits")
        # a prompt of >= 256 tokens prefilled alone, generated again alone
        # at the engine's padded width: top-k routing is discontinuous (an
        # ulp of difference in x can flip a token's expert), so the
        # prefill's shapes, and with them its kernels and their sums, stay
        # the same
        r = max((r for r in done if len(r.prompt) >= 256),
                key=lambda r: (r.rid in alone, -r.rid))
        width = eng._padded_len(len(r.prompt))
        want, margins = generate_single(torch, M, cfg, params, r.prompt,
                                        cli_args.max_new, dev, width=width,
                                        max_len=eng.ec.max_seq_len)
        if r.tokens != want:
            print(f"{label} [{tag}]: single-request decode against "
                  f"{eng.ec.batch_slots} rows: " + locate_fork(
                      torch, M, cfg, params, r.prompt, cli_args.max_new, dev,
                      width, eng.ec.max_seq_len, eng.ec.batch_slots),
                  flush=True)
        verdict = check_tokens_guarded(r.tokens, want, margins)
        print(f"{label} [{tag}]: request {r.rid} (prompt {len(r.prompt)}, "
              f"prefilled {'alone' if r.rid in alone else 'in a burst'}) vs "
              f"single-request generation: {verdict}", flush=True)
        # one profiled step where 128 dense-masked experts make it ~230k
        # launches
        profile_decode(torch, M, cfg, params, dev,
                       steps=4 if cfg.n_experts <= 8 else 1)
        print(label.replace(" ", "_") + "_metrics " + json.dumps(
            {"card": card_line(), "flags": tag, **metrics,
             "launches": launches,
             "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30}),
            flush=True)
        for k in total:
            total[k] += launches[k]
        # the counting wrappers close over the engine's bound methods: a
        # reference cycle, freed only by the collector
        del params, eng, done, dispatch, admit
        gc.collect()
        torch.cuda.empty_cache()
    return total


def run_moe(torch, dev, gen, args):
    """Phase 9: the ragged kernels, the two MoE routes, the Mixtral CLI.
    Returns (kernels-line rows, launches of the ragged wrappers in the CLI
    runs)."""
    rows = check_moe_kernels(torch, dev, gen)
    torch.cuda.empty_cache()
    check_moe_routes(torch, dev, args)
    torch.cuda.empty_cache()
    with cut_depth("mixtral_8x7b", CLI_DEPTH):
        return rows, run_preset_cli(torch, dev, args, MOE_CLI_RUNS,
                                    MOE_KERNELS, "moe cli", RAGGED_KERNELS)


# ---------------------------------------------------------------------------
# phase 10: NF4 weights and the kv4 cache
# ---------------------------------------------------------------------------

# NF4 runs: decode steps and prefill calls of at most 64 rows take nf4_gemv
# (7 a layer); larger prefills take the f32 table product (64 < M < 256) or
# the dense bf16 product, neither a kernel.  The kv4 run keeps INT4 weights
# and takes the kv4 form of decode attention (32 launches a decode step).
NF4_KV4_RUNS = (
    (("--bits", "nf4"), _gemv_only({"nf4_gemv": 7})),
    (("--kv-bits", "4"), _gemv_only({"w4_gemv": 7})),
)
# (layers, slots, kv heads, GQA rep, positions, head_dim) of the kv4 check:
# Llama-3-8B's cache at the engine's 2048 positions
KV4_GEOMETRY = (32, 8, 8, 4, 2048, 128)


def check_decode_attn2_kv4(torch, dev, gen):
    """decode_attn2_kv4 against its plain version on a stacked kv4 cache of
    Llama-3-8B's geometry, then its time, the plain version's, SDPA on the
    bf16-dequantized cache and the bound (live code and scale bytes)."""
    import torch.nn.functional as F

    from piquant_tpu_torch.ops.cuda import decode_attn2 as DA
    from piquant_tpu_torch.quant.kv_cache import (merge_scale_pairs,
                                                  unpack4_pairs)

    nl, b, hkv, rep, s, d = KV4_GEOMETRY
    shape = (nl, b, hkv, s // 2, d)
    kc = torch.randint(0, 256, shape, generator=gen, device=dev,
                       dtype=torch.uint8)
    vc = torch.randint(0, 256, shape, generator=gen, device=dev,
                       dtype=torch.uint8)
    sshape = (nl, b, hkv, 2, s // 2)
    ks = torch.rand(sshape, generator=gen, device=dev) * 0.3
    vs = torch.rand(sshape, generator=gen, device=dev) * 0.3
    q = torch.randn((b, hkv, rep, d), generator=gen, device=dev).to(torch.bfloat16)
    # row 0 has no live position (the sentinel); odd positions and odd
    # starts end live windows on either half of a pair row
    pos = torch.tensor([0, 301, 2048, 1000, 1501, 511, 273, 1799],
                       dtype=torch.int32, device=dev)
    start = torch.tensor([0, 0, 0, 0, 1101, 0, 17, 0], dtype=torch.int32,
                         device=dev)
    sm = d ** -0.5
    err = 0.0
    for layer in (0, nl // 2, nl - 1):
        acc, m, l = DA.decode_attn2_kv4(q, kc, ks, vc, vs, pos, start, sm,
                                        layer)
        pacc, pm, pl = DA.decode_attn2_plain(q, kc, ks, vc, vs, pos, start,
                                             sm, layer)
        torch.cuda.synchronize()
        if not (bool((m[0] == -1e30).all()) and bool((l[0] == 0).all())
                and bool((acc[0] == 0).all())):
            raise AssertionError("decode_attn2_kv4: pos=0 row lost the "
                                 "sentinel")
        # the kv8 check's bounds (check_decode_attn2)
        name = f"decode_attn2_kv4 layer {layer}"
        hold(torch, name + " m", m, pm, 1e-5, 1e-5)
        hold(torch, name + " l", l, pl, 0.0, 2e-2)
        e = hold(torch, name + " context", acc[1:] / l[1:],
                 pacc[1:] / pl[1:], 2e-3, 2e-2)
        err = max(err, e)
    print(f"decode_attn2_kv4: max_abs_err (normalized context) {err:.3e}",
          flush=True)
    call = lambda i: DA.decode_attn2_kv4(q, kc, ks, vc, vs, pos,  # noqa: E731
                                         start, sm, i % nl)
    t_k = cuda_ms(call, 64)
    t_e = host_ms(call)
    t_p = cuda_ms(lambda i: DA.decode_attn2_plain(q, kc, ks, vc, vs, pos,
                                                  start, sm, i % nl), 4)
    # yardstick: SDPA over a pre-dequantized bf16 cache of one layer
    kf = (unpack4_pairs(kc[1]).float() * merge_scale_pairs(ks[1])
          ).to(torch.bfloat16)
    vf = (unpack4_pairs(vc[1]).float() * merge_scale_pairs(vs[1])
          ).to(torch.bfloat16)
    idx = torch.arange(s, device=dev)
    mask = ((idx[None] >= start[:, None]) & (idx[None] < pos[:, None])
            | (idx[None] == 0))[:, None, None, :]   # keep row 0 defined
    q4 = q.reshape(b, hkv * rep, 1, d)
    t_l = cuda_ms(lambda i: F.scaled_dot_product_attention(
        q4, kf, vf, attn_mask=mask, enable_gqa=True), 20)
    live_pos = float((pos - start).clamp(min=0).sum())
    nbytes = (live_pos * hkv * (2 * d // 2 + 2 * 4) + q.numel() * 2
              + b * hkv * rep * (d + 2) * 4)
    bnd, by = bound_ms(nbytes, 4 * live_pos * rep * hkv * d)
    print(f"decode_attn2_kv4: kernel {t_k:.4f} ms ({bound_share(t_k, bnd)} "
          f"{bnd:.4f} ms, {by}), sdpa(bf16 cache) {t_l:.4f} ms, plain "
          f"{t_p:.4f} ms, eager {t_e:.4f} ms, live positions {live_pos:.0f} "
          f"[{card_line()}]", flush=True)
    del kc, vc, ks, vs, kf, vf
    return dict(name="decode_attn2_kv4", route="cuda",
                source="piquant_tpu_torch/csrc/decode_attn2.cu",
                replaces="piquant_tpu/ops/pallas/decode_attn2.py:76 (_kernel, "
                         "kv4)",
                max_abs_err=err, ms=t_k, plain_ms=t_p, bound_ms=bnd,
                bound_by=by, library_ms=t_l,
                library_call="scaled_dot_product_attention (bf16 cache)",
                eager_ms=t_e,
                timed="one layer: B=8, Hkv=8, rep=4, S=2048, mixed positions")


def check_nf4_kv4(torch, dev, gen):
    """Phase 10 (a, b): the nf4_gemv row (channelwise, with the grouped
    forms as variants) and the kv4 decode_attn2 row."""
    row = gemv_row(torch, dev, gen, "nf4_gemv", "818 (_nf4_kernel)",
                   "one decode layer at --bits nf4: 7 projections at M=8",
                   "nf4", None, W4_SHAPES, torch.bfloat16, hold_f32=True)
    row["variants"] = {}
    card = card_line()
    for gs in (64, 128):
        r = check_gemv(torch, dev, gen, "nf4_gemv", "nf4", gs, W4_SHAPES,
                       torch.bfloat16, hold_f32=True)
        row["max_abs_err"] = max(row["max_abs_err"], r["max_abs_err"])
        row["variants"][f"NF4-g{gs}, one layer's 7 projections at M=8"] = r
        print(f"nf4_gemv g{gs}: kernel {r['ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"torch.matmul {r['library_ms']:.4f} ms [{card}]", flush=True)
    torch.cuda.empty_cache()
    return [row, check_decode_attn2_kv4(torch, dev, gen)]


# ---------------------------------------------------------------------------
# phase 11: model families (Mistral-7B's window, Qwen2-7B, Qwen3-8B,
# Phi-3-mini, Qwen3-30B-A3B)
# ---------------------------------------------------------------------------

def live_pairs(t: int, window, chunk=None, pos0=0) -> int:
    """(q, k) pairs a causal prefill of t positions attends under a sliding
    window (None: the causal triangle), or under a chunk with row 0 at
    absolute position pos0 (row i attends from its chunk's start)."""
    if chunk is not None:
        i = range(t)
        return sum(q - max(0, (pos0 + q) // chunk * chunk - pos0) + 1
                   for q in i)
    w = t if window is None else min(window, t)
    return w * (w + 1) // 2 + (t - w) * w


# the plain flash function is computed one kv head at a time where the
# scores of all heads would pass this many elements
PLAIN_SLICE = 2**31


def flash_plain(torch, fn, q, k, v, sm, window, softcap, chunk, pos0, sinks):
    """fn (flash_attn_plain or rounding_bound) over the whole tensors, or
    kv head by kv head where their scores would pass PLAIN_SLICE
    elements (Llama-4-Scout's T 9088 at rep 5: 3.3e9)."""
    b, hkv, rep, t, _ = q.shape
    if b * hkv * rep * t * t <= PLAIN_SLICE:
        return fn(q, k, v, sm, window, softcap, chunk, pos0, sinks)
    return torch.cat([
        fn(q[:, h:h + 1], k[:, h:h + 1], v[:, h:h + 1], sm, window, softcap,
           chunk, pos0, None if sinks is None else sinks[h:h + 1])
        for h in range(hkv)], dim=1)


def hold_flash(torch, dev, gen, b, hkv, rep, t, window, iters=10, d=128,
               softcap=None, chunk=None, pos0=None, sinks=False):
    """flash_attn against its plain version at one shape (atol 2e-3, rtol
    2e-2: phase 3's causal bound), then its device ms, the plain
    version's, SDPA's (none under a softcap, which SDPA cannot apply) and
    the bound (the live pairs' operations at the bf16 peak, or the bytes:
    q, k, v read once, the f32 context written once; the softcap's tanh
    is one f32 operation a pair, under 1% of the pair's 4 d).  chunk and
    pos0 (a tuple, one position a row) take Llama-4's chunked mask, sinks
    GPT-OSS's sinks: N(0, 1) for each query head, the first head of each
    kv head's group lifted by 6 so its sink dominates the rows.

    Under a softcap q and k are scaled so the scaled scores have a
    standard deviation of a quarter of the cap: their tails reach it, and
    the capped and uncapped functions must differ beyond the bound.  A
    few keys then dominate a row, and the bound adds two bf16 roundings of
    the probabilities (`rounding_bound`: the kernel and the plain version
    each round them once, against different maxima); the elements beyond
    the stated bound alone are counted and printed.  So do a chunk (the
    first rows of a chunk have few live keys) and the sinks; and each of
    the softcap, the chunk and the sinks must move an element of the plain
    function past that bound."""
    import torch.nn.functional as F

    from piquant_tpu_torch.ops.cuda import flash as FL

    widen = (softcap / 4) ** 0.5 if softcap is not None else 1.0
    q = (torch.randn((b, hkv, rep, t, d), generator=gen, device=dev)
         * widen).to(torch.bfloat16)
    k = (torch.randn((b, hkv, t, d), generator=gen, device=dev)
         * widen).to(torch.bfloat16)
    v = torch.randn((b, hkv, t, d), generator=gen, device=dev).to(torch.bfloat16)
    p0 = (None if pos0 is None
          else torch.tensor(pos0, dtype=torch.int32, device=dev))
    snk = None
    if sinks:
        snk = torch.randn((hkv, rep), generator=gen, device=dev)
        snk[:, 0] += 6.0
    sm = d ** -0.5
    extra = (window, softcap, chunk, p0, snk)
    tag = (f"flash_prefill B={b} Hkv={hkv} rep={rep} T={t} D={d} "
           f"window={window} softcap={softcap}" +
           (f" chunk={chunk} pos0={pos0}" if chunk else "") +
           (" sinks" if sinks else ""))

    def plain(*ex, fn=FL.flash_attn_plain):
        return flash_plain(torch, fn, q, k, v, sm, *ex)

    got = FL.flash_attn(q, k, v, sm, *extra)
    want = plain(*extra)
    if softcap is None and chunk is None and not sinks:
        err = hold(torch, tag, got, want, 2e-3, 2e-2)
    else:
        r2 = 2 * plain(*extra, fn=FL.rounding_bound)
        lim = 2e-3 + 2e-2 * want.abs()
        gap = (got - want).abs()
        err = float(gap.max())
        beyond = int((gap > lim).sum())
        lim += r2
        if not bool(torch.isfinite(got).all()) or bool((gap > lim).any()):
            raise AssertionError(f"{tag} disagrees: max abs err {err}, "
                                 f"{int((gap > lim).sum())} elements "
                                 "beyond the bound with two roundings")
        r2 = float(r2.max())
        del gap
        bites = []
        for i, name in ((1, "cap"), (2, "chunk"), (4, "sinks")):
            if extra[i] is None:
                continue
            off = list(extra)
            off[i] = None
            if i == 2:
                off[3] = None
            bite = float(((plain(*off) - want).abs() - lim).max())
            if bite <= 0:
                raise AssertionError(f"{tag}: the {name} changes no element "
                                     "beyond the bound")
            bites.append(f"the {name} moves an element {bite:.3e} past it")
        print(f"{tag}: {beyond} of {got.numel()} elements beyond the stated "
              f"bound alone, within it plus two roundings (up to "
              f"{r2:.3e}); " + ", ".join(bites), flush=True)
        del lim
    del got, want
    torch.cuda.empty_cache()
    t_k = cuda_ms(lambda i: FL.flash_attn(q, k, v, sm, *extra), iters)
    t_p = event_ms(lambda i: plain(*extra), 1, warmup=1)
    torch.cuda.empty_cache()
    q4 = q.reshape(b, hkv * rep, t, d)
    idx = torch.arange(t, device=dev)
    if softcap is not None:
        t_l, call = None, "none (SDPA applies no softcap)"
    elif window is None and chunk is None and not sinks:
        t_l = cuda_ms(lambda i: F.scaled_dot_product_attention(
            q4, k, v, is_causal=True, enable_gqa=True), iters)
        call = "scaled_dot_product_attention (causal, GQA)"
    elif not sinks:
        # a boolean band (window) or block-diagonal causal (chunk) mask;
        # K/V repeated to the query heads beforehand, so the masked call
        # takes a fused kernel rather than the math path
        band = idx[None] <= idx[:, None]
        if window is not None:
            band = band & (idx[None] > idx[:, None] - window)
        else:
            cid = (p0[:, None].long() + idx) // chunk        # [B, T]
            band = (band & (cid[:, None] == cid[:, :, None]))[:, None]
        kr = k.repeat_interleave(rep, dim=1)
        vr = v.repeat_interleave(rep, dim=1)
        t_l = cuda_ms(lambda i: F.scaled_dot_product_attention(
            q4, kr, vr, attn_mask=band), iters)
        call = ("scaled_dot_product_attention (bool " +
                ("band" if window is not None else "block-diagonal causal")
                + " mask, K/V repeated)")
        del kr, vr, band
    else:
        # the sinks as one more key of zeros with a value of zeros, its
        # score held in a float mask: exp(sink) joins the denominator only
        ok = idx[None] <= idx[:, None]
        if window is not None:
            ok = ok & (idx[None] > idx[:, None] - window)
        if chunk is not None:
            cid = (p0[:, None].long() + idx) // chunk
            ok = (ok & (cid[:, None] == cid[:, :, None]))[:, None]
        mask = torch.zeros(ok.shape[:-1] + (t + 1,), device=dev)
        mask[..., :t].masked_fill_(~ok, float("-inf"))
        mask = mask.expand(b if chunk is not None else 1, hkv * rep, t,
                           t + 1).clone()
        mask[..., t] = snk.reshape(-1)[:, None]
        mask = mask.to(torch.bfloat16)
        zero = torch.zeros((b, hkv * rep, 1, d), dtype=k.dtype, device=dev)
        kr = torch.cat([k.repeat_interleave(rep, dim=1), zero], dim=2)
        vr = torch.cat([v.repeat_interleave(rep, dim=1), zero], dim=2)
        t_l = cuda_ms(lambda i: F.scaled_dot_product_attention(
            q4, kr, vr, attn_mask=mask), iters)
        call = ("scaled_dot_product_attention (K/V repeated with a zero key "
                "and value appended, the sink logits in its column of a "
                "float mask)")
        del kr, vr, mask
    flops = sum(4.0 * d * live_pairs(t, window, chunk, p) * hkv * rep
                for p in (pos0 or (0,) * b))
    nbytes = q.numel() * 2 + 2 * k.numel() * 2 + q.numel() * 4
    bnd, by = bound_ms(nbytes, flops)
    lib = "none" if t_l is None else f"{t_l:.4f} ms"
    print(f"{tag}: max_abs_err {err:.3e}; kernel {t_k:.4f} ms "
          f"({flash_rate(flops, t_k, bnd)}), bound {bnd:.4f} ms ({by}), "
          f"plain {t_p:.4f} ms, sdpa {lib} [{card_line()}]", flush=True)
    del q, k, v
    torch.cuda.empty_cache()
    return dict(max_abs_err=err, ms=t_k, plain_ms=t_p, bound_ms=bnd,
                bound_by=by, library_ms=t_l, library_call=call,
                tflops=flops / (t_k * 1e9), bound_share=bnd / t_k)


def hold_decode(torch, dev, gen, kv4, geometry, pos, start, d=128):
    """decode_attn2 (kv8) or decode_attn2_kv4 against its plain version on a
    stacked cache of `geometry` (layers, slots, kv heads, rep, positions)
    with the live windows [start, pos), at three layers (m to 1e-5, l
    within 2e-2, the normalized context within atol 2e-3, rtol 2e-2: the
    phase 3 bounds); then its device ms, the plain version's, SDPA's on a
    bf16-dequantized slice of one layer's cache (positions up to the
    largest pos, the live windows as a mask) and the bound (live code and
    scale bytes)."""
    import torch.nn.functional as F

    from piquant_tpu_torch.ops.cuda import decode_attn2 as DA
    from piquant_tpu_torch.quant.kv_cache import (merge_scale_pairs,
                                                  unpack4_pairs)

    nl, b, hkv, rep, s = geometry
    if kv4:
        shape, sshape = (nl, b, hkv, s // 2, d), (nl, b, hkv, 2, s // 2)
        kc, vc = (torch.randint(0, 256, shape, generator=gen, device=dev,
                                dtype=torch.uint8) for _ in range(2))
    else:
        shape, sshape = (nl, b, hkv, s, d), (nl, b, hkv, s, 1)
        kc, vc = (torch.randint(-127, 128, shape, generator=gen, device=dev,
                                dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand(sshape, generator=gen, device=dev) * 0.02
              for _ in range(2))
    q = torch.randn((b, hkv, rep, d), generator=gen, device=dev).to(torch.bfloat16)
    pos = torch.tensor(pos, dtype=torch.int32, device=dev)
    start = torch.tensor(start, dtype=torch.int32, device=dev)
    kern = DA.decode_attn2_kv4 if kv4 else DA.decode_attn2
    name = (f"{'decode_attn2_kv4' if kv4 else 'decode_attn2'} {geometry}"
            f" D={d}")
    sm = d ** -0.5
    err = 0.0
    for layer in (0, nl // 2, nl - 1):
        acc, m, l = kern(q, kc, ks, vc, vs, pos, start, sm, layer)
        pacc, pm, pl = DA.decode_attn2_plain(q, kc, ks, vc, vs, pos, start,
                                             sm, layer)
        hold(torch, f"{name} layer {layer} m", m, pm, 1e-5, 1e-5)
        hold(torch, f"{name} layer {layer} l", l, pl, 0.0, 2e-2)
        err = max(err, hold(torch, f"{name} layer {layer} context",
                            acc / l, pacc / pl, 2e-3, 2e-2))
    t_k = cuda_ms(lambda i: kern(q, kc, ks, vc, vs, pos, start, sm, i % nl),
                  64)
    t_p = event_ms(lambda i: DA.decode_attn2_plain(
        q, kc, ks, vc, vs, pos, start, sm, i % nl), 4)
    hi = int(pos.max())
    kl, vl, ksl, vsl = kc[1], vc[1], ks[1], vs[1]
    if kv4:
        kl, vl = unpack4_pairs(kl), unpack4_pairs(vl)
        ksl, vsl = merge_scale_pairs(ksl), merge_scale_pairs(vsl)
    kf = (kl[:, :, :hi].float() * ksl[:, :, :hi]).to(torch.bfloat16)
    vf = (vl[:, :, :hi].float() * vsl[:, :, :hi]).to(torch.bfloat16)
    idx = torch.arange(hi, device=dev)
    mask = ((idx[None] >= start[:, None])
            & (idx[None] < pos[:, None]))[:, None, None, :]
    q4 = q.reshape(b, hkv * rep, 1, d)
    t_l = cuda_ms(lambda i: F.scaled_dot_product_attention(
        q4, kf, vf, attn_mask=mask, enable_gqa=True), 20)
    live = float((pos - start).clamp(min=0).sum())
    nbytes = (live * hkv * (2 * d // (2 if kv4 else 1) + 2 * 4)
              + q.numel() * 2 + b * hkv * rep * (d + 2) * 4)
    bnd, by = bound_ms(nbytes, 4 * live * rep * hkv * d)
    print(f"{name}: max_abs_err (normalized context) {err:.3e}; kernel "
          f"{t_k:.4f} ms ({bound_share(t_k, bnd)} {bnd:.4f} ms, {by}), "
          f"sdpa(bf16 cache slice) {t_l:.4f} ms, plain {t_p:.4f} ms, live "
          f"positions {live:.0f} [{card_line()}]", flush=True)
    del kc, vc, ks, vs, kf, vf
    torch.cuda.empty_cache()
    return dict(max_abs_err=err, ms=t_k, plain_ms=t_p, bound_ms=bnd,
                bound_by=by, library_ms=t_l,
                library_call="scaled_dot_product_attention (bf16 cache "
                             "slice, live windows as a mask)")


# Mistral-7B's decode cache: 32 layers, 8 slots, 8 kv heads, rep 4, its
# max_seq_len of 8192; positions past its 4096 window, so every row's start
# is past 0 (odd and even starts)
MISTRAL_CACHE = (32, 8, 8, 4, 8192)
MISTRAL_POS = (4100, 4101, 5003, 6016, 8190, 7001, 4500, 8192)
# Qwen2-7B's: 28 layers, 4 kv heads, rep 7, the CLI's 2048 positions
QWEN2_CACHE = (28, 8, 4, 7, 2048)
QWEN2_POS = (1, 300, 2047, 1000, 1501, 511, 273, 2048)
# Qwen3-30B-A3B's: 48 layers, 4 kv heads, rep 8
A3B_CACHE = (48, 8, 4, 8, 2048)
# (K, N, uses per decode layer) of each family's INT4 projections at decode:
# q, k, v, o, then w1 / w3 and w2 (A3B: its 128 experts dense-masked)
FAMILY_SHAPES = (
    ("Qwen2-7B", ((3584, 3584, 2), (3584, 512, 2), (3584, 18944, 2),
                  (18944, 3584, 1))),
    ("Qwen3-8B", ((4096, 4096, 2), (4096, 1024, 2), (4096, 12288, 2),
                  (12288, 4096, 1))),
    ("Phi-3-mini", ((3072, 3072, 4), (3072, 8192, 2), (8192, 3072, 1))),
    ("Qwen3-30B-A3B", ((2048, 4096, 1), (2048, 512, 2), (4096, 2048, 1),
                       (2048, 768, 256), (768, 2048, 128))),
)
# Qwen3-30B-A3B's routed prefill: 128 experts, top 8, width 2048; (K, N,
# calls per MoE layer) of its expert projections: w1 / w3, w2
A3B_E, A3B_K, A3B_D = 128, 8, 2048
A3B_MOE_SHAPES = ((2048, 768, 2), (768, 2048, 1))


def check_family_kernels(torch, dev, gen, rows):
    """Phase 11 (a): the flash kernel's window branch and odd reps, the
    decode kernels at Mistral-7B's window starts, Qwen2-7B's rep 7 and
    Qwen3-30B-A3B's rep 8, w4_gemv at each family's decode shapes and
    wq_ragged at Qwen3-30B-A3B's 128 experts, each as a variant of its
    kernels-line row in `rows`."""
    by_name = {r["name"]: r for r in rows}

    def add(name, what, res):
        row = by_name[name]
        row.setdefault("variants", {})[what] = res
        row["max_abs_err"] = max(row["max_abs_err"], res["max_abs_err"])

    add("flash_prefill", "Mistral-7B window: B=1, Hkv=8, rep=4, T=6144, "
        "window 4096", hold_flash(torch, dev, gen, 1, 8, 4, 6144, 4096, 5))
    add("flash_prefill", "a window off the 128-key tiles: B=2, Hkv=8, "
        "rep=4, T=2048, window 1000", hold_flash(torch, dev, gen, 2, 8, 4,
                                                 2048, 1000))
    add("flash_prefill", "Qwen2-7B: B=8, Hkv=4, rep=7, T=1024, causal",
        hold_flash(torch, dev, gen, 8, 4, 7, 1024, None))
    add("flash_prefill", "rep 8 beside it: B=8, Hkv=4, rep=8, T=1024, "
        "causal", hold_flash(torch, dev, gen, 8, 4, 8, 1024, None))
    w = 4096
    starts = tuple(max(p - (w - 1), 0) for p in MISTRAL_POS)
    add("decode_attn2", "Mistral-7B window: L=32, B=8, Hkv=8, rep=4, "
        "S=8192, positions past 4096", hold_decode(
            torch, dev, gen, False, MISTRAL_CACHE, MISTRAL_POS, starts))
    add("decode_attn2_kv4", "Mistral-7B window: L=32, B=8, Hkv=8, rep=4, "
        "S=8192, positions past 4096", hold_decode(
            torch, dev, gen, True, MISTRAL_CACHE, MISTRAL_POS, starts))
    add("decode_attn2", "Qwen2-7B: L=28, B=8, Hkv=4, rep=7, S=2048",
        hold_decode(torch, dev, gen, False, QWEN2_CACHE, QWEN2_POS,
                    (0,) * len(QWEN2_POS)))
    add("decode_attn2", "Qwen3-30B-A3B: L=48, B=8, Hkv=4, rep=8, S=2048",
        hold_decode(torch, dev, gen, False, A3B_CACHE, QWEN2_POS,
                    (0,) * len(QWEN2_POS)))
    for family, shapes in FAMILY_SHAPES:
        res = check_gemv(torch, dev, gen, "w4_gemv", 4, None, shapes,
                         torch.bfloat16)
        print(f"w4_gemv {family} layer: kernel {res['ms']:.4f} ms, bound "
              f"{res['bound_ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, "
              f"torch.matmul {res['library_ms']:.4f} ms [{card_line()}]",
              flush=True)
        add("w4_gemv", f"{family}: one decode layer's projections at M=8",
            res)
        torch.cuda.empty_cache()
    r, counts, ends = moe_routing(torch, dev, gen, MOE_T, A3B_E, A3B_K,
                                  A3B_D)
    used = int((counts > 0).sum())
    print(f"a3b moe: {MOE_T} tokens routed top {A3B_K} of {A3B_E}: "
          f"{used} experts with a token, m_pad {r.m_pad}", flush=True)
    if int(counts[0]) or used < A3B_E // 2:
        raise AssertionError("a3b moe: the routing lost its zero-token "
                             "expert or spreads over too few experts")
    res = check_ragged(torch, dev, gen, "wq_ragged", 4, None, r, counts,
                       ends, A3B_MOE_SHAPES)
    print(f"wq_ragged Qwen3-30B-A3B: kernel {res['ms']:.4f} ms, bound "
          f"{res['bound_ms']:.4f} ms ({res['bound_by']}), plain "
          f"{res['plain_ms']:.4f} ms, {res['library_call']} "
          f"{res['library_ms']:.4f} ms; {res['routed_rows']} routed, "
          f"{res['live_rows']} live of {r.m_pad} rows: "
          f"{res['tflops_routed']:.1f} / {res['tflops_live']:.1f} TFLOP/s "
          f"[one MoE layer, {MOE_T} tokens; {card_line()}]", flush=True)
    add("wq_ragged", f"Qwen3-30B-A3B INT4: {A3B_E} experts, top {A3B_K}, "
        f"(K, N) (2048, 768) and (768, 2048), {MOE_T} tokens, m_pad "
        f"{r.m_pad}", res)
    torch.cuda.empty_cache()


def _dense7(per_layer=7):
    """Launches a layer of a dense INT4 model: the seven projections take
    w4_gemv at decode and in prefill calls of at most 64 rows."""
    return {"decode": {"w4_gemv": per_layer}, "small": {"w4_gemv": per_layer},
            "mid": {}, "big": {}}


# each preset's CLI flags and its launches a layer by call class (see
# run_preset_cli)
FAMILY_RUNS = (
    (("--random", "mistral_7b"), _dense7()),
    (("--random", "qwen2_7b"), _dense7()),
    (("--random", "qwen3_8b"), _dense7()),
    (("--random", "phi3_mini"), _dense7()),
)
# Qwen3-30B-A3B's decode runs its 128 experts dense-masked (3 GEMVs each
# besides the 4 attention ones), every prefill ragged.  Its CLI run serves
# A3B_DEPTH of its 48 layers at full width (8 until phase 18 needed the
# time): a full-depth decode step takes seconds of host launches, 32 steps
# of them the run's time limit; one full-depth step is profiled on its
# own.
A3B_RUN = (("--random", "qwen3_moe_a3b", "--benchmark", "4", "--max-new",
            "8"),
           {"decode": {"w4_gemv": 4 + 3 * 128},
            "small": {"w4_gemv": 4, "wq_ragged": 3}, "mid": {"wq_ragged": 3},
            "big": {"wq_ragged": 3}})
A3B_DEPTH = 4
FAMILY_KERNELS = ("w4_gemv", "w8_gemv", "wq_ragged", "decode_attn2",
                  "flash_prefill")


LONG_PROMPT, LONG_NEW = 6000, 32


def run_long(torch, dev, args, preset, prompt_len, max_seq_len, label,
             n_new=None):
    """One long request at batch 1 on a full-width preset (random INT4
    codes, the INT8 lm_head): a prompt of `prompt_len` tokens from the seed
    prefills through flash at its padded width T, each layer with its own
    window or chunk (and the softcap), and n_new greedy tokens decode with
    the starts of each layer's window (pos - w + 1) or chunk (pos // C * C)
    on every windowed or chunked layer, past 0, and none on a full one
    (under a softcap: the materialized decode, no decode_attn2 launch);
    launches, windows, chunks and starts are checked by spies on the
    model's two attention entry points, and the tokens against
    single-request generation (n_new: LONG_NEW by default)."""
    import numpy as np

    from piquant_tpu_torch.models import llama as M
    from piquant_tpu_torch.ops.cuda import decode_attn2 as DA
    from piquant_tpu_torch.ops.cuda import flash as FL
    from piquant_tpu_torch.serving import (Engine, EngineConfig, Request,
                                           SamplingParams)

    n_new = n_new or LONG_NEW
    cfg = getattr(M.LlamaConfig, preset)()
    params = M.random_quantized_params(cfg, seed=args.seed, lm_head_bits=8,
                                       device=dev)
    ec = EngineConfig(batch_slots=1, max_seq_len=max_seq_len)
    eng = Engine(cfg, params, ec, rng_seed=args.seed, device=dev)
    rng = np.random.default_rng(args.seed)
    prompt = [int(t) for t in rng.integers(1, cfg.vocab_size, prompt_len)]
    seen = {"windows": [], "starts": []}
    flash0, state0 = M.flash_prefill_masked, M.decode_attention_state

    def flash_spy(q, *a, **kw):
        seen["windows"].append((q.shape[-2], (kw.get("window"),
                                              kw.get("chunk")),
                                kw.get("softcap")))
        return flash0(q, *a, **kw)

    def state_spy(*a, **kw):
        seen["starts"].append((kw["layer"], a[5], kw.get("starts")))
        return state0(*a, **kw)

    blocks = []
    dispatch = eng._dispatch_block
    eng._dispatch_block = lambda: (blocks.append(1), dispatch())[1]
    M.flash_prefill_masked, M.decode_attention_state = flash_spy, state_spy
    torch.cuda.reset_peak_memory_stats()
    try:
        eng.submit(Request(rid=0, prompt=prompt,
                           sampling=SamplingParams(max_new_tokens=n_new)))
        zero_counts()
        t0 = time.perf_counter()
        done = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"flash_prefill": FL.flash_attn.launches,
                    "decode_attn2": DA.decode_attn2.launches}
    finally:
        M.flash_prefill_masked, M.decode_attention_state = flash0, state0
    width = eng._padded_len(prompt_len)
    steps = len(blocks) * ec.decode_block
    nl = cfg.n_layers
    decoded = 0 if cfg.attn_softcap else nl * steps
    expect = {"flash_prefill": nl, "decode_attn2": decoded}
    windows = sorted(set(seen["windows"]), key=str)
    want_windows = sorted({(width, cfg.layer_window(i), cfg.attn_softcap)
                           for i in range(nl)}, key=str)
    local = [(li, pos, st) for li, pos, st in seen["starts"]
             if cfg.layer_window(li) != (None, None)]
    full = [st for li, _, st in seen["starts"]
            if cfg.layer_window(li) == (None, None)]
    least = min((int(st.min()) for _, _, st in local if st is not None),
                default=None)
    chunked = sum(w[1][1] is not None for w in seen["windows"])
    print(f"{label}: prompt {prompt_len} (padded to {width}), "
          f"{len(blocks)} decode blocks ({steps} steps), launches "
          f"{launches}, expected {expect}; flash (T, (window, chunk), "
          f"softcap) {windows}, {chunked} chunked; "
          f"{len(seen['starts'])} decode calls, {len(local)} on "
          f"windowed or chunked layers (least start {least}), {len(full)} "
          f"on full ones", flush=True)
    if launches != expect:
        raise AssertionError(f"{label}: launches {launches} != {expect}")
    if windows != want_windows or len(seen["windows"]) != nl:
        raise AssertionError(f"{label}: flash took {windows}")
    if len(seen["starts"]) != decoded:
        raise AssertionError(f"{label}: {len(seen['starts'])} decode calls")
    for li, pos, st in local:
        w, c = cfg.layer_window(li)
        want = (pos // c * c) if c is not None else (pos - (w - 1)).clamp(
            min=0)
        if st is None or int(st.min()) <= 0 or not torch.equal(st, want):
            raise AssertionError(f"{label}: layer {li}'s decode at {pos} "
                                 f"took starts {st}, not {want} past 0")
    if any(st is not None for st in full):
        raise AssertionError(f"{label}: a full layer's decode with starts")
    (r,) = done
    if len(r.tokens) != n_new or not all(
            0 <= t < cfg.vocab_size for t in r.tokens):
        raise AssertionError(f"{label}: tokens missing or outside the vocab")
    m = eng.metrics.to_dict()
    peak = torch.cuda.max_memory_allocated() / 2**30
    want, margins = generate_single(torch, M, cfg, params, prompt, n_new,
                                    dev, width=width, max_len=ec.max_seq_len)
    verdict = check_tokens_guarded(r.tokens, want, margins)
    print(f"{label}: vs single-request generation: {verdict}", flush=True)
    print(label.replace(" ", "_") + "_metrics " + json.dumps(
        {"card": card_line(), **m, "wall_s": wall, "peak_mem_gb": peak,
         "launches": launches}), flush=True)
    del params, eng, done, dispatch
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def run_families(torch, dev, gen, args, rows):
    """Phase 11: the kernel holds, the five presets through the CLI, the
    long Mistral-7B request."""
    from piquant_tpu_torch.models import llama as M

    check_family_kernels(torch, dev, gen, rows)
    with contextlib.ExitStack() as cuts:
        for flags, _ in FAMILY_RUNS:
            cuts.enter_context(cut_depth(flags[1], CLI_DEPTH))
        run_preset_cli(torch, dev, args, FAMILY_RUNS, FAMILY_KERNELS,
                       "family cli")
    with cut_depth("qwen3_moe_a3b", A3B_DEPTH):
        run_preset_cli(torch, dev, args, (A3B_RUN,), FAMILY_KERNELS,
                       "family cli")
    cfg = M.LlamaConfig.qwen3_moe_a3b()
    params = M.random_quantized_params(cfg, seed=args.seed, lm_head_bits=8,
                                       device=dev)
    print(f"qwen3_moe_a3b at all {cfg.n_layers} layers, one decode step at "
          "batch 8:", flush=True)
    profile_decode(torch, M, cfg, params, dev, steps=1)
    del params
    torch.cuda.empty_cache()
    run_long(torch, dev, args, "mistral_7b", LONG_PROMPT, 8192,
             "long mistral")


# ---------------------------------------------------------------------------
# phase 12: Gemma-1, Gemma-2 and Gemma-3 (head_dim 256, the softcap)
# ---------------------------------------------------------------------------

# decode caches of head_dim 256: Gemma-2B (18 layers, 1 kv head, rep 8),
# Gemma-7B (28 layers, 16 kv heads, rep 1) at the CLI's 2048 positions, and
# Gemma-3-12B (48 layers, 8 kv heads, rep 2) at 4096 positions with its
# 1024 window's starts past 0 on every row
GEMMA2B_CACHE = (18, 8, 1, 8, 2048)
GEMMA7B_CACHE = (28, 8, 16, 1, 2048)
GEMMA3_CACHE = (48, 8, 8, 2, 4096)
GEMMA3_POS = (1100, 1101, 2003, 3016, 4090, 3001, 1500, 4096)
# each preset's CLI flags (random INT4 codes and the INT8 lm_head, gemma_2b
# quantized from a float init with its bf16 lm_head, as the reference CLI
# builds them) and its launches a layer by call class (see run_preset_cli)
GEMMA_RUNS = tuple(
    (("--random", preset, "--benchmark", "4", "--max-new", "8"), _dense7())
    for preset in ("gemma_2b", "gemma_7b", "gemma2_9b", "gemma3_12b"))
GEMMA_KERNELS = ("w4_gemv", "w8_gemv", "decode_attn2", "flash_prefill")
# Depth of the Gemma CLI runs since phase 13 came (full width): 6 layers
# keep Gemma-2's alternation (even) and Gemma-3's 5:1 pattern (a multiple
# of 6); the long requests serve the full depth
GEMMA_DEPTH = 6
# the long requests: (preset, prompt tokens, max_seq_len); Gemma-3's prompt
# pads to 3072 positions, whole 128-row tiles, so its prefill takes flash
# with the 1024 window biting
GEMMA_LONG = (("gemma2_9b", LONG_PROMPT, 8192), ("gemma3_12b", 3060, 4096))


def check_gemma_kernels(torch, dev, gen, rows):
    """Phase 12 (a): the flash kernel at head_dim 256 on each Gemma
    preset's prefill shapes (Gemma-2's softcap of 50 on local and global
    layers, Gemma-3's 1024 window, Gemma-2B's rep 8, Gemma-7B's rep 1) and
    its softcap at head_dim 128; decode_attn2 kv8 and kv4 at head_dim 256
    at rep 8, rep 1 and Gemma-3's rep 2 with window starts; each as a
    variant of its kernels-line row in `rows`."""
    by_name = {r["name"]: r for r in rows}

    def add(name, what, res):
        row = by_name[name]
        row.setdefault("variants", {})[what] = res
        row["max_abs_err"] = max(row["max_abs_err"], res["max_abs_err"])

    for what, shape in (
            ("Gemma-2-9B local: B=1, Hkv=8, rep=2, T=6144, D=256, window "
             "4096, softcap 50", (1, 8, 2, 6144, 4096, 5, 256, 50.0)),
            ("Gemma-2-9B global: B=2, Hkv=8, rep=2, T=2048, D=256, causal, "
             "softcap 50", (2, 8, 2, 2048, None, 10, 256, 50.0)),
            ("Gemma-3-12B local: B=1, Hkv=8, rep=2, T=4096, D=256, window "
             "1024", (1, 8, 2, 4096, 1024, 10, 256, None)),
            ("Gemma-2B: B=8, Hkv=1, rep=8, T=1024, D=256, causal",
             (8, 1, 8, 1024, None, 10, 256, None)),
            ("Gemma-7B: B=4, Hkv=16, rep=1, T=1024, D=256, causal",
             (4, 16, 1, 1024, None, 10, 256, None)),
            ("the softcap at D=128: B=8, Hkv=8, rep=4, T=1024, causal, "
             "softcap 50", (8, 8, 4, 1024, None, 10, 128, 50.0))):
        b, hkv, rep, t, window, iters, d, cap = shape
        add("flash_prefill", what, hold_flash(torch, dev, gen, b, hkv, rep, t,
                                              window, iters, d, cap))
    zeros = (0,) * len(QWEN2_POS)
    starts = tuple(max(p - 1023, 0) for p in GEMMA3_POS)
    for kv4, name in ((False, "decode_attn2"), (True, "decode_attn2_kv4")):
        for what, geometry, pos, start in (
                ("Gemma-2B: L=18, B=8, Hkv=1, rep=8, S=2048, D=256",
                 GEMMA2B_CACHE, QWEN2_POS, zeros),
                ("Gemma-7B: L=28, B=8, Hkv=16, rep=1, S=2048, D=256",
                 GEMMA7B_CACHE, QWEN2_POS, zeros),
                ("Gemma-3-12B local: L=48, B=8, Hkv=8, rep=2, S=4096, D=256, "
                 "window 1024", GEMMA3_CACHE, GEMMA3_POS, starts)):
            add(name, what, hold_decode(torch, dev, gen, kv4, geometry, pos,
                                        start, d=256))


def run_gemma(torch, dev, gen, args, rows):
    """Phase 12: the kernel holds, the four Gemma presets through the CLI
    at full width and depth, and two long requests at batch 1 (Gemma-2-9B:
    6000 tokens, the windowed softcap flash on local layers and the causal
    softcap flash on global ones, the materialized decode; Gemma-3-12B:
    3060 tokens, the windowed flash on local layers, decode starts past 0
    on every local layer and none on the global ones).  Returns the launches of flash_prefill and decode_attn2
    in the CLI runs and the long requests."""
    check_gemma_kernels(torch, dev, gen, rows)
    with contextlib.ExitStack() as cuts:
        for flags, _ in GEMMA_RUNS:
            cuts.enter_context(cut_depth(flags[1], GEMMA_DEPTH))
        total = run_preset_cli(torch, dev, args, GEMMA_RUNS, GEMMA_KERNELS,
                               "gemma cli", ("flash_prefill", "decode_attn2"))
    for preset, n, max_len in GEMMA_LONG:
        got = run_long(torch, dev, args, preset, n, max_len,
                       f"long {preset}")
        for k in total:
            total[k] += got[k]
    return total


# ---------------------------------------------------------------------------
# phase 13: Llama-4-Scout and GPT-OSS-20B (the chunk and sinks branches)
# ---------------------------------------------------------------------------

# the flash holds: what, (B, Hkv, rep, T, timed iterations, head_dim), and
# the options (a softcap, a chunk with each row's pos0, sinks)
L4_FLASH = (
    ("Llama-4-Scout chunk: B=1, Hkv=8, rep=5, T=9088, D=128, chunk 8192, "
     "pos0 0", (1, 8, 5, 9088, 5, 128), dict(chunk=8192, pos0=(0,))),
    ("Llama-4-Scout chunk, pos0 4000 (a boundary at row 4192)",
     (1, 8, 5, 9088, 5, 128), dict(chunk=8192, pos0=(4000,))),
    ("a chunk at D=256: B=1, Hkv=8, rep=2, T=4096, chunk 1024, pos0 300",
     (1, 8, 2, 4096, 10, 256), dict(chunk=1024, pos0=(300,))),
    ("sinks at GPT-OSS's geometry with D=128: B=2, Hkv=8, rep=8, T=2048, "
     "causal", (2, 8, 8, 2048, 10, 128), dict(sinks=True)),
    ("sinks with window 128: B=2, Hkv=8, rep=8, T=2048, D=128",
     (2, 8, 8, 2048, 10, 128), dict(sinks=True, window=128)),
    ("sinks with a chunk: B=2, Hkv=8, rep=8, T=2048, D=128, chunk 1024, "
     "pos0 0 and 500", (2, 8, 8, 2048, 10, 128),
     dict(sinks=True, chunk=1024, pos0=(0, 500))),
    ("sinks with softcap 50: B=2, Hkv=8, rep=8, T=2048, D=128, causal",
     (2, 8, 8, 2048, 10, 128), dict(sinks=True, softcap=50.0)),
)
# each preset's CLI run and its launches a layer by call class (see
# run_preset_cli): Scout's 16 experts dense-masked at every M (the
# reference declines the ragged route under moe_input_scaled), so a
# decode step or a prefill of at most 64 rows takes 4 attention, 48
# expert and 3 shared-expert GEMVs a layer; GPT-OSS none (head_dim 64,
# d_model 2880: every gate declines)
L4_RUNS = ((("--random", "llama4_scout", "--benchmark", "4", "--max-new",
             "8"),
            {"decode": {"w4_gemv": 55}, "small": {"w4_gemv": 55}, "mid": {},
             "big": {}}),
           (("--random", "gpt_oss_20b", "--benchmark", "4", "--max-new", "8"),
            {"decode": {}, "small": {}, "mid": {}, "big": {}}))
L4_KERNELS = ("w4_gemv", "w8_gemv", "w2_gemv", "wg_chunk", "w4_grouped",
              "nf4_gemv", "wq_ragged", "decode_attn2", "flash_prefill")
# GPT-OSS's CLI run serves 4 of its 24 layers (8 until phase 18 needed
# the time; its alternation kept, full width): every product of it runs
# off the kernels, about 59k launches a full-depth decode step, and the
# run's time limit needs the time.  Scout's CLI run serves 8 of its 48
# layers (full depth until phase 18; its nope layer every 4th kept, full
# width); its long request serves the full depth.
GPT_OSS_DEPTH = 4
SCOUT_DEPTH = 8
# Scout's long request: 9060 tokens pad to 9088 (the CLI's prefill_pad of
# 64; whole 128-row tiles, so flash takes it), past position 8191, where
# the chunk and the temperature bite; a few decode tokens
SCOUT_LONG, SCOUT_MAX_LEN, SCOUT_NEW = 9060, 10240, 16


def run_llama4_gpt_oss(torch, dev, gen, args, rows):
    """Phase 13: the flash holds as variants of the flash_prefill row in
    `rows`, Scout through the CLI and its long request, GPT-OSS through
    the CLI; each model freed before the next is built.  Returns the
    launches of flash_prefill, decode_attn2 and w4_gemv in these runs."""
    row = next(r for r in rows if r["name"] == "flash_prefill")
    for what, (b, hkv, rep, t, iters, d), opt in L4_FLASH:
        res = hold_flash(torch, dev, gen, b, hkv, rep, t, opt.get("window"),
                         iters, d, opt.get("softcap"), opt.get("chunk"),
                         opt.get("pos0"), opt.get("sinks", False))
        row["variants"][what] = res
        row["max_abs_err"] = max(row["max_abs_err"], res["max_abs_err"])
    counted = ("flash_prefill", "decode_attn2", "w4_gemv")
    with cut_depth("llama4_scout", SCOUT_DEPTH):
        total = run_preset_cli(torch, dev, args, L4_RUNS[:1], L4_KERNELS,
                               "llama4 cli", counted)
    got = run_long(torch, dev, args, "llama4_scout", SCOUT_LONG,
                   SCOUT_MAX_LEN, "long llama4_scout", SCOUT_NEW)
    for k in got:
        total[k] += got[k]
    with cut_depth("gpt_oss_20b", GPT_OSS_DEPTH):
        got = run_preset_cli(torch, dev, args, L4_RUNS[1:], L4_KERNELS,
                             "gpt-oss cli", counted)
    for k in got:
        total[k] += got[k]
    return total


# ---------------------------------------------------------------------------
# phase 14: fused projections, the fused MLP, the first flash-decode kernel
# and the rest of the engine
# ---------------------------------------------------------------------------

# the reference's switches of the two kernels' routes, as the engine run
# sets them: the fused MLP, the non-deferred append, the v1 decode kernel
SWITCHES = {"PIQUANT_MLP_FUSE": "1", "PIQUANT_DEFER_APPEND": "0",
            "PIQUANT_TPU_PALLAS_ATTN": "1"}


@contextlib.contextmanager
def switched(on: bool = True):
    """The three switches on (or off, the reference's defaults) while the
    block runs; their earlier values after."""
    old = {k: os.environ.get(k) for k in SWITCHES}
    for k, v in SWITCHES.items():
        if on:
            os.environ[k] = v
        else:
            os.environ.pop(k, None)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# (K, I, N, activation, model) of the fused MLP's holds: Llama-3-8B's
# SwiGLU and Gemma-7B's GeGLU
MLP_FUSED_SHAPES = ((4096, 14336, 4096, "silu", "Llama-3-8B"),
                    (3072, 24576, 3072, "gelu", "Gemma-7B"))
MLP_FUSED_M = (8, 1, 33, 64)
MLP_TIMED_M = (8, 1, 64)      # the timed calls: M = 8 is the kernels line's


def check_mlp_fused(torch, dev, gen):
    """mlp_fused against its plain version at each MLP of MLP_FUSED_SHAPES,
    M in MLP_FUSED_M, f32 and bf16 output (GEMV tolerance: atol 2e-2, rtol
    1e-2), each call made twice and the two bit-equal (a fixed summation
    order); zero points drawn over 0-15, so a kernel that drops a fold
    fails.  Every call passes no row sums of x, as the dispatch
    (mlp_fused_matmul) does: the kernel sums its staged x (the caller's
    sums are held in tests/test_torch_cuda.py).  Then, at each M of
    MLP_TIMED_M (bf16 out, two weight copies: 176 MB streamed from HBM,
    not L2), its device ms, the port's two-kernel route on the same weights
    and the same operands (w4_gemv on w13 with no row sums, the activation,
    w4_gemv on w2 with none: the dispatch's A/B), the eager host cost and
    the bound; at M = 8 also the plain version's ms.  No single PyTorch
    call computes the function: library_ms is null."""
    from piquant_tpu_torch.ops.cuda import qmatmul as Q

    err, variants, main = 0.0, {}, None
    for k, i_ff, n, act, label in MLP_FUSED_SHAPES:
        copies = 2
        ws = [(random_qlin(torch, dev, gen, k, 2 * i_ff, 4, None),
               random_qlin(torch, dev, gen, i_ff, n, 4, None))
              for _ in range(copies)]
        if bool((ws[0][1].zero_point == 8).all()):
            raise AssertionError("mlp_fused: every zero point is 8")

        def ops(x, c=0):
            w13, w2 = ws[c]
            return (x, w13.data, w13.scale.reshape(-1),
                    w13.zero_point.reshape(-1), w2.data, w2.scale.reshape(-1),
                    w2.zero_point.reshape(-1), None, act)

        for m in MLP_FUSED_M:
            x = torch.randn((m, k), generator=gen, device=dev).to(
                torch.bfloat16)
            for odt in (torch.float32, torch.bfloat16):
                got = Q.mlp_fused(*ops(x), odt)
                if not torch.equal(got, Q.mlp_fused(*ops(x), odt)):
                    raise AssertionError("mlp_fused: two runs on the same "
                                         "inputs differ")
                e = hold(torch, f"mlp_fused {label} M={m} {odt}", got.float(),
                         Q.mlp_fused_plain(*ops(x), odt).float(), 2e-2, 1e-2)
                err = max(err, e)
        print(f"mlp_fused {label}: max_abs_err {err:.3e} at M {MLP_FUSED_M}, "
              "f32 and bf16, runs bit-equal", flush=True)
        for m in MLP_TIMED_M:
            res = time_mlp_fused(torch, dev, gen, Q, ops, copies, m, k, i_ff,
                                 n, act, label)
            if m == MLP_TIMED_M[0]:
                main = main or res
                variants[label] = res
            else:
                variants[f"{label} M={m}"] = res
        del ws
    return dict(name="mlp_fused", route="cuda",
                source="piquant_tpu_torch/csrc/qmatmul_mlp.cu",
                replaces="piquant_tpu/ops/pallas/qmatmul.py:1200 "
                         "(_mlp_fused_kernel)",
                max_abs_err=err, library_ms=None, **main,
                timed="Llama-3-8B MLP (K 4096, I 14336, N 4096) at M=8, "
                      "bf16 out", variants=variants)


def time_mlp_fused(torch, dev, gen, Q, ops, copies, m, k, i_ff, n, act,
                   label):
    """Device ms of mlp_fused at M = m (bf16 out, the operands of `ops`,
    cycling over `copies` weight copies), of the two-kernel route on the
    same operands, the eager host cost, the bound; at M = 8 the plain
    version's ms."""
    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    args = [ops(x, c) for c in range(copies)]
    call = lambda i: Q.mlp_fused(*args[i % copies],  # noqa: E731
                                 torch.bfloat16)
    t_k = cuda_ms(call, 20)
    t_e = host_ms(call)
    t_p = None
    if m == 8:
        t_p = event_ms(lambda i: Q.mlp_fused_plain(*args[i % copies],
                                                   torch.bfloat16), 3)

    def two(i):
        xx, d13, s13, z13, d2, s2, z2, xs, _ = args[i % copies]
        gu = Q.w4_gemv(xx, d13, s13, z13, xs, torch.bfloat16).float()
        h = (Q._mlp_act(gu[:, :i_ff], act) * gu[:, i_ff:]).to(torch.bfloat16)
        return Q.w4_gemv(h, d2, s2, z2, None, torch.bfloat16)

    t_two = cuda_ms(two, 20)
    nbytes = (k // 2 * 2 * i_ff + i_ff // 2 * n + (2 * i_ff + n) * 8
              + m * k * 2 + m * n * 2)
    bnd, by = bound_ms(nbytes, 2 * m * (k * 2 * i_ff + i_ff * n))
    plain_txt = "" if t_p is None else f", plain {t_p:.4f} ms"
    print(f"mlp_fused {label} M={m}: kernel {t_k:.4f} ms, two-kernel route "
          f"{t_two:.4f} ms, bound {bnd:.4f} ms ({by}){plain_txt}, eager "
          f"{t_e:.4f} ms [{card_line()}]", flush=True)
    return dict(ms=t_k, bound_ms=bnd, bound_by=by, plain_ms=t_p,
                two_kernel_ms=t_two, eager_ms=t_e, m=m)


# (B, Hkv, rep, S, D, model) of the first flash-decode kernel's holds
V1_GEOMETRY = ((8, 8, 4, 2048, 128, "Llama-3-8B"),
               (4, 16, 1, 2048, 256, "Gemma-7B rep 1"),
               (8, 1, 8, 2048, 256, "Gemma-2B rep 8"))
V1_POS = (0, 300, 2047, 1000, 1500, 511, 273, 1800)
V1_LAYERS = 8                 # distinct caches the timing cycles over


def hold_v1(torch, dev, gen, b, hkv, rep, s, d, label):
    """decode_attn against its plain version on one layer's kv8 cache of
    (b, hkv, rep, s, d) (ragged positions V1_POS: position 0 with one live
    key, S - 1, chunks wholly past pos; the K scale of position 5 raised
    in rows 2 and 3 so one key dominates them), atol 2e-3, rtol 2e-2 as
    the other attention holds, at the first and last of its caches
    (V1_LAYERS at head_dim 128, else 1); then its device ms with every
    position at S - 1 (the whole cache live) and ragged, the plain
    version's, SDPA's on the bf16-dequantized cache with the bool mask idx
    <= pos, and the bound (the live code and scale bytes).  Returns (max
    abs error, {"full": ..., "ragged": ...})."""
    import torch.nn.functional as F

    from piquant_tpu_torch.ops.cuda import attention as AT

    nl = V1_LAYERS if d == 128 else 1
    shape = (nl, b, hkv, s, d)
    kc, vc = (torch.randint(-127, 128, shape, generator=gen, device=dev,
                            dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand(shape[:-1] + (1,), generator=gen, device=dev)
              * 0.02 for _ in range(2))
    ks[:, 2:4, :, 5] = 0.5
    q = torch.randn((b, hkv, rep, d), generator=gen, device=dev).to(
        torch.bfloat16)
    pos = torch.tensor(V1_POS[:b], dtype=torch.int32, device=dev)
    sm = d ** -0.5
    err = 0.0
    for li in sorted({0, nl - 1}):
        got = AT.decode_attn(q, kc[li], ks[li], vc[li], vs[li], pos, sm)
        want = AT.decode_attn_plain(q, kc[li], ks[li], vc[li], vs[li],
                                    pos, sm)
        err = max(err, hold(torch, f"decode_attn {label} cache {li}", got,
                            want, 2e-3, 2e-2))
    print(f"decode_attn {label}: max_abs_err {err:.3e}", flush=True)
    full = torch.full_like(pos, s - 1)
    out = {}
    for what, p in (("full", full), ("ragged", pos)):
        call = lambda i, p=p: AT.decode_attn(  # noqa: E731
            q, kc[i % nl], ks[i % nl], vc[i % nl], vs[i % nl], p, sm)
        t_k = cuda_ms(call, 64)
        t_e = host_ms(call)
        t_p = event_ms(lambda i, p=p: AT.decode_attn_plain(
            q, kc[0], ks[0], vc[0], vs[0], p, sm), 4)
        kf = (kc[0].float() * ks[0]).to(torch.bfloat16)
        vf = (vc[0].float() * vs[0]).to(torch.bfloat16)
        mask = (torch.arange(s, device=dev)[None] <= p[:, None])[
            :, None, None, :]
        q4 = q.reshape(b, hkv * rep, 1, d)
        t_l = cuda_ms(lambda i: F.scaled_dot_product_attention(
            q4, kf, vf, attn_mask=mask, enable_gqa=True), 20)
        live = float((p + 1).sum())
        nbytes = (live * hkv * (2 * d + 2 * 4) + q.numel() * 2
                  + b * hkv * rep * d * 4)
        bnd, by = bound_ms(nbytes, 4 * live * hkv * rep * d)
        print(f"decode_attn {label} {what}: kernel {t_k:.4f} ms "
              f"({bound_share(t_k, bnd)} {bnd:.4f} ms, {by}), sdpa(bf16 "
              f"cache) {t_l:.4f} ms, plain {t_p:.4f} ms, eager "
              f"{t_e:.4f} ms [{card_line()}]", flush=True)
        out[what] = dict(max_abs_err=err, ms=t_k, bound_ms=bnd, bound_by=by,
                         plain_ms=t_p, library_ms=t_l, eager_ms=t_e)
        del kf, vf
    del kc, vc, ks, vs
    torch.cuda.empty_cache()
    return err, out


def check_decode_attn_v1(torch, dev, gen):
    """decode_attn against its plain version at each V1_GEOMETRY
    (`hold_v1`); the kernels line times Llama-3-8B's geometry with every
    position at S - 1."""
    err, variants, main = 0.0, {}, None
    for b, hkv, rep, s, d, label in V1_GEOMETRY:
        e, res = hold_v1(torch, dev, gen, b, hkv, rep, s, d, label)
        err = max(err, e)
        for what, r in res.items():
            r.pop("max_abs_err")
            main = main or r
            variants[f"{label} {what}"] = r
    return dict(name="decode_attn", route="cuda",
                source="piquant_tpu_torch/csrc/decode_attn2.cu",
                replaces="piquant_tpu/ops/pallas/attention.py:35 "
                         "(_decode_attn_kernel)",
                max_abs_err=err, **main,
                library_call="SDPA on the bf16-dequantized layer cache, "
                             "bool mask idx <= pos",
                timed="one layer: B=8, Hkv=8, rep=4, S=2048, every position "
                      "S - 1", variants=variants)


FUSED_SYS = 512               # the shared system prompt's tokens
FUSED_NEW = 16


def fused_requests(cfg, seed):
    """8 greedy requests sharing a 512-token system prompt with suffixes
    of 64-600 tokens (first in the queue, so they meet the preseeded
    entry), then 4 unrelated prompts of 100-1200 tokens."""
    import numpy as np

    from piquant_tpu_torch.serving import Request, SamplingParams

    rng = np.random.default_rng(seed + 14)
    sysp = [int(t) for t in rng.integers(5, cfg.vocab_size - 5, FUSED_SYS)]
    prompts = [sysp + [int(t) for t in rng.integers(
        5, cfg.vocab_size - 5, int(rng.integers(64, 601)))]
        for _ in range(8)]
    prompts += [[int(t) for t in rng.integers(
        5, cfg.vocab_size - 5, int(rng.integers(100, 1201)))]
        for _ in range(4)]
    sp = SamplingParams(max_new_tokens=FUSED_NEW)
    return sysp, [Request(rid=i, prompt=p, sampling=sp)
                  for i, p in enumerate(prompts)]


def fused_engine(torch, dev, args, cfg, params, sysp, reqs, counts=None):
    """An engine of phase 14's config with the system prompt preseeded
    and `reqs` queued; with `counts`, its decode blocks, chunk calls and
    prefix hits (the tokens each saved) are counted there."""
    from piquant_tpu_torch.serving import Engine, EngineConfig

    ec = EngineConfig(batch_slots=8, max_seq_len=2048, prefill_chunk=256,
                      prefix_cache=2, prefix_cache_auto=True,
                      attn_windows=(512, 1024, 2048))
    eng = Engine(cfg, params, ec, rng_seed=args.seed, device=dev)
    if eng.preseed_prefix(sysp) != FUSED_SYS:
        raise AssertionError("fused engine: the system prompt did not pool "
                             "whole")
    if counts is not None:
        dispatch, chunk, match = (eng._dispatch_block, eng._prefill_chunk,
                                  eng._match_prefix)

        def counted_dispatch():
            counts["blocks"] += 1
            return dispatch()

        def counted_chunk(*a):
            counts["chunks"] += 1
            return chunk(*a)

        def counted_match(prompt, aid=0):
            hit = match(prompt, aid)
            if hit is not None:
                counts["saved"].append(min(hit[2], len(prompt) - 1))
            return hit

        eng._dispatch_block = counted_dispatch
        eng._prefill_chunk = counted_chunk
        eng._match_prefix = counted_match
    for r in reqs:
        eng.submit(r)
    return eng


def pool_bytes(eng) -> int:
    return sum(t.numel() * t.element_size()
               for c, _ in eng._prefix_pool.values() for t in c.tensors())


def run_fused_engine(torch, dev, args):
    """Phase 14 (b): Llama-3-8B at full width and depth, random INT4 codes,
    kv8, through the Engine on fused params (fuse_layer_projections) under
    the three switches, chunked prefill of 256, the prefix cache (2
    entries, auto capture, a preseeded 512-token system prompt) and the
    window buckets (512, 1024, 2048); snapshot after the first tick,
    restore into a fresh engine, identical tokens; exact launches a decode
    step; tokens against the same route's single-request generation; one
    decode step's logits against the unfused default route; the same
    requests on the unfused default route for the metrics beside.  Returns
    the launches of mlp_fused and decode_attn in the counted run."""
    from piquant_tpu_torch.models import llama as M

    cfg = M.LlamaConfig.llama3_8b()
    params = M.random_quantized_params(cfg, seed=args.seed, device=dev)
    fused = M.fuse_layer_projections(params, cfg)
    torch.cuda.synchronize()
    nl = cfg.n_layers
    wr = kernel_wrappers()
    names = ("w4_gemv", "mlp_fused", "decode_attn", "decode_attn2",
             "flash_prefill", "w8_gemv")
    summary = {}
    for route, p_, on in (("unfused default", params, False),
                          ("fused switched", fused, True)):
        with switched(on):
            sysp, reqs = fused_requests(cfg, args.seed)
            counts = {"blocks": 0, "chunks": 0, "saved": []}
            torch.cuda.reset_peak_memory_stats()
            eng = fused_engine(torch, dev, args, cfg, p_, sysp, reqs, counts)
            zero_counts()
            t0 = time.perf_counter()
            stream = eng.run_stream()
            next(stream)                # the first tick's tokens
            state = eng.snapshot() if on else None
            for _ in stream:
                pass
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {k: wr[k].launches for k in names}
            done = sorted(eng._all, key=lambda r: r.rid)
            steps = counts["blocks"] * eng.ec.decode_block
            per = ({"w4_gemv": 2, "mlp_fused": 1, "decode_attn": 1} if on
                   else {"w4_gemv": 7, "decode_attn2": 1})
            expect = {k: per.get(k, 0) * nl * steps for k in names}
            m = eng.metrics
            print(f"fused engine [{route}]: {counts['blocks']} decode blocks "
                  f"({steps} steps), {counts['chunks']} prefill chunks, "
                  f"prefix hits {m.prefix_hits} saving "
                  f"{m.prefix_tokens_saved} tokens, launches {launches}, "
                  f"expected {expect}", flush=True)
            if launches != expect:
                raise AssertionError(f"fused engine [{route}]: launches "
                                     f"{launches} != {expect}")
            if len(done) != len(reqs) or not all(
                    r.done and len(r.tokens) == FUSED_NEW for r in done):
                raise AssertionError(f"fused engine [{route}]: requests "
                                     "unfinished")
            if (m.prefix_hits < 8
                    or m.prefix_tokens_saved != sum(counts["saved"])):
                raise AssertionError(
                    f"fused engine [{route}]: {m.prefix_hits} prefix hits, "
                    f"{m.prefix_tokens_saved} tokens saved against the "
                    f"pool's {counts['saved']}")
            summary[route] = {
                "card": card_line(), **m.to_dict(), "wall_s": wall,
                "decode_steps": steps,
                "launches_per_step": {k: v // max(steps, 1)
                                      for k, v in launches.items() if v},
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
                "prefix_pool_bytes": pool_bytes(eng)}
            print(f"fused_engine_metrics [{route}] "
                  + json.dumps(summary[route]), flush=True)
            if on:
                counted = {k: launches[k] for k in ("mlp_fused",
                                                    "decode_attn")}
                # snapshot after the first tick, restored into a fresh
                # engine: the rest of every request's tokens identical
                fresh = fused_engine(torch, dev, args, cfg, fused, sysp, [])
                fresh.restore(state)
                got = {r.rid: r.tokens for r in fresh.run()}
                want = {r.rid: r.tokens for r in done}
                if got != want:
                    raise AssertionError("fused engine: tokens after restore "
                                         "differ from the uninterrupted run")
                print(f"fused engine: snapshot after the first tick "
                      f"({sum(len(r.tokens) for r in state['all'])} tokens "
                      f"out), restored into a fresh engine: all "
                      f"{len(got)} requests' tokens identical", flush=True)
                for r in (done[0], done[7], done[8], done[11]):
                    ref, margins = generate_single(
                        torch, M, cfg, fused, r.prompt, FUSED_NEW, dev,
                        max_len=2048, chunk=256)
                    verdict = check_tokens_guarded(r.tokens, ref, margins)
                    print(f"fused engine: request {r.rid} (prompt "
                          f"{len(r.prompt)}) vs single-request chunked "
                          f"generation on the same route: {verdict}",
                          flush=True)
                profile_decode(torch, M, cfg, fused, dev)
                check_mlp_one_launch(torch, M, cfg, fused, dev)
                del fresh, state
            else:
                profile_decode(torch, M, cfg, params, dev)
            del eng, stream
            gc.collect()
            torch.cuda.empty_cache()
    compare_routes(torch, dev, cfg, params, fused)
    del params, fused
    gc.collect()
    torch.cuda.empty_cache()
    return counted


def region_kernels(prof, region: str) -> list:
    """The device kernels launched inside each `record_function(region)`
    range of a torch.profiler trace (CPU and CUDA activities), one list a
    range: the host's launch calls inside the range, matched to their
    kernels by correlation id."""
    from torch.autograd import DeviceType

    evs = list(prof.events())
    kernels = {}
    for e in evs:
        if e.device_type == DeviceType.CUDA:
            kernels.setdefault(e.id, []).append(e.name)
    host = [e for e in evs if e.device_type == DeviceType.CPU]
    launches = [e for e in host if e.name.startswith("cu")
                and "Launch" in e.name and e.id in kernels]
    return [[k for e in launches if r.time_range.start <= e.time_range.start
             and e.time_range.end <= r.time_range.end for k in kernels[e.id]]
            for r in sorted((e for e in host if e.name == region),
                            key=lambda e: e.time_range.start)]


def check_mlp_one_launch(torch, M, cfg, params, dev):
    """One decode step at batch 8 on the fused, switched route under
    torch.profiler, each `mlp_fused_matmul` call in a range of its own: one
    range a layer, and in each exactly one kernel, the fused MLP's (no
    cast, no row sum of x: the dispatch once launched both)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    cache = M.init_kv_cache(cfg, 8, max_len=2048, device=dev)
    tok = torch.ones(8, dtype=torch.int32, device=dev)
    pos = torch.arange(500, 516, 2, dtype=torch.int32, device=dev)
    inner = M.mlp_fused_matmul

    def tagged(*a, **kw):
        with record_function("mlp_fused_matmul"):
            return inner(*a, **kw)

    with switched():
        M.decode_step(cfg, params, tok, pos, cache)
        torch.cuda.synchronize()
        M.mlp_fused_matmul = tagged
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                M.decode_step(cfg, params, tok, pos + 1, cache)
                torch.cuda.synchronize()
        finally:
            M.mlp_fused_matmul = inner
    per_call = region_kernels(prof, "mlp_fused_matmul")
    n_dev = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)
    print(f"fused MLP launches: {len(per_call)} mlp_fused_matmul calls in a "
          f"decode step of {n_dev} device kernels; kernels a call: "
          f"{sorted({tuple(k[:60] for k in ks) for ks in per_call})}",
          flush=True)
    if not n_dev:
        raise AssertionError("fused MLP: the profiler traced no device "
                             "kernel, so one launch a call is not shown")
    if (len(per_call) != cfg.n_layers
            or any(len(ks) != 1 or "mlp_tc" not in ks[0] for ks in per_call)):
        raise AssertionError("fused MLP: not one mlp_fused_matmul call a "
                             "layer, or a call launched other kernels than "
                             "the fused MLP's")


ROUTE_TOL = 5e-2              # of the largest logit, 32 layers apart


def compare_routes(torch, dev, cfg, params, fused):
    """One decode step at batch 8 from one prefilled cache: the fused,
    switched route's logits against the unfused default route's, within
    ROUTE_TOL of the largest (the fused MLP skips the bf16 rounding of g
    and u, and the v1 kernel rounds its probabilities against other
    maxima, in each of 32 layers)."""
    from piquant_tpu_torch.models import llama as M

    gen = torch.Generator(device=dev).manual_seed(14)
    toks = torch.randint(5, cfg.vocab_size - 5, (8, 257), generator=gen,
                         device=dev, dtype=torch.int32)
    cache = M.init_kv_cache(cfg, 8, max_len=2048, device=dev)
    M.prefill(cfg, params, toks[:, :256], cache)
    pos = torch.full((8,), 256, dtype=torch.int32, device=dev)
    out = {}
    for route, p_, on in (("default", params, False), ("fused", fused, True)):
        c = type(cache)(*(t.clone() for t in cache.tensors()))
        with switched(on):
            out[route], _ = M.decode_step(cfg, p_, toks[:, 256], pos, c)
    err = float((out["fused"] - out["default"]).abs().max()
                / out["default"].abs().max())
    print(f"fused engine: one decode step, fused switched against unfused "
          f"default logits: max |diff| / max |logit| {err:.4e} (tolerance "
          f"{ROUTE_TOL})", flush=True)
    if not err <= ROUTE_TOL:
        raise AssertionError(f"fused route logits {err} from the default "
                             "route's")


def run_chunked_cli(torch, dev, args):
    """Phase 14 (c): `--random llama3_8b --prefill-chunk 256 --attn-windows
    512,1024,2048 --benchmark 8 --max-new 32` in process at CLI_DEPTH
    layers, full width, default switches: exact launches (7 w4_gemv and
    one decode_attn2 a layer a decode step; the INT8 lm_head on w8_gemv
    once a decode step and once a chunk, whose one logit row it projects;
    the 256-row chunks take the dequant path and attend over the cache,
    no flash), tokens against single-request chunked generation, metrics."""
    import numpy as np

    from piquant_tpu_torch.models import llama as M
    from piquant_tpu_torch.serving import __main__ as S

    argv = ["--random", "llama3_8b", "--prefill-chunk", "256",
            "--attn-windows", "512,1024,2048", "--benchmark", "8",
            "--max-new", "32"]
    names = ("w4_gemv", "w8_gemv", "decode_attn2", "flash_prefill",
             "mlp_fused", "decode_attn")
    with cut_depth("llama3_8b", CLI_DEPTH), switched(False):
        cli_args = S.build_parser().parse_args(argv)
        torch.cuda.reset_peak_memory_stats()
        cfg, params, eng, sp = S.build(cli_args)
        counts = {"blocks": 0, "chunks": 0}
        dispatch, chunk = eng._dispatch_block, eng._prefill_chunk

        def counted_dispatch():
            counts["blocks"] += 1
            return dispatch()

        def counted_chunk(*a):
            counts["chunks"] += 1
            return chunk(*a)

        eng._dispatch_block, eng._prefill_chunk = (counted_dispatch,
                                                   counted_chunk)
        zero_counts()
        metrics, done = S.benchmark(cli_args, cfg, eng, sp)
        torch.cuda.synchronize()
        wr = kernel_wrappers()
        launches = {k: wr[k].launches for k in names}
        nl = cfg.n_layers
        steps = counts["blocks"] * eng.ec.decode_block
        expect = dict.fromkeys(names, 0)
        expect.update(w4_gemv=7 * nl * steps, decode_attn2=nl * steps,
                      w8_gemv=steps + counts["chunks"])
        print(f"chunked cli: {counts['blocks']} decode blocks ({steps} "
              f"steps), {counts['chunks']} chunks, launches {launches}, "
              f"expected {expect}", flush=True)
        if launches != expect:
            raise AssertionError(f"chunked cli: launches {launches} != "
                                 f"{expect}")
        if metrics["completed"] != cli_args.benchmark or not all(
                len(r.tokens) == cli_args.max_new and all(
                    np.isfinite(lp) and lp <= 0 for lp in r.logprobs)
                for r in done):
            raise AssertionError("chunked cli: requests unfinished or "
                                 "non-finite")
        r = max(done, key=lambda r: len(r.prompt))
        want, margins = generate_single(torch, M, cfg, params, r.prompt,
                                        cli_args.max_new, dev,
                                        max_len=cli_args.max_seq_len,
                                        chunk=256)
        print(f"chunked cli: request {r.rid} (prompt {len(r.prompt)}) vs "
              f"single-request chunked generation: "
              f"{check_tokens_guarded(r.tokens, want, margins)}", flush=True)
        print("cli_metrics " + json.dumps(
            {"card": card_line(), "flags": " ".join(argv[2:]), **metrics,
             "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30}),
            flush=True)
        del params, eng, done, dispatch, chunk
        gc.collect()
        torch.cuda.empty_cache()


def run_fused(torch, dev, gen, args):
    """Phase 14: (a) the two kernels' holds, (b) the fused engine, (c) the
    chunked CLI.  Returns its kernels-line rows and their launches."""
    rows = [check_mlp_fused(torch, dev, gen),
            check_decode_attn_v1(torch, dev, gen)]
    torch.cuda.empty_cache()
    launches = run_fused_engine(torch, dev, args)
    run_chunked_cli(torch, dev, args)
    return rows, launches


# ---------------------------------------------------------------------------
# phase 15: the mesh, the quantized collectives and the int8 ring
# ---------------------------------------------------------------------------

RING_P = 8                    # data-parallel ranks, stacked on the card
RING_N = 4096 * 14336         # Llama-3-8B's w1 gradient: values a rank
RING_CHUNK = 65536            # the reference's max_chunk_elems
# (shape, max_chunk_elems) of the reference tests (tests/test_rdma_ring.py)
RING_HOLDS = (((4096,), 65536), ((1000,), 65536), ((16, 257), 65536),
              ((3 * 8 * 1024 + 7,), 1024))
COLL_N = (1000, 4096)         # quantized_all_reduce / psum values a rank
COLL_KERNELS = ("quantize", "dequantize", "min_max")


def ring_bound(x) -> float:
    """The int8 ring's bound on |result - exact sum|: tests/test_rdma_ring.py's
    (P-1) P max|x| / 254, or, where that is tighter (P < 3), the P-1 hops'
    and the gather's half steps, each of a partial of at most s + 1
    addends: P (P+1) / 2 max|x| / 254, 5% over for the errors the partials
    carry."""
    p, top = x.shape[0], float(x.abs().max())
    return max((p - 1) * p, 1.05 * p * (p + 1) / 2) * top / 254.0


def ring_mesh(dev, p):
    from piquant_tpu_torch.parallel import make_mesh

    return make_mesh([("x", p)], devices=[dev] * p).axis("x")


def check_ring(torch, dev, gen):
    """Phase 15 (b): the stacked ring over P = 2, 4, 8 ranks on the card at
    the reference tests' shapes, bit for bit against ring_plain, replicas
    identical and within the int8 bound; then the P = 2 loopback selftest.
    Returns the largest difference (0 when bit for bit)."""
    from piquant_tpu_torch.ops.cuda import ring as RG
    from piquant_tpu_torch.parallel import (rdma_all_reduce_shard,
                                            rdma_ring_selftest)

    worst = 0.0
    for p in (2, 4, 8):
        axis = ring_mesh(dev, p)
        for shape, chunk in RING_HOLDS:
            x = torch.randn((p,) + shape, generator=gen, device=dev)
            got = rdma_all_reduce_shard(x, axis, max_chunk_elems=chunk)
            want = RG.ring_plain(x.reshape(p, -1), chunk).reshape(got.shape)
            worst = max(worst, same(torch, f"ring P={p} {shape}", got, want))
            if not all(torch.equal(got[0], got[d]) for d in range(1, p)):
                raise AssertionError(f"ring P={p} {shape}: replicas differ")
            err = float((got[0] - x.sum(0)).abs().max())
            if err > ring_bound(x):
                raise AssertionError(f"ring P={p} {shape}: error {err} past "
                                     f"{ring_bound(x)}")
    err = rdma_ring_selftest(rows=256)
    print(f"ring: P = 2, 4, 8 x {len(RING_HOLDS)} shapes bit for bit against "
          f"ring_plain, replicas identical; loopback selftest error {err:.4e}",
          flush=True)
    return worst


def ring_group_form(torch, RG, x, segs, p, nbytes):
    """The process-group form's kernel launches on one card: at every hop
    each rank's ring_hop is its own launch (rows 1, my0 r) reading its left
    neighbour's send row of the previous hop, the last hop's rows are the
    owners' rows every rank holds after the forwarding, and each rank's
    ring_gather writes its one replica.  -> [P, n] replicas."""
    sends = torch.empty((2, p, nbytes), dtype=torch.uint8, device=x.device)
    for hop in range(p):
        for r in range(p):
            left = (r - 1) % p
            prev = sends[(hop - 1) % 2][left:left + 1]
            for seg in segs:
                RG.ring_hop(x[r:r + 1], seg, p, hop,
                            sends[hop % 2][r:r + 1],
                            None if hop == 0 else prev, r)
    out = torch.empty_like(x)
    for r in range(p):
        for seg in segs:
            RG.ring_gather(sends[(p - 1) % 2], seg, p, out[r:r + 1])
    return out


def run_collectives(torch, dev, gen):
    """Phase 15 (a), second half: quantized_all_reduce and quantized_psum,
    nearest, uint8 and uint4, at P = 8 stacked on the card.  A call makes
    P(P-1) + P quantizes (each with its min/max) and P(P-1) dequant-ADDs
    plus P * P dequantizes (every rank's all-gather); the result is within
    tests/test_collectives.py's bound of the f32 sum.  Returns the
    quantize / dequantize / min_max launches of all calls."""
    from piquant_tpu_torch.parallel import (make_mesh, quantized_all_reduce,
                                            quantized_psum)

    p = RING_P
    mesh = make_mesh([("x", p)], devices=[dev] * p)
    wr = kernel_wrappers()
    zero_counts()
    calls = 0
    for n in COLL_N:
        x = torch.randn((p, n), generator=gen, device=dev)
        want = x.sum(0)
        for q in ("uint8", "uint4"):
            steps = 255 if q == "uint8" else 15
            tol = p * (float(x.abs().max()) * p * 2 / steps) * 0.5 + 1e-3
            rep = quantized_all_reduce(x, mesh.axis("x"), q, "nearest")
            psum = quantized_psum(x, mesh, "x", q, "nearest")
            calls += 2
            if not all(torch.equal(rep[0], rep[d]) for d in range(1, p)):
                raise AssertionError(f"quantized_all_reduce {q}: replicas "
                                     "differ")
            if not torch.equal(psum, rep[0]):
                raise AssertionError(f"quantized_psum {q} != all_reduce")
            err = float((rep[0] - want).abs().max())
            if not err <= tol:
                raise AssertionError(f"quantized_all_reduce {q} n={n}: error "
                                     f"{err} past {tol}")
    torch.cuda.synchronize()
    got = {k: wr[k].launches for k in COLL_KERNELS}
    expect = {"quantize": calls * p * p, "min_max": calls * p * p,
              "dequantize": calls * (p * (p - 1) + p * p)}
    print(f"collectives: {calls} calls at P = {p} (uint8, uint4; n {COLL_N}),"
          f" launches {got}, expected {expect}", flush=True)
    if got != expect:
        raise AssertionError(f"collectives launches {got} != {expect}")
    return got


def run_ring(torch, dev, gen):
    """Phase 15 (a) and (c): the w1 all-reduce counted, held and timed;
    the collectives; the holds of (b).  Returns the kernels-line rows of
    ring_hop and ring_gather and the collectives' launches."""
    from piquant_tpu_torch.ops.cuda import ring as RG
    from piquant_tpu_torch.parallel import rdma_all_reduce_shard

    p, n = RING_P, RING_N
    axis = ring_mesh(dev, p)
    x = torch.randn((p, n), generator=gen, device=dev)
    segs, nbytes = RG.segments(n, p, RING_CHUNK)
    wr = kernel_wrappers()
    zero_counts()
    out = rdma_all_reduce_shard(x, axis, max_chunk_elems=RING_CHUNK)
    torch.cuda.synchronize()
    launches = {k: wr[k].launches for k in ("ring_hop", "ring_gather")}
    expect = {"ring_hop": p * len(segs), "ring_gather": len(segs)}
    print(f"ring: Llama-3-8B w1 all-reduce, {n} f32 a rank over {p} ranks "
          f"({len(segs)} run(s) of buckets), launches {launches}, expected "
          f"{expect}", flush=True)
    if launches != expect:
        raise AssertionError(f"ring launches {launches} != {expect}")
    coll = run_collectives(torch, dev, gen)
    want = RG.ring_plain(x, RING_CHUNK)
    err = same(torch, "ring w1", out, want)
    if not all(torch.equal(out[0], out[d]) for d in range(1, p)):
        raise AssertionError("ring w1: replicas differ")
    sum_err = float((out[0] - x.sum(0)).abs().max())
    if sum_err > ring_bound(x):
        raise AssertionError(f"ring w1: error {sum_err} past the bound")
    del want
    got = ring_group_form(torch, RG, x, segs, p, nbytes)
    if not torch.equal(got, out):
        raise AssertionError("ring w1: the group form differs from the "
                             "stacked replicas")
    del got
    print("ring: w1 in the process-group form (one ring_hop launch a rank a "
          "hop, one ring_gather a rank) bit for bit against the stacked "
          "replicas", flush=True)
    err = max(err, check_ring(torch, dev, gen))

    # (c) times at the w1 shape: one hop with a received term, stacked
    # (every rank row, all 112 buckets, one launch) and in the process-group
    # form (one rank row a launch, the 8 ranks in turn, each with its own x,
    # recv and send rows); the gather of all 8 replicas (stacked) and of one
    # (the group form), beside fill_ of the same rows (writes only); the
    # whole call
    seg = segs[0]
    bufs = torch.empty((2, p, nbytes), dtype=torch.uint8, device=dev)
    out1 = torch.empty((1, n), device=dev)
    RG.ring_hop(x, seg, p, 0, bufs[0])

    def group_hop(i):
        r, left = i % p, (i - 1) % p
        RG.ring_hop(x[r:r + 1], seg, p, 1, bufs[1][r:r + 1],
                    bufs[0][left:left + 1], r, 0)

    hop_ms = cuda_ms(lambda i: RG.ring_hop(x, seg, p, 1, bufs[1], bufs[0],
                                           0, 1), 10)
    group_ms = cuda_ms(group_hop, 32)
    gather_ms = cuda_ms(lambda i: RG.ring_gather(bufs[1], seg, p, out), 10)
    gather1_ms = cuda_ms(lambda i: RG.ring_gather(bufs[1], seg, p, out1), 20)
    fill_ms = cuda_ms(lambda i: out.fill_(0.5), 10)
    fill1_ms = cuda_ms(lambda i: out1.fill_(0.5), 20)
    call_ms = cuda_ms(lambda i: rdma_all_reduce_shard(
        x, axis, max_chunk_elems=RING_CHUNK), 3)
    hop_plain = event_ms(lambda i: RG.ring_hop_plain(
        x, seg, p, 1, bufs[1], bufs[0], 0, 1), 2, warmup=1)
    gather_plain = event_ms(lambda i: RG.ring_gather_plain(
        bufs[1], seg, p, out), 2, warmup=1)
    call_plain = event_ms(lambda i: RG.ring_plain(x, RING_CHUNK), 1,
                          warmup=0)
    # bytes each reads once and writes once: a hop reads a rank row's f32
    # chunks and received int8 codes and writes int8 codes (6 bytes a value
    # of one rank's n / P, and 8 bytes of scales a chunk), for every rank
    # row stacked or for one in the group form; the gather reads one int8
    # code a value and writes nrep f32 replicas; the call reads P f32
    # addends and writes P replicas
    vals = seg.nb * seg.csize
    hop_b, hop_by = bound_ms(6 * p * vals + 8 * p * seg.nb, 0)
    group_b, _ = bound_ms(6 * vals + 8 * seg.nb, 0)
    gat_b, gat_by = bound_ms(n + 4 * p * seg.nb + 4 * p * n, 0)
    gat1_b, _ = bound_ms(n + 4 * p * seg.nb + 4 * n, 0)
    call_b, call_by = bound_ms(8 * p * n, 0)
    plan = RG.hop_plan(seg.csize)
    att = {"ring_hop": RG.ring_attributes("hop", plan),
           "ring_hop two-pass": RG.ring_attributes("hop", RG.HopPlan(0, 8)),
           "ring_gather": RG.ring_attributes("gather")}
    card = card_line()
    print(f"ring: ring_hop stacked {hop_ms:.4f} ms a launch (bound "
          f"{hop_b:.4f}, {bound_share(hop_ms, hop_b)}; plain "
          f"{hop_plain:.4f}), group form (rows 1) {group_ms:.4f} ms (bound "
          f"{group_b:.4f}, {bound_share(group_ms, group_b)}); ring_gather "
          f"nrep 8 {gather_ms:.4f} ms (bound {gat_b:.4f}, "
          f"{bound_share(gather_ms, gat_b)}; fill_ of its rows "
          f"{fill_ms:.4f}; plain {gather_plain:.4f}), nrep 1 "
          f"{gather1_ms:.4f} ms (bound {gat1_b:.4f}, "
          f"{bound_share(gather1_ms, gat1_b)}; fill_ {fill1_ms:.4f}); the "
          f"whole call {call_ms:.4f} ms (bound {call_b:.4f} {call_by}, "
          f"ring_plain {call_plain:.4f}); error against the f32 sum "
          f"{sum_err:.4e} [{card}]", flush=True)
    print("ring instances (registers, spilled bytes, blocks an SM, clusters "
          "at once): " + "; ".join(
              f"{k} {v}" for k, v in att.items())
          + f"; w1 plan: {plan.vals} values a thread, clusters of "
          f"{plan.cluster} [{card}]", flush=True)
    common = dict(route="cuda", source="piquant_tpu_torch/csrc/ring.cu",
                  replaces="piquant_tpu/parallel/rdma_ring.py:62 "
                           "(_ring_kernel, via _pallas_ring :153)",
                  max_abs_err=err, library_ms=None,
                  library="none: no single PyTorch call quantizes a ring",
                  timed=f"Llama-3-8B w1 gradient all-reduce, {n} f32 a rank,"
                        f" P = {p} stacked on one card; group_*: one rank "
                        f"row a launch (the process-group form)",
                  call_ms=call_ms, call_bound_ms=call_b,
                  call_plain_ms=call_plain, sum_err=sum_err)
    rows = [dict(name="ring_hop", ms=hop_ms, bound_ms=hop_b, bound_by=hop_by,
                 plain_ms=hop_plain, group_ms=group_ms,
                 group_bound_ms=group_b, vals=plan.vals,
                 cluster=plan.cluster, registers=att["ring_hop"][0],
                 spill_bytes=att["ring_hop"][1], **common),
            dict(name="ring_gather", ms=gather_ms, bound_ms=gat_b,
                 bound_by=gat_by, plain_ms=gather_plain, group_ms=gather1_ms,
                 group_bound_ms=gat1_b, fill_ms=fill_ms,
                 group_fill_ms=fill1_ms, registers=att["ring_gather"][0],
                 spill_bytes=att["ring_gather"][1], **common)]
    del x, out, out1, bufs
    gc.collect()
    torch.cuda.empty_cache()
    return rows, launches, coll


# ---------------------------------------------------------------------------
# phase 16: token history, penalties and beam search
# ---------------------------------------------------------------------------

HIST_NEW = 16
HIST_PROMPTS = (100, 600)     # prompt lengths drawn in [lo, hi)
# per request: (repetition, frequency, presence) penalties; request 6 bans
# its own unpenalized first token, request 7 takes it as EOS under
# min_new_tokens 8
HIST_PENALTIES = ((1.1, 0.0, 0.0), (1.15, 0.5, 0.0), (1.2, 0.0, 0.5),
                  (1.25, 0.5, 0.5), (1.3, 0.0, 0.0), (1.0, 0.5, 0.5),
                  (1.1, 0.0, 0.0), (1.2, 0.0, 0.0))
HIST_MIN_NEW = 8


def generate_penalized(torch, M, cfg, params, prompt, sp, dev):
    """The port's own single-request greedy generation under `sp`'s
    penalties, as the engine applies them (the first token: repetition
    over the prompt and the first bias row; then repetition over prompt +
    generated, frequency and presence over the generated, the bias, EOS
    below min_new_tokens), stopping at EOS.  Returns the tokens and the
    top-2 margin of the penalized logits that chose each."""
    from piquant_tpu_torch.serving.sampler import (apply_freq_presence,
                                                   apply_repetition_penalty)

    plen, n_new = len(prompt), sp.max_new_tokens
    cache = M.init_kv_cache(cfg, 1, max_len=plen + n_new, device=dev)
    logits, cache = M.prefill(cfg, params, torch.tensor(
        [prompt], device=dev, dtype=torch.int32), cache)
    bias = torch.zeros(cfg.vocab_size, device=dev)
    for t, b in sp.logit_bias:
        bias[t] = b
    one = lambda v, dt=torch.float32: torch.tensor(  # noqa: E731
        [v], device=dev, dtype=dt)
    hist, toks, margins = list(prompt), [], []
    while True:
        h = torch.tensor([hist], device=dev, dtype=torch.int32)
        lg = apply_repetition_penalty(logits, h, one(len(hist), torch.int32),
                                      one(sp.repetition_penalty))
        if toks:
            lg = apply_freq_presence(lg, h, one(plen, torch.int32),
                                     one(len(hist), torch.int32),
                                     one(sp.frequency_penalty),
                                     one(sp.presence_penalty))
        lg = lg[0] + bias
        if sp.eos_token >= 0 and len(toks) + 1 <= sp.min_new_tokens:
            lg[sp.eos_token] = -1e30
        top = lg.topk(2)
        toks.append(int(top.indices[0]))
        margins.append(float(top.values[0] - top.values[1]))
        hist.append(toks[-1])
        if len(toks) == n_new or toks[-1] == sp.eos_token:
            return toks, margins
        logits, cache = M.decode_step(
            cfg, params, torch.tensor([toks[-1]], device=dev,
                                      dtype=torch.int32),
            torch.tensor([len(hist) - 1], device=dev, dtype=torch.int32),
            cache)


def history_requests(torch, M, cfg, params, dev, seed):
    """Phase 16's 8 prompts and SamplingParams: the penalties of
    HIST_PENALTIES; request 6 bans, and request 7 takes as its EOS, its own
    unpenalized greedy first token (read from one prefill)."""
    import numpy as np

    from piquant_tpu_torch.serving import SamplingParams

    rng = np.random.default_rng(seed + 16)
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size,
                                             int(rng.integers(*HIST_PROMPTS)))]
               for _ in HIST_PENALTIES]
    sps = []
    for i, (rp, fp, pp) in enumerate(HIST_PENALTIES):
        kw = dict(repetition_penalty=rp, frequency_penalty=fp,
                  presence_penalty=pp, max_new_tokens=HIST_NEW)
        if i >= 6:
            first = generate_single(torch, M, cfg, params, prompts[i], 1,
                                    dev)[0][0]
            kw.update(dict(logit_bias=((first, -1e9),)) if i == 6 else
                      dict(eos_token=first, min_new_tokens=HIST_MIN_NEW))
        sps.append(SamplingParams(**kw))
    return prompts, sps


def history_engine(torch, dev, args, cfg, params, prompts, sps, history):
    """Serve the prompts through an Engine (batch 8, max_seq_len 2048,
    prefill_pad 128: whole flash tiles) with or without the token history;
    -> (finished requests, metrics, decode blocks, prefill calls, kernel
    launches of the run)."""
    from piquant_tpu_torch.serving import (Engine, EngineConfig, Request,
                                           SamplingParams)

    ec = EngineConfig(batch_slots=8, max_seq_len=2048, prefill_pad=128,
                      decode_block=16, track_history=history)
    eng = Engine(cfg, params, ec, rng_seed=args.seed, device=dev)
    counts = {"blocks": 0, "prefills": 0}
    dispatch, admit = eng._dispatch_block, eng._admit_one_shot

    def counted_dispatch():
        counts["blocks"] += 1
        return dispatch()

    def counted_admit(batch):
        counts["prefills"] += 1
        return admit(batch)

    eng._dispatch_block, eng._admit_one_shot = counted_dispatch, counted_admit
    for i, (p, sp) in enumerate(zip(prompts, sps)):
        eng.submit(Request(rid=i, prompt=p, sampling=sp if history else
                           SamplingParams(max_new_tokens=HIST_NEW)))
    wr = kernel_wrappers()
    zero_counts()
    done = sorted(eng.run(), key=lambda r: r.rid)
    torch.cuda.synchronize()
    launches = {k: wr[k].launches for k in ("w4_gemv", "decode_attn2",
                                            "flash_prefill", "w8_gemv")}
    return eng, done, counts, launches


HIST_ORDER = (False, True)    # the served runs, without history first
# decode blocks of the step comparison: without, with, with, without,
# each block synchronised; then one profiled block of HIST_PROFILED steps
# each
HIST_BLOCKS = (False, True, True, False)
HIST_PROFILED = 2


def compare_history_steps(torch, dev, args, cfg, params, prompts):
    """Phase 16's step comparison: two engines of one setup, with and
    without the history (the first with repetition 1.2 and frequency 0.5
    on every request), decode blocks alternated (HIST_BLOCKS), then one
    block of HIST_PROFILED steps each under torch.profiler (device time,
    launches), the
    penalties' cost alone, and one history step's penalties and history
    write under CUDA's sync debug mode, which raises at a host sync."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from piquant_tpu_torch.serving import (Engine, EngineConfig, Request,
                                           SamplingParams)

    engines = {}
    for history in (False, True):
        ec = EngineConfig(batch_slots=8, max_seq_len=2048, prefill_pad=128,
                          decode_block=16, track_history=history)
        eng = Engine(cfg, params, ec, rng_seed=args.seed, device=dev)
        pen = dict(repetition_penalty=1.2, frequency_penalty=0.5)
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, sampling=SamplingParams(
                max_new_tokens=2048 - len(p), **(pen if history else {}))))
        eng._admit()
        eng._process_block(*eng._dispatch_block())       # warm
        engines[history] = eng
    ms = {False: [], True: []}
    for history in HIST_BLOCKS:
        eng = engines[history]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng._process_block(*eng._dispatch_block())
        torch.cuda.synchronize()
        ms[history].append((time.perf_counter() - t0) * 1e3 /
                           eng.ec.decode_block)
    prof = {}
    for history, eng in engines.items():
        eng.ec = dataclasses.replace(eng.ec, decode_block=HIST_PROFILED)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as pr:
            eng._process_block(*eng._dispatch_block())
            torch.cuda.synchronize()
        rows = [(e.device_time_total / 1e3, e.count)
                for e in pr.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.device_time_total > 0]
        prof[history] = (sum(r[0] for r in rows) / HIST_PROFILED,
                         sum(r[1] for r in rows) // HIST_PROFILED)
    eng = engines[True]
    logits = torch.randn((8, cfg.vocab_size), generator=torch.Generator(
        device=dev).manual_seed(args.seed), device=dev)
    pos = torch.full((8,), 500, dtype=torch.int32, device=dev)
    tok = torch.ones(8, dtype=torch.int32, device=dev)
    pen_host = host_ms(lambda i: eng._penalize(logits, pos), 20)
    pen_dev = event_ms(lambda i: eng._penalize(logits, pos), 20)
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng._penalize(logits, pos)
        eng._hist_write(tok, pos)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    mean = {h: sum(v) / len(v) for h, v in ms.items()}
    print(f"history steps: ms a decode step at batch 8, blocks alternated "
          f"{HIST_BLOCKS}: with history {[round(v, 2) for v in ms[True]]} "
          f"(mean {mean[True]:.2f}), without "
          f"{[round(v, 2) for v in ms[False]]} (mean {mean[False]:.2f}); "
          f"profiled a step: kernels {prof[True][0]:.3f} against "
          f"{prof[False][0]:.3f} ms, launches {prof[True][1]} against "
          f"{prof[False][1]}; the penalties alone {pen_host:.3f} ms eagerly, "
          f"{pen_dev:.3f} ms back to back on the device; no host sync in a "
          f"step's penalties and history write [{card_line()}]", flush=True)
    del engines, eng
    gc.collect()
    torch.cuda.empty_cache()


def run_history(torch, dev, args):
    """Phase 16: Llama-3-8B at full width and depth, random INT4 codes,
    INT8 lm_head, kv8: the history engine's tokens and launches, decode
    tok/s with and without history, the penalties' cost a step, beam
    search."""
    from piquant_tpu_torch.models import llama as M
    from piquant_tpu_torch.models.generate import beam_search

    cfg = M.LlamaConfig.llama3_8b()
    params = M.random_quantized_params(cfg, seed=args.seed, lm_head_bits=8,
                                       device=dev)
    prompts, sps = history_requests(torch, M, cfg, params, dev, args.seed)
    rates = {}
    for history in HIST_ORDER:
        eng, done, counts, launches = history_engine(
            torch, dev, args, cfg, params, prompts, sps, history)
        m = eng.metrics
        steps = counts["blocks"] * 16
        nl = cfg.n_layers
        expect = {"w4_gemv": 7 * nl * steps, "decode_attn2": nl * steps,
                  "flash_prefill": nl * counts["prefills"],
                  "w8_gemv": steps + counts["prefills"]}
        label = "with history" if history else "without history"
        print(f"history engine [{label}]: {counts['blocks']} decode blocks "
              f"({steps} steps), {counts['prefills']} prefill calls, "
              f"launches {launches}, expected {expect}", flush=True)
        if launches != expect:
            raise AssertionError(f"history engine [{label}]: launches "
                                 f"{launches} != {expect}")
        if len(done) != len(prompts) or not all(r.done for r in done):
            raise AssertionError(f"history engine [{label}]: unfinished")
        rates[label] = m.decode_tokens_per_s
        print(f"history_engine_metrics [{label}] " + json.dumps(
            {"card": card_line(), **m.to_dict(), "decode_steps": steps}),
            flush=True)
        del eng
        if not history:
            continue
        for r, sp in zip(done, sps):
            want, margins = generate_penalized(torch, M, cfg, params,
                                               r.prompt, sp, dev)
            verdict = check_tokens_guarded(r.tokens, want, margins)
            print(f"history engine: request {r.rid} (prompt "
                  f"{len(r.prompt)}, penalties {sp.repetition_penalty} / "
                  f"{sp.frequency_penalty} / {sp.presence_penalty}) vs "
                  f"penalized single-request generation: {verdict}",
                  flush=True)
        banned = sps[6].logit_bias[0][0]
        if banned in done[6].tokens:
            raise AssertionError("history engine: the banned token came")
        eos = sps[7].eos_token
        if eos in done[7].tokens[:HIST_MIN_NEW]:
            raise AssertionError("history engine: EOS under min_new_tokens")
        print(f"history engine: request 6 never emits its banned token "
              f"{banned}; request 7 emits {len(done[7].tokens)} tokens with "
              f"its EOS {eos} held off for {HIST_MIN_NEW}", flush=True)
    print(f"history engine: decode {rates['with history']:.2f} tok/s with "
          f"history and penalties, {rates['without history']:.2f} without "
          f"(tokens kept over decode time; one run each, without first) "
          f"[{card_line()}]", flush=True)
    compare_history_steps(torch, dev, args, cfg, params, prompts)

    prompt = prompts[0]
    t0 = time.perf_counter()
    hyps = beam_search(cfg, params, prompt, n_beams=4,
                       max_new_tokens=HIST_NEW, device=dev)
    beam_s = time.perf_counter() - t0
    if (len(hyps) != 4 or any(len(h.tokens) != HIST_NEW for h in hyps)
            or any(hyps[i].score < hyps[i + 1].score for i in range(3))):
        raise AssertionError("beam_search: hypotheses unsorted or short")
    (one,) = beam_search(cfg, params, prompt, n_beams=1,
                         max_new_tokens=HIST_NEW, device=dev)
    want, margins = generate_single(torch, M, cfg, params, prompt, HIST_NEW,
                                    dev)
    verdict = check_tokens_guarded(one.tokens, want, margins)
    print(f"beam search: 4 beams in {beam_s:.2f} s, scores "
          f"{[round(h.score, 4) for h in hyps]}; 1 beam vs greedy "
          f"generation: {verdict}", flush=True)
    del params
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 17: speculative decoding (prompt lookup, a draft model, rejection
# sampling) and requantize_params
# ---------------------------------------------------------------------------

SPEC_G = 4                    # drafts a verify: 8 slots x 5 = 40 GEMV rows
SPEC_NEW = 48
SPEC_SEG = 96                 # the lookup prompts repeat a segment 3 times
SPEC_RANDOM = (128, 513)      # the random prompts' lengths, [lo, hi)
SPEC_PERFECT = 4              # requests of the target-as-its-own-draft run
SPEC_FULL = 0.9               # of its verify rows emit G + 1 tokens at least
SPEC_TEMP = 0.9
SPEC_KERNELS = ("w4_gemv", "w8_gemv", "w2_gemv", "wg_chunk", "decode_attn2",
                "flash_prefill")
SPEC_CLI_RUNS = ((), ("--draft-bits", "2"),
                 ("--draft-bits", "2", "--draft-group-size", "32"))
MC_V, MC_G, MC_N = 8, 2, 4096  # the reference's Monte-Carlo marginal check


def spec_prompts(cfg, seed):
    """Phase 17's 8 prompts: 4 that repeat a random 96-token segment three
    times (the bigrams recur, so prompt lookup finds drafts) and 4 random
    ones of 128-512 tokens."""
    import numpy as np

    rng = np.random.default_rng(seed + 17)
    prompts = []
    for i in range(8):
        if i < 4:
            seg = rng.integers(1, cfg.vocab_size, SPEC_SEG).tolist()
            prompts.append(seg * 3)
        else:
            prompts.append(rng.integers(1, cfg.vocab_size,
                                        int(rng.integers(*SPEC_RANDOM))
                                        ).tolist())
    return [[int(t) for t in p] for p in prompts]


@contextlib.contextmanager
def no_plain_versions(torch, dev):
    """On the card, the plain versions of phase 17's kernels raise while
    the block runs: the path must take the kernels."""
    from piquant_tpu_torch.ops.cuda import decode_attn2 as DA
    from piquant_tpu_torch.ops.cuda import flash as FL
    from piquant_tpu_torch.ops.cuda import qmatmul as Q

    mods = ((Q, "w4_gemv_plain"), (Q, "w8_gemv_plain"), (Q, "w2_gemv_plain"),
            (Q, "wg_chunk_plain"), (DA, "decode_attn2_plain"),
            (FL, "flash_attn_plain"))
    real = {n: getattr(m, n) for m, n in mods}

    def refuse(n):
        def call(*a, **kw):
            raise AssertionError(f"{n} ran on the speculative path")
        return call

    if dev.type == "cuda":
        for m, n in mods:
            setattr(m, n, refuse(n))
    try:
        yield
    finally:
        for m, n in mods:
            setattr(m, n, real[n])


def spec_engine(torch, dev, args, cfg, params, prompts, sps, speculate,
                draft=None, gaps=None):
    """Serve `prompts` under `sps` through an Engine (8 slots, max_seq_len
    2048, prefill_pad 128, decode_block 4) with `speculate` drafts a verify
    and `draft` -> (requests by rid, metrics, counts: plain decode blocks,
    speculative blocks, prefill calls, and the [K, B] emit counts of every
    speculative block; the launches of SPEC_KERNELS).  With `gaps` (a list)
    each verify appends, per row and draft position, the verify's top logit
    less the draft token's."""
    from piquant_tpu_torch.models import speculative as SP
    from piquant_tpu_torch.serving import Engine, EngineConfig, Request

    ec = EngineConfig(batch_slots=8, max_seq_len=2048, prefill_pad=128,
                      decode_block=4, speculate=speculate)
    eng = Engine(cfg, params, ec, rng_seed=args.seed, draft=draft,
                 device=dev)
    counts = {"plain": 0, "spec": 0, "prefills": 0, "n_emit": []}
    dispatch, admit = eng._dispatch_block, eng._admit_one_shot
    process_spec = eng._process_spec

    def counted_dispatch():
        payload, snap = dispatch()
        counts["spec" if payload[0] == "spec" else "plain"] += 1
        return payload, snap

    def counted_admit(batch):
        counts["prefills"] += 1
        return admit(batch)

    def counted_spec(emits, lps, n_emit, snap):
        counts["n_emit"].append(n_emit.copy())
        return process_spec(emits, lps, n_emit, snap)

    eng._dispatch_block, eng._admit_one_shot = counted_dispatch, counted_admit
    eng._process_spec = counted_spec
    real_verify = SP._verify_forward

    def verify(cfg_, params_, tokens, positions, cache):
        logits, cache = real_verify(cfg_, params_, tokens, positions, cache)
        lf = logits[:, :-1].float()
        gaps.append(lf.amax(-1) - torch.gather(
            lf, -1, tokens[:, 1:].long()[..., None])[..., 0])
        return logits, cache

    for i, (p, sp) in enumerate(zip(prompts, sps)):
        eng.submit(Request(rid=i, prompt=p, sampling=sp))
    wr = kernel_wrappers()
    zero_counts()
    if gaps is not None:
        SP._verify_forward = verify
    try:
        with no_plain_versions(torch, dev):
            done = sorted(eng.run(), key=lambda r: r.rid)
        torch.cuda.synchronize()
    finally:
        SP._verify_forward = real_verify
    launches = {k: wr[k].launches for k in SPEC_KERNELS}
    if len(done) != len(prompts) or not all(r.done for r in done):
        raise AssertionError(f"speculate {speculate}: unfinished requests")
    for r in done:
        if len(r.tokens) != r.sampling.max_new_tokens or not all(
                0 <= t < cfg.vocab_size for t in r.tokens):
            raise AssertionError(f"speculate {speculate} request {r.rid}: "
                                 f"{len(r.tokens)} tokens or outside vocab")
        if not all(math.isfinite(lp) and lp <= 0 for lp in r.logprobs):
            raise AssertionError(f"speculate {speculate} request {r.rid}: "
                                 "non-finite log-probs")
    m = eng.metrics
    del eng, dispatch, admit, process_spec
    gc.collect()
    return done, m, counts, launches


def forced_margin(torch, M, cfg, params, prompt, toks, t, dev):
    """The top-2 margin of the logits that chose toks[t] after the prompt
    and toks[:t], read by one-row greedy decoding along `toks`."""
    cache = M.init_kv_cache(cfg, 1, max_len=len(prompt) + t + 1, device=dev)
    logits, cache = M.prefill(cfg, params, torch.tensor(
        [prompt], device=dev, dtype=torch.int32), cache)
    for i in range(t):
        logits, cache = M.decode_step(
            cfg, params, torch.tensor([toks[i]], device=dev,
                                      dtype=torch.int32),
            torch.tensor([len(prompt) + i], device=dev, dtype=torch.int32),
            cache)
    top = logits[0].float().topk(2).values
    return float(top[0] - top[1])


def guard_fork(torch, M, cfg, params, prompt, got, want, dev):
    """got == want, or they fork first where want's margin (forced_margin)
    is under NEAR_TIE; returns the verdict."""
    if got == want:
        return "equal"
    t = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), None)
    if t is None:
        raise AssertionError("token lists differ in length")
    margin = forced_margin(torch, M, cfg, params, prompt, want, t, dev)
    if margin >= NEAR_TIE:
        raise AssertionError(f"speculation diverged at step {t} with a "
                             f"decisive margin {margin}")
    return f"near-tie fork at step {t} (margin {margin:.4e})"


def spec_stats(counts, g):
    """Verify rows (active row-steps), tokens a verify row, rows that
    accepted a draft, rows that emitted all G + 1."""
    import numpy as np

    n = (np.concatenate(counts["n_emit"]) if counts["n_emit"]
         else np.zeros((0, 8), np.int32))
    rows = n[n > 0]
    return dict(verify_forwards=int(n.shape[0]), verify_rows=int(rows.size),
                tokens_per_row=float(rows.mean()) if rows.size else 0.0,
                accepted_rows=int((rows > 1).sum()),
                full_rows=int((rows == g + 1).sum()))


def check_rejection_marginal(torch, dev):
    """rejection_sample_step on the card with a CUDA generator against the
    reference's Monte-Carlo marginal: TV < 0.04, acceptance in (0.05, 1)."""
    import numpy as np

    from piquant_tpu_torch.models import speculative as SP

    rng = np.random.default_rng(0xACC)
    p_row = torch.from_numpy(rng.dirichlet(np.ones(MC_V)).astype(
        np.float32)).to(dev)
    q_row = torch.from_numpy(rng.dirichlet(np.ones(MC_V) * 0.3).astype(
        np.float32)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    p = p_row.expand(MC_N, MC_G + 1, MC_V)
    q = q_row.expand(MC_N, MC_G, MC_V)
    drafts = torch.multinomial(q.reshape(-1, MC_V), 1, generator=gen).reshape(
        MC_N, MC_G).to(torch.int32)
    n_acc, next_tok = SP.rejection_sample_step(p, q, drafts, gen)
    first = torch.where(n_acc >= 1, drafts[:, 0], next_tok).long()
    emp = torch.bincount(first, minlength=MC_V).double() / MC_N
    tv = 0.5 * float((emp - p_row.double()).abs().sum())
    acc = float((n_acc >= 1).double().mean())
    print(f"spec (c): rejection_sample_step on the card, V {MC_V}, G {MC_G}, "
          f"n {MC_N}: TV {tv:.4f} (< 0.04), acceptance {acc:.4f}",
          flush=True)
    if not (tv < 0.04 and 0.05 < acc < 1.0):
        raise AssertionError(f"rejection sampling marginal: TV {tv}, "
                             f"acceptance {acc}")


def run_spec_cli(torch, dev, args):
    """Phase 17 (d): the CLI's speculative flags at CLI_DEPTH layers, full
    width: every request completes; the launches of SPEC_KERNELS summed."""
    from piquant_tpu_torch.serving import __main__ as S

    total = dict.fromkeys(SPEC_KERNELS, 0)
    wr = kernel_wrappers()
    for flags in SPEC_CLI_RUNS:
        argv = ["--random", "llama3_8b", "--speculate", str(SPEC_G),
                "--benchmark", "4", "--max-new", "16", *flags]
        cli_args = S.build_parser().parse_args(argv)
        cfg, params, eng, sp = S.build(cli_args)
        zero_counts()
        with no_plain_versions(torch, dev):
            metrics, done = S.benchmark(cli_args, cfg, eng, sp)
        torch.cuda.synchronize()
        launches = {k: wr[k].launches for k in SPEC_KERNELS}
        tag = " ".join(argv[2:])
        want = ({"wg_chunk"} if "--draft-group-size" in flags else
                {"w2_gemv"} if flags else set()) | {"w4_gemv", "w8_gemv"}
        if flags:
            want.add("decode_attn2")
        print(f"spec cli [{tag}]: launches {launches}; "
              f"{json.dumps(metrics)} [{card_line()}]", flush=True)
        if metrics["completed"] != 4 or any(len(r.tokens) != 16
                                            for r in done):
            raise AssertionError(f"spec cli [{tag}]: unfinished requests")
        if not all(launches[k] > 0 for k in want):
            raise AssertionError(f"spec cli [{tag}]: {sorted(want)} not all "
                                 "launched")
        for k in total:
            total[k] += launches[k]
        del params, eng, done
        gc.collect()
        torch.cuda.empty_cache()
    return total


def run_speculative(torch, dev, gen, args, w4_row):
    """Phase 17: Llama-3-8B at full width and depth, random INT4 codes,
    INT8 lm_head, kv8, 8 slots, decode_block 4, speculate 4: (a) prompt
    lookup against plain greedy, (b) an INT2 requantize_params draft and
    the target as its own draft, (c) rejection sampling, (d) the CLI.
    Adds the M = 40 hold and times of w4_gemv to its kernels-line row and
    returns the launches of SPEC_KERNELS over the phase."""
    import numpy as np

    from piquant_tpu_torch.models import llama as M
    from piquant_tpu_torch.serving import (Engine, EngineConfig, Request,
                                           SamplingParams)

    m40 = check_gemv(torch, dev, gen, "w4_gemv", 4, None, W4_SHAPES,
                     torch.bfloat16, hold_m=(8 * (SPEC_G + 1),),
                     m_timed=8 * (SPEC_G + 1))
    print(f"spec: w4_gemv at M = {8 * (SPEC_G + 1)} (one verify layer, 7 "
          f"projections): kernel {m40['ms']:.4f} ms, bound "
          f"{m40['bound_ms']:.4f} ms ({m40['bound_by']}), plain "
          f"{m40['plain_ms']:.4f} ms, torch.matmul {m40['library_ms']:.4f} "
          f"ms, max_abs_err {m40['max_abs_err']:.3e} [{card_line()}]",
          flush=True)
    w4_row["verify_m40"] = {k: m40[k] for k in (
        "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
        "library_ms")}
    total = dict.fromkeys(SPEC_KERNELS, 0)

    def add(launches):
        for k in total:
            total[k] += launches[k]

    cfg = M.LlamaConfig.llama3_8b()
    nl = cfg.n_layers
    params = M.random_quantized_params(cfg, seed=args.seed, lm_head_bits=8,
                                       device=dev)
    prompts = spec_prompts(cfg, args.seed)
    greedy = [SamplingParams(max_new_tokens=SPEC_NEW)] * len(prompts)

    # (a) prompt lookup against plain greedy
    plain, pm, pc, pl = spec_engine(torch, dev, args, cfg, params, prompts,
                                    greedy, 0)
    add(pl)
    spec, sm, sc, sl = spec_engine(torch, dev, args, cfg, params, prompts,
                                   greedy, SPEC_G)
    add(sl)
    st = spec_stats(sc, SPEC_G)
    v, p = st["verify_forwards"], sc["prefills"]
    expect = {"w4_gemv": 7 * nl * v, "w8_gemv": v + p, "w2_gemv": 0,
              "wg_chunk": 0, "decode_attn2": 0, "flash_prefill": nl * p}
    print(f"spec (a) prompt lookup: {sc['spec']} speculative blocks and "
          f"{sc['plain']} plain, {v} verify forwards, {st['verify_rows']} "
          f"verify rows, {st['tokens_per_row']:.3f} tokens emitted a verify "
          f"row, {st['accepted_rows']} rows accepted a draft, "
          f"{st['full_rows']} all {SPEC_G}; launches {sl}, expected "
          f"{expect}; a verify forward launches "
          f"{ {k: sl[k] / v for k in ('w4_gemv', 'w8_gemv')} } (the "
          f"prefills' lm_head besides)", flush=True)
    if sl != expect or sc["plain"]:
        raise AssertionError(f"spec (a): launches {sl} != {expect}, or "
                             f"{sc['plain']} plain blocks")
    if not st["accepted_rows"]:
        raise AssertionError("spec (a): prompt lookup accepted no draft")
    for r, w in zip(spec, plain):
        verdict = guard_fork(torch, M, cfg, params, r.prompt, r.tokens,
                             w.tokens, dev)
        print(f"spec (a): request {r.rid} (prompt {len(r.prompt)}) vs plain "
              f"greedy: {verdict}", flush=True)
    print(f"spec (a): decode {sm.decode_tokens_per_s:.2f} tok/s with prompt "
          f"lookup, {pm.decode_tokens_per_s:.2f} without (one run each, in "
          f"this call only; served rates move between calls) "
          f"[{card_line()}]", flush=True)

    # (b) an INT2 draft made by requantize_params, then the target itself
    t0 = time.perf_counter()
    dparams = M.requantize_params(params, 2)
    torch.cuda.synchronize()
    print(f"spec (b): requantize_params(params, 2) in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    got, dm, dc, dl = spec_engine(torch, dev, args, cfg, params, prompts,
                                  greedy, SPEC_G, draft=(cfg, dparams))
    add(dl)
    st = spec_stats(dc, SPEC_G)
    v, p = st["verify_forwards"], dc["prefills"]
    steps = v * (SPEC_G + 1)       # the draft's decode steps
    expect = {"w4_gemv": 7 * nl * v, "w8_gemv": v + p,
              "w2_gemv": (7 * nl + 1) * steps + p, "wg_chunk": 0,
              "decode_attn2": nl * steps, "flash_prefill": 2 * nl * p}
    print(f"spec (b) INT2 draft: {v} verify forwards, {st['verify_rows']} "
          f"verify rows, {st['tokens_per_row']:.3f} tokens a verify row, "
          f"{st['accepted_rows']} rows accepted a draft, {st['full_rows']} "
          f"all {SPEC_G}; launches {dl}, expected {expect}", flush=True)
    if dl != expect or dc["plain"]:
        raise AssertionError(f"spec (b): launches {dl} != {expect}, or "
                             f"{dc['plain']} plain blocks")
    for r, w in zip(got, plain):
        verdict = guard_fork(torch, M, cfg, params, r.prompt, r.tokens,
                             w.tokens, dev)
        print(f"spec (b): INT2 draft, request {r.rid} vs plain greedy: "
              f"{verdict}", flush=True)
    print(f"spec (b): decode {dm.decode_tokens_per_s:.2f} tok/s with the "
          f"INT2 draft (this call only) [{card_line()}]", flush=True)
    gaps = []
    got, _, fc, fl = spec_engine(torch, dev, args, cfg, params,
                                 prompts[:SPEC_PERFECT],
                                 greedy[:SPEC_PERFECT], SPEC_G,
                                 draft=(cfg, params), gaps=gaps)
    add(fl)
    st = spec_stats(fc, SPEC_G)
    n_emit = np.concatenate(fc["n_emit"])
    gap = torch.stack(gaps).cpu().numpy()            # [V, B, G]
    if gap.shape[0] != n_emit.shape[0]:
        raise AssertionError(f"spec (b): {gap.shape[0]} verify calls, "
                             f"{n_emit.shape[0]} counted")
    worst = 0.0
    for vi, b in zip(*(n_emit > 0).nonzero()):
        j = int(n_emit[vi, b]) - 1                   # the rejected draft
        if j < SPEC_G:
            worst = max(worst, float(gap[vi, b, j]))
    share = st["full_rows"] / max(st["verify_rows"], 1)
    print(f"spec (b) the target as its own draft, {SPEC_PERFECT} requests: "
          f"{st['verify_forwards']} verify forwards, {st['verify_rows']} "
          f"verify rows, {st['full_rows']} emitted {SPEC_G + 1} "
          f"({100 * share:.1f}%), {st['tokens_per_row']:.3f} tokens a "
          f"verify row, {st['verify_rows'] - st['full_rows']} rejections, "
          f"the largest verify gap at a rejected draft {worst:.4e}; "
          f"launches {fl} [{card_line()}]", flush=True)
    if share < SPEC_FULL or worst >= NEAR_TIE:
        raise AssertionError(f"spec (b): {share:.3f} of verify rows emitted "
                             f"G + 1, a rejection at gap {worst}")
    for r, w in zip(got, plain):
        verdict = guard_fork(torch, M, cfg, params, r.prompt, r.tokens,
                             w.tokens, dev)
        print(f"spec (b): perfect draft, request {r.rid} vs plain greedy: "
              f"{verdict}", flush=True)

    # (c) rejection sampling: pure temperature, the INT2 draft, twice
    sampled = [SamplingParams(temperature=SPEC_TEMP,
                              max_new_tokens=SPEC_NEW)] * 4
    runs = []
    for _ in range(2):
        done, cm, cc, cl = spec_engine(torch, dev, args, cfg, params,
                                       prompts[2:6], sampled, SPEC_G,
                                       draft=(cfg, dparams))
        add(cl)
        if cc["plain"] or not cc["spec"]:
            raise AssertionError("spec (c): a temperature block left "
                                 "rejection sampling")
        runs.append([r.tokens for r in done])
    st = spec_stats(cc, SPEC_G)
    print(f"spec (c) rejection sampling, temperature {SPEC_TEMP}, INT2 "
          f"draft: {st['verify_forwards']} verify forwards, "
          f"{st['tokens_per_row']:.3f} tokens a verify row; two runs from "
          f"one seed {'identical' if runs[0] == runs[1] else 'DIFFER'}; "
          f"decode {cm.decode_tokens_per_s:.2f} tok/s; launches {cl} "
          f"[{card_line()}]", flush=True)
    if runs[0] != runs[1]:
        raise AssertionError("spec (c): sampled runs from one seed differ")
    eng = Engine(cfg, params, EngineConfig(batch_slots=8, max_seq_len=2048,
                                           decode_block=4, speculate=SPEC_G),
                 draft=(cfg, dparams), device=dev)
    eng.submit(Request(rid=0, prompt=prompts[4], sampling=SamplingParams(
        temperature=SPEC_TEMP, top_k=50, max_new_tokens=4)))
    eng._admit()
    if eng._spec_mode() is not None:
        raise AssertionError("spec (c): a top-k slot speculated")
    del eng
    check_rejection_marginal(torch, dev)
    del params, dparams
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the CLI
    with cut_depth("llama3_8b", CLI_DEPTH):
        add(run_spec_cli(torch, dev, args))
    print(f"spec: phase 17 launches {total}", flush=True)
    return total


# ---------------------------------------------------------------------------
# phase 18: the loader, the weight cache and GQA reps above 8
# ---------------------------------------------------------------------------

GQA_REPS = (9, 12, 16, 64)    # odd, Mistral-Large-2's, Qwen3-235B-A22B's,
                              # a multi-query layer of 64 heads
# Qwen3-235B-A22B's decode cache at the CLI's 2048 positions (8 of its 94
# layers, enough that the timing's layers stream from HBM) and prefill; its
# 4 kv heads at every rep
GQA_CACHE = (8, 8, 4, 2048)
GQA_POS = (1, 300, 2047, 1000, 1501, 511, 273, 2048)
GQA_STARTS = (0, 0, 1024, 0, 900, 0, 0, 1000)
GQA_FLASH = (8, 4, 1024)      # B, Hkv, T of the causal holds
GQA_FLASH_SMALL = (2, 4, 1024)  # of the window and sinks holds
GQA_WINDOW = 256


def check_gqa_reps(torch, dev, gen, rows):
    """Phase 18's kernel holds: decode_attn2 (kv8 and kv4), decode_attn
    (the V1 form) and flash (causal, window, sinks) against their plain
    versions at each of GQA_REPS with head_dim 128, at Qwen3-235B-A22B's
    decode (B 8, Hkv 4, S 2048; live windows from GQA_STARTS to GQA_POS)
    and prefill (B 8, Hkv 4, T 1024) geometries, each with its ms, bound
    and SDPA's time, as a variant of its kernels-line row in `rows`."""
    by_name = {r["name"]: r for r in rows}

    def add(name, what, res):
        row = by_name[name]
        row.setdefault("variants", {})[what] = res
        row["max_abs_err"] = max(row["max_abs_err"], res["max_abs_err"])

    nl, b, hkv, s = GQA_CACHE
    fb, fh, ft = GQA_FLASH
    sb, sh, st = GQA_FLASH_SMALL
    for rep in GQA_REPS:
        tag = f"rep {rep}: L={nl}, B={b}, Hkv={hkv}, S={s}"
        for kv4, name in ((False, "decode_attn2"), (True, "decode_attn2_kv4")):
            add(name, tag, hold_decode(torch, dev, gen, kv4,
                                       (nl, b, hkv, rep, s), GQA_POS,
                                       GQA_STARTS))
        _, res = hold_v1(torch, dev, gen, b, hkv, rep, s, 128,
                         f"rep {rep}")
        for what, r in res.items():
            add("decode_attn", f"rep {rep}: B={b}, Hkv={hkv}, S={s}, {what}",
                r)
        add("flash_prefill", f"rep {rep}: B={fb}, Hkv={fh}, T={ft}, causal",
            hold_flash(torch, dev, gen, fb, fh, rep, ft, None))
        add("flash_prefill", f"rep {rep}: B={sb}, Hkv={sh}, T={st}, window "
            f"{GQA_WINDOW}", hold_flash(torch, dev, gen, sb, sh, rep, st,
                                        GQA_WINDOW))
        add("flash_prefill", f"rep {rep}: B={sb}, Hkv={sh}, T={st}, causal, "
            "sinks", hold_flash(torch, dev, gen, sb, sh, rep, st, None,
                                sinks=True))
        torch.cuda.empty_cache()


# Llama-3.1-8B's published config.json (meta-llama/Llama-3.1-8B), the
# checkpoint phase 18 (a) writes from a seed and serves from disk at
# LOADER_DEPTH of its 32 layers
LLAMA31_8B = {
    "architectures": ["LlamaForCausalLM"], "attention_bias": False,
    "attention_dropout": 0.0, "bos_token_id": 128000,
    "eos_token_id": 128001, "hidden_act": "silu", "hidden_size": 4096,
    "initializer_range": 0.02, "intermediate_size": 14336,
    "max_position_embeddings": 131072, "mlp_bias": False,
    "model_type": "llama", "num_attention_heads": 32,
    "num_hidden_layers": 32, "num_key_value_heads": 8, "pretraining_tp": 1,
    "rms_norm_eps": 1e-05,
    "rope_scaling": {"factor": 8.0, "low_freq_factor": 1.0,
                     "high_freq_factor": 4.0,
                     "original_max_position_embeddings": 8192,
                     "rope_type": "llama3"},
    "rope_theta": 500000.0, "tie_word_embeddings": False,
    "torch_dtype": "bfloat16", "use_cache": True, "vocab_size": 128256}
# Qwen3-235B-A22B's (Qwen/Qwen3-235B-A22B): rep 16 attention, 128 experts,
# served by phase 18 (b) at QWEN235_DEPTH of its 94 layers
QWEN3_235B = {
    "architectures": ["Qwen3MoeForCausalLM"], "attention_bias": False,
    "attention_dropout": 0.0, "bos_token_id": 151643,
    "decoder_sparse_step": 1, "eos_token_id": 151645, "head_dim": 128,
    "hidden_act": "silu", "hidden_size": 4096, "initializer_range": 0.02,
    "intermediate_size": 12288, "max_position_embeddings": 40960,
    "max_window_layers": 94, "mlp_only_layers": [],
    "model_type": "qwen3_moe", "moe_intermediate_size": 1536,
    "norm_topk_prob": True, "num_attention_heads": 64, "num_experts": 128,
    "num_experts_per_tok": 8, "num_hidden_layers": 94,
    "num_key_value_heads": 4, "output_router_logits": False,
    "rms_norm_eps": 1e-06, "rope_scaling": None, "rope_theta": 1000000.0,
    "router_aux_loss_coef": 0.001, "sliding_window": None,
    "tie_word_embeddings": False, "torch_dtype": "bfloat16",
    "use_cache": True, "use_sliding_window": False, "vocab_size": 151936}
LOADER_DEPTH = 4
QWEN235_DEPTH = 2             # its bf16 experts: 4.8 GB a layer
LOADER_NEW = 16               # greedy tokens a request of (a)'s engine runs
QWEN235_NEW = 32
LOADER_CLI_RUNS = (((), _gemv_only({"w4_gemv": 7})),)


def hf_state_dict(torch, conf, dev, gen):
    """A checkpoint's state dict in HF names and nn.Linear's [out, in]
    layout (rotate-half q / k, as HF stores them), bf16 on the card from
    the generator: N(0, 0.02) weights, norms near 1 (so a swapped norm
    shows); Qwen3-MoE's qk-norms, router and per-expert projections."""
    d, v = conf["hidden_size"], conf["vocab_size"]
    nh, nkv = conf["num_attention_heads"], conf["num_key_value_heads"]
    hd = conf.get("head_dim") or d // nh
    moe = conf["model_type"] == "qwen3_moe"

    def w(*shape):
        return (torch.randn(shape, generator=gen, device=dev) * 0.02).to(
            torch.bfloat16)

    def norm(n):
        return (1 + 0.1 * torch.randn(n, generator=gen, device=dev)).to(
            torch.bfloat16)

    sd = {"model.embed_tokens.weight": w(v, d), "model.norm.weight": norm(d),
          "lm_head.weight": w(v, d)}
    for i in range(conf["num_hidden_layers"]):
        p = f"model.layers.{i}."
        sd[p + "input_layernorm.weight"] = norm(d)
        sd[p + "post_attention_layernorm.weight"] = norm(d)
        for name, n_out, n_in in (("q_proj", nh * hd, d), ("k_proj", nkv * hd, d),
                                  ("v_proj", nkv * hd, d), ("o_proj", d, nh * hd)):
            sd[p + f"self_attn.{name}.weight"] = w(n_out, n_in)
        if not moe:
            f = conf["intermediate_size"]
            sd[p + "mlp.gate_proj.weight"] = w(f, d)
            sd[p + "mlp.up_proj.weight"] = w(f, d)
            sd[p + "mlp.down_proj.weight"] = w(d, f)
            continue
        sd[p + "self_attn.q_norm.weight"] = norm(hd)
        sd[p + "self_attn.k_norm.weight"] = norm(hd)
        f, ne = conf["moe_intermediate_size"], conf["num_experts"]
        sd[p + "mlp.gate.weight"] = w(ne, d)
        for e in range(ne):
            sd[p + f"mlp.experts.{e}.gate_proj.weight"] = w(f, d)
            sd[p + f"mlp.experts.{e}.up_proj.weight"] = w(f, d)
            sd[p + f"mlp.experts.{e}.down_proj.weight"] = w(d, f)
    return sd


def leaves_equal(torch, a, b, path=""):
    """Two param trees leaf for leaf, bit for bit (quantized leaves field
    by field); raises naming the first leaf that differs."""
    if isinstance(a, dict):
        if set(a) != set(b):
            raise AssertionError(f"{path}: keys {sorted(set(a) ^ set(b))}")
        for k in a:
            leaves_equal(torch, a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list):
        for i, (x, y) in enumerate(zip(a, b, strict=True)):
            leaves_equal(torch, x, y, f"{path}/{i}")
    elif isinstance(a, torch.Tensor):
        if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(
                a.view(torch.uint8) if a.dtype == torch.uint16 else a,
                b.view(torch.uint8) if b.dtype == torch.uint16 else b):
            raise AssertionError(f"{path}: leaves differ")
    elif a is None or isinstance(a, (int, str)):
        if a != b:
            raise AssertionError(f"{path}: {a} != {b}")
    else:
        for f in ("data", "scale", "zero_point", "s_chunk", "z_chunk",
                  "bits", "k", "group_size", "codebook"):
            leaves_equal(torch, getattr(a, f), getattr(b, f), f"{path}.{f}")


def tree_bytes(torch, tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(torch, v) for v in tree.values())
    if isinstance(tree, list):
        return sum(tree_bytes(torch, v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return sum(tree_bytes(torch, getattr(tree, f)) for f in
               ("data", "scale", "zero_point", "s_chunk", "z_chunk")
               if isinstance(getattr(tree, f, None), torch.Tensor))


def loader_engine(torch, dev, args, cfg, params, n_req, lens, n_new,
                  label):
    """n_req greedy requests (prompt lengths in [lens[0], lens[1]) from the
    seed) through an Engine of 8 slots whose prefills pad to 128-row tiles
    (so flash takes them); every request complete, tokens in the vocab.
    Returns (finished requests by rid, the engine, launches)."""
    import numpy as np

    from piquant_tpu_torch.serving import (Engine, EngineConfig, Request,
                                           SamplingParams)

    rng = np.random.default_rng(args.seed + 18)
    ec = EngineConfig(batch_slots=8, max_seq_len=1024, prefill_pad=128,
                      decode_block=8)
    eng = Engine(cfg, params, ec, rng_seed=args.seed, device=dev)
    for i in range(n_req):
        plen = int(rng.integers(*lens))
        eng.submit(Request(rid=i, prompt=[int(t) for t in rng.integers(
            1, cfg.vocab_size, plen)], sampling=SamplingParams(
                max_new_tokens=n_new)))
    zero_counts()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v.launches for k, v in kernel_wrappers().items()
                if v.launches}
    if len(done) != n_req or any(len(r.tokens) != n_new or not all(
            0 <= t < cfg.vocab_size for t in r.tokens) for r in done):
        raise AssertionError(f"{label}: requests unfinished or tokens "
                             "outside the vocab")
    m = eng.metrics.to_dict()
    print(f"{label}: {n_req} requests in {wall:.2f} s, launches {launches}; "
          f"metrics {json.dumps(m)} [{card_line()}]", flush=True)
    return {r.rid: r for r in done}, eng, launches


def guard_engine(torch, M, cfg, params, dev, done, eng, n, n_new, label):
    """The first n finished requests' greedy tokens against the port's own
    single-request generation at the engine's padded width and cache
    length (the prefill's shapes, and with them its kernels, the same),
    under the near-tie guard."""
    for r in [done[k] for k in sorted(done)][:n]:
        want, margins = generate_single(
            torch, M, cfg, params, r.prompt, n_new, dev,
            width=eng._padded_len(len(r.prompt)), max_len=eng.ec.max_seq_len)
        print(f"{label}: request {r.rid} (prompt {len(r.prompt)}) vs "
              f"single-request generation: "
              f"{check_tokens_guarded(r.tokens, want, margins)}", flush=True)


def f32_logits(torch, M, cfg, params, tokens, dev):
    """Logits [T, V] of a plain f32 forward of a dense Llama over `tokens`
    (no cache, no kernel): every weight dequantized to f32, f32 activations
    and scores, an exact causal softmax, TF32 off."""
    def dense(w):
        return (w.float() if isinstance(w, torch.Tensor)
                else w.dequantize(torch.float32))

    t, hd = len(tokens), cfg.head_dim
    rep = cfg.n_heads // cfg.n_kv_heads
    cos, sin = M._rope_freqs(cfg, torch.arange(t, device=dev)[None])
    dead = torch.ones(t, t, dtype=torch.bool, device=dev).triu(1)
    x = params["embed"][torch.tensor(tokens, device=dev)][None].float()
    for layer in params["layers"]:
        h = M.rms_norm(x, layer["attn_norm"].float(), cfg.rms_eps)
        q, k, v = ((h @ dense(layer[n])).reshape(1, t, -1, hd).transpose(1, 2)
                   for n in ("wq", "wk", "wv"))
        q, k = M.apply_rope(q, cos, sin), M.apply_rope(k, cos, sin)
        k, v = (a.repeat_interleave(rep, dim=1) for a in (k, v))
        p = torch.softmax((q @ k.transpose(-1, -2) * hd ** -0.5).masked_fill(
            dead, float("-inf")), dim=-1)
        x = x + (p @ v).transpose(1, 2).reshape(1, t, -1) @ dense(layer["wo"])
        h = M.rms_norm(x, layer["mlp_norm"].float(), cfg.rms_eps)
        x = x + (torch.nn.functional.silu(h @ dense(layer["w1"]))
                 * (h @ dense(layer["w3"]))) @ dense(layer["w2"])
    x = M.rms_norm(x, params["final_norm"].float(), cfg.rms_eps)
    return (x @ dense(params["lm_head"]))[0]


def prefill_witness(torch, M, cfg, params, prompt, n_new, dev, width,
                    max_len):
    """Phase 18 (a)'s witness of its two prefill paths: single-request
    generation prefilled at the engine's padded `width` (flash) and at the
    prompt's own length (the materialized path), each path's logits at the
    first step and at the first step where their tokens part (else the
    last) against a plain f32 forward of the tokens both chose before it.
    Prints what it reads and checks nothing."""
    paths = {}
    for name, kw in (("flash", dict(width=width, max_len=max_len)),
                     ("materialized", {})):
        kept = []
        toks, margins = generate_single(torch, M, cfg, params, prompt, n_new,
                                        dev, keep=kept, **kw)
        paths[name] = toks, margins, kept
    (ft, fm, fl), (mt, mm, ml) = paths["flash"], paths["materialized"]
    fork = next((i for i, (a, b) in enumerate(zip(ft, mt)) if a != b), None)
    step = n_new - 1 if fork is None else fork
    ref = f32_logits(torch, M, cfg, params, list(prompt) + ft[:step], dev)
    n0 = len(prompt) - 1

    def err(kept, i):
        d = kept[i] - ref[n0 + i]
        return f"{d.abs().max():.4e} max, {d.pow(2).mean().sqrt():.4e} rms"

    head = f"loader (a) witness, prompt {len(prompt)}: "
    if fork is None:
        head += f"flash (width {width}) and materialized agree for {n_new}"
    else:
        a, b = ft[fork], mt[fork]
        f32 = ref[-1]
        head += (f"flash (width {width}) takes {a} (margin {fm[fork]:.4e}) "
                 f"and materialized {b} (margin {mm[fork]:.4e}) at step "
                 f"{fork}; f32 logit({a}) - logit({b}) "
                 f"{float(f32[a] - f32[b]):.4e}, f32's top {int(f32.argmax())}")
    print(head + f"; against f32 at step 0: flash {err(fl, 0)}, materialized "
          f"{err(ml, 0)}; at step {step}: flash {err(fl, step)}, materialized "
          f"{err(ml, step)} [{card_line()}]", flush=True)


def run_loader(torch, dev, gen, args):
    """Phase 18: (a) Llama-3.1-8B from a sharded safetensors directory the
    port writes, loaded, quantized, cached, served through the Engine and
    the CLI's --model; (b) Qwen3-235B-A22B's rep-16 geometry through
    params_from_state_dict on the card, served at INT4.  Returns the
    kernels' launches summed over both."""
    import shutil
    import tempfile

    from piquant_tpu_torch.models import llama as M
    from piquant_tpu_torch.models import loader as L
    from piquant_tpu_torch.utils import safetensors_io as ST
    from piquant_tpu_torch.utils import weight_cache as WC

    total = {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    # ---- (a) Llama-3.1-8B from disk
    conf = dict(LLAMA31_8B, num_hidden_layers=LOADER_DEPTH)
    print(f"loader (a): Llama-3.1-8B at its published widths, "
          f"num_hidden_layers cut to {LOADER_DEPTH} of "
          f"{LLAMA31_8B['num_hidden_layers']}", flush=True)
    sd = hf_state_dict(torch, conf, dev, gen)
    nbytes = sum(t.numel() * t.element_size() for t in sd.values())
    tmp = tempfile.mkdtemp(prefix="pq_loader_")
    try:
        free = shutil.disk_usage(tmp).free
        need = 3 * nbytes          # the checkpoint, the cache, the export
        if free < need:
            raise RuntimeError(f"loader: {free / 1e9:.1f} GB free under "
                               f"{tmp}, {need / 1e9:.1f} GB needed")
        ckpt = os.path.join(tmp, "llama31_8b")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        files = ST.save_checkpoint(sd, ckpt, shards=2)
        with open(os.path.join(ckpt, "config.json"), "w") as f:
            json.dump(conf, f)
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        disk = ST.load_checkpoint(ckpt, dev)
        torch.cuda.synchronize()
        t_read = time.perf_counter() - t0
        print(f"loader (a): wrote {len(files)} shards, {nbytes / 1e9:.3f} "
              f"GB, in {t_write:.2f} s; read them back to the card in "
              f"{t_read:.2f} s ({nbytes / 1e9 / t_read:.2f} GB/s; page cache "
              f"warm from the write) [{card_line()}]", flush=True)
        for k, t in sd.items():
            if not torch.equal(disk[k], t):
                raise AssertionError(f"loader (a): {k} read back differs")
        cfg = L.config_from_hf(L.read_config(ckpt))
        if cfg.llama3_rope is None or cfg.llama3_rope.factor != 8.0:
            raise AssertionError("loader (a): llama3 rope scaling lost")
        t0 = time.perf_counter()
        _, fparams = L.load_from_hf(ckpt, device=dev)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        leaves_equal(torch, fparams, L.params_from_state_dict(sd, cfg,
                                                              device=dev))
        del disk, sd
        print(f"loader (a): load_from_hf in {t_load:.2f} s; every leaf "
              "equal to params_from_state_dict of the tensors in memory",
              flush=True)
        t0 = time.perf_counter()
        qparams = M.quantize_params(fparams, bits=4)
        torch.cuda.synchronize()
        t_quant = time.perf_counter() - t0
        del fparams
        qbytes = tree_bytes(torch, qparams)
        cache = os.path.join(tmp, "cache")
        t0 = time.perf_counter()
        WC.save_quantized(cache, qparams)
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = WC.load_quantized(cache, device=dev)
        torch.cuda.synchronize()
        t_reload = time.perf_counter() - t0
        leaves_equal(torch, back, qparams)
        st = os.path.join(tmp, "export.safetensors")
        t0 = time.perf_counter()
        ST.save_safetensors(st, qparams)
        t_st_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        leaves_equal(torch, ST.load_safetensors(st, device=dev), qparams)
        t_st_load = time.perf_counter() - t0
        print(f"loader (a): quantize_params INT4 on the card in "
              f"{t_quant:.2f} s; weight cache of {qbytes / 1e9:.3f} GB saved "
              f"in {t_save:.2f} s, reloaded in {t_reload:.2f} s; safetensors "
              f"export saved in {t_st_save:.2f} s, reloaded in "
              f"{t_st_load:.2f} s; every leaf back bit for bit "
              f"[{card_line()}]", flush=True)
        done, eng, launches = loader_engine(torch, dev, args, cfg, qparams,
                                            8, (128, 513), LOADER_NEW,
                                            "loader (a) engine")
        add(launches)
        again, _, launches = loader_engine(torch, dev, args, cfg, back, 8,
                                           (128, 513), LOADER_NEW,
                                           "loader (a) engine, reloaded")
        add(launches)
        if any(again[k].tokens != done[k].tokens for k in done):
            raise AssertionError("loader (a): the reloaded params' tokens "
                                 "differ from the params' before saving")
        guard_engine(torch, M, cfg, qparams, dev, done, eng, 2, LOADER_NEW,
                     "loader (a) engine")
        prefill_witness(torch, M, cfg, qparams, done[0].prompt, LOADER_NEW,
                        dev, eng._padded_len(len(done[0].prompt)),
                        eng.ec.max_seq_len)
        del back, qparams, done, again, eng
        gc.collect()
        torch.cuda.empty_cache()
        add(run_cli(torch, dev, args, LOADER_CLI_RUNS,
                    counted=("w4_gemv", "decode_attn2", "flash_prefill"),
                    model=("--model", ckpt, "--bits", "4"), padded=True))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (b) Qwen3-235B-A22B's geometry, no disk
    conf = dict(QWEN3_235B, num_hidden_layers=QWEN235_DEPTH)
    print(f"loader (b): Qwen3-235B-A22B at its published widths (64 query "
          f"heads over 4 kv heads: rep 16; 128 experts, top 8), "
          f"num_hidden_layers cut to {QWEN235_DEPTH} of "
          f"{QWEN3_235B['num_hidden_layers']}", flush=True)
    sd = hf_state_dict(torch, conf, dev, gen)
    cfg = L.config_from_hf(conf)
    if cfg.n_heads // cfg.n_kv_heads != 16 or not cfg.qk_norm:
        raise AssertionError(f"loader (b): config {cfg}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fparams = L.params_from_state_dict(sd, cfg, device=dev)
    torch.cuda.synchronize()
    t_map = time.perf_counter() - t0
    del sd
    t0 = time.perf_counter()
    qparams = M.quantize_params(fparams, bits=4)
    torch.cuda.synchronize()
    t_quant = time.perf_counter() - t0
    del fparams
    gc.collect()
    torch.cuda.empty_cache()
    print(f"loader (b): params_from_state_dict in {t_map:.2f} s, INT4 "
          f"quantize_params in {t_quant:.2f} s [{card_line()}]", flush=True)
    done, eng, launches = loader_engine(torch, dev, args, cfg, qparams, 8,
                                        (128, 513), QWEN235_NEW,
                                        "loader (b) engine")
    nl = cfg.n_layers
    if not (launches.get("flash_prefill", 0) and launches.get(
            "decode_attn2", 0)) or launches["decode_attn2"] % nl:
        raise AssertionError(f"loader (b): flash and decode_attn2 must run "
                             f"at rep 16, launches {launches}")
    print(f"loader (b): flash {launches['flash_prefill']} and decode_attn2 "
          f"{launches['decode_attn2']} launches at rep "
          f"{cfg.n_heads // cfg.n_kv_heads}", flush=True)
    add(launches)
    guard_engine(torch, M, cfg, qparams, dev, done, eng, 2, QWEN235_NEW,
                 "loader (b) engine")
    del qparams, done, eng
    gc.collect()
    torch.cuda.empty_cache()
    print(f"loader: launches {total}", flush=True)
    return total


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # the package must be the checkout's own, beside this script (never an
    # installed copy): the kernels are built from its sources
    here = Path(__file__).resolve().parent
    sys.path.insert(0, str(here))
    try:
        from piquant_tpu_torch.ops.cuda import _build
    except ImportError as e:
        print(f"chip_smoke: the piquant_tpu_torch package is missing ({e})",
              file=sys.stderr)
        return 2
    if not _build.CSRC.is_relative_to(here):
        print(f"chip_smoke: piquant_tpu_torch comes from {_build.CSRC.parent}"
              f", not from the checkout at {here}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    print(card_line(), flush=True)   # name, power limit (nvidia-smi)
    print(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
          f"python {sys.version.split()[0]}", flush=True)
    args.bw = copy_bandwidth(torch, dev)
    print(f"card: copy bandwidth {args.bw / 1e9:.1f} GB/s (data sheet "
          f"{HBM_BYTES_PER_S / 1e9:.0f})", flush=True)

    t_start = time.perf_counter()

    def phase_done(n):
        print(f"phase {n} done at {time.perf_counter() - t_start:.1f} s",
              flush=True)

    build = _build.build()
    print(f"build: {build.path.name} in {build.seconds:.1f} s", flush=True)
    for line in build.log.splitlines():
        if ("registers" in line or line.startswith("==") or "wgmma" in line
                or "spill" in line and " 0 bytes spill stores" not in line):
            print("  " + line.strip(), flush=True)
    _build.library()

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    kernels = [gemv_row(torch, dev, gen, "w4_gemv",
                        "46 (_w4_kernel), piquant_tpu/ops/pallas/qmatmul.py:"
                        "350 (_w4_kernel_ksplit)",
                        "one decode layer: 7 projections at M=8", 4, None,
                        W4_SHAPES, torch.bfloat16),
               check_decode_attn2(torch, dev, gen),
               check_flash(torch, dev, gen)]
    print(f"gemv instances: {gemv_attributes(torch)}", flush=True)
    phase_done(3)
    torch.cuda.empty_cache()
    errs = check_library(torch, dev, gen, LIB_N)
    launches = run_library(torch, dev, gen, LIB_N, args.seed)
    kernels += time_library(torch, dev, gen, LIB_N, errs)
    phase_done(4)
    torch.cuda.empty_cache()
    launches.update(run_engine(torch, dev, args))
    phase_done(5)
    torch.cuda.empty_cache()
    kernels += check_weight_formats(torch, dev, gen)
    phase_done(6)
    torch.cuda.empty_cache()
    with cut_depth("llama3_8b", CLI_DEPTH):
        launches.update(run_cli(torch, dev, args))
    phase_done(7)
    torch.cuda.empty_cache()
    kernels += check_act_quant(torch, dev, gen, next(
        k for k in kernels if k["name"] == "wg_chunk"))
    phase_done(8)
    torch.cuda.empty_cache()
    moe_rows, moe_launches = run_moe(torch, dev, gen, args)
    kernels += moe_rows
    launches.update(moe_launches)
    phase_done(9)
    torch.cuda.empty_cache()
    kernels += check_nf4_kv4(torch, dev, gen)
    with cut_depth("llama3_8b", CLI_DEPTH):
        launches.update(run_cli(torch, dev, args, NF4_KV4_RUNS,
                                ("nf4_gemv", "decode_attn2_kv4")))
    phase_done(10)
    torch.cuda.empty_cache()
    run_families(torch, dev, gen, args, kernels)
    phase_done(11)
    torch.cuda.empty_cache()
    gemma = run_gemma(torch, dev, gen, args, kernels)
    phase_done(12)
    torch.cuda.empty_cache()
    l4 = run_llama4_gpt_oss(torch, dev, gen, args, kernels)
    phase_done(13)
    torch.cuda.empty_cache()
    fused_rows, fused_launches = run_fused(torch, dev, gen, args)
    kernels += fused_rows
    launches.update(fused_launches)
    phase_done(14)
    torch.cuda.empty_cache()
    ring_rows, ring_launches, coll = run_ring(torch, dev, gen)
    kernels += ring_rows
    launches.update(ring_launches)
    phase_done(15)
    run_history(torch, dev, args)
    phase_done(16)
    spec = run_speculative(torch, dev, gen, args, next(
        k for k in kernels if k["name"] == "w4_gemv"))
    for name, n in spec.items():
        launches[name] += n
    phase_done(17)
    check_gqa_reps(torch, dev, gen, kernels)
    loader = run_loader(torch, dev, gen, args)
    for name, n in loader.items():
        launches[name] = launches.get(name, 0) + n
    phase_done(18)
    for kern in kernels:
        kern["launches"] = launches[kern["name"]]
        if kern["name"] in spec:
            kern["speculative_launches"] = spec[kern["name"]]
        if kern["name"] in loader:
            kern["loader_launches"] = loader[kern["name"]]
        if kern["name"] in gemma:
            kern["gemma_launches"] = gemma[kern["name"]]
        if kern["name"] in l4:
            kern["llama4_gpt_oss_launches"] = l4[kern["name"]]
        if kern["name"] in coll:
            kern["collectives_launches"] = coll[kern["name"]]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
