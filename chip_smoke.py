#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (piquant_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # needs one CUDA card

Phases (any failure exits non-zero):
  1. card: name and power limit from nvidia-smi;
  2. build: the hand-written kernels from piquant_tpu_torch/csrc with nvcc;
  3. kernels: each serving kernel's wrapper against its plain PyTorch
     version at the Llama-3-8B main-path shapes (decode batch 8), with its
     time, its bound and a one-call PyTorch yardstick;
  4. library core: the quantize / dequantize / requantize / min-max kernels
     bit for bit against their plain versions over f32/bf16 x {u8, i8, u16,
     i16, uint4, int4, uint2} at numel 27,264,000 (bench.py's protocol) and
     a ragged tail, with the edge values (ties, NaN, +-inf, 3e9); then the
     public API end to end at that size with launch counts; then each
     kernel's time, bound, plain time and PyTorch yardstick;
  5. engine: the port's Engine serving 16 requests on Llama-3-8B at full
     width (random INT4 codes from a seed), launch counts of every kernel,
     engine tokens against the port's own single-request generation, and
     decode / prefill throughput and TTFT;
  6. weight-format kernels: the INT8, INT2 and grouped GEMVs against their
     plain versions at the Llama-3-8B shapes (the INT8 lm_head; INT2 and
     INT4-g128 projections; the INT2-g32 MLP; the INT4-g256 w2) at M = 8,
     1 and 33, with their times, bounds and a torch.matmul yardstick;
  7. CLI: `python -m piquant_tpu_torch.serving --random llama3_8b
     --benchmark 8 --max-new 32` in process (at 4 of its 32 layers since
     phase 11 came, full width), in four weight formats
     (INT4-g128; INT4 attention with an INT2-g32 MLP; INT4-g256; INT2) and
     four activation-quantized runs (--act-quant-prefill at INT4 and INT8;
     --act-quant-decode at INT2 and with the INT2-g32 MLP), each with the
     reference CLI's INT8 lm_head: exact launch counts, greedy tokens
     against single-request generation, and its metrics;
  8. int8 activations: the w4a8, w8a8 and w2a8 kernels bit for bit
     against their plain versions at the Llama-3-8B projections (M = 1024,
     8, 1, 33, 1000), and the chunk kernel's int8-x form (INT2-g32 MLP,
     INT4-g128) at M = 8, 1, 33, with times, bounds and yardsticks;
  9. Mixtral-8x7B MoE: (a) the ragged expert GEMMs (wq_ragged,
     wq_ragged_grouped, wq_ragged_a8) against their plain versions at the
     Mixtral expert shapes, routed from a random router over 1024 tokens
     (one expert without a token, one with nearly all), in INT4 / INT2 /
     INT8, INT4-g128 / INT2-g32 and int8-x INT4 / INT2, with times, bounds
     and a torch._grouped_mm yardstick; (b) one full-width MoE layer's
     ragged route against its dense-masked route at 256 tokens; (c) `python
     -m piquant_tpu_torch.serving --random mixtral_8x7b --benchmark 8
     --max-new 32` in process at 4 of its 32 layers, full width (INT4,
     --group-size 128, --act-quant-prefill)
     with exact launch counts, greedy tokens against single-request
     generation, its metrics and peak memory;
 10. NF4 weights and the kv4 cache: (a) nf4_gemv against its plain version
     at the seven Llama-3-8B projections, channelwise and grouped g64 /
     g128, at M = 8, 1 and 33 with bf16 and f32 outputs, with times, bounds
     and a torch.matmul yardstick; (b) the kv4 form of decode_attn2 against
     its plain version on a stacked kv4 cache of Llama-3-8B's geometry
     (ragged positions, a row with no live position, odd positions and
     starts), with an SDPA yardstick; (c) the CLI at full Llama-3-8B width
     with `--bits nf4` and with `--kv-bits 4`, exact launch counts (224
     nf4_gemv or 32 kv4 decode_attn2 launches a decode step), greedy tokens
     against single-request generation and its metrics;
 11. model families: (a) the flash kernel's sliding window (Mistral-7B's
     T 6144 and window 4096; a window of 1000 off the 64-key tiles) and GQA
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
HOLD_M = (8, 1, 33)           # decode batch 8, a lone row, a ragged M <= 64


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
    if name in ("w4_gemv", "w8_gemv", "w2_gemv"):
        return ((ql.data, ql.scale.reshape(-1), ql.zero_point.reshape(-1),
                 x.float().sum(1, keepdim=True)), n * 8)
    g = ql.k // gs
    if name == "wg_chunk":
        ch = grouped_chunk_factor(ql.k, gs, Q.PLANES[ql.bits])
        return (ql.data, ql.s_chunk, ql.z_chunk, gs, ch), g * n * 3
    return (ql.data, ql.scale, ql.zero_point, gs), g * n * 8


def check_gemv(torch, dev, gen, name, bits, gs, shapes, out_dtype,
               a8=False, hold_f32=False):
    """Wrapper `name` against its plain version at each (K, N) of `shapes`
    and M in HOLD_M (with hold_f32 at f32 output as well); then its device ms at M = 8 summed over the shapes'
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
        for m in HOLD_M:
            x, extra, _ = inputs(m, k)
            ops, _ = gemv_operands(name, qls[0], x)
            # atol 2e-2, rtol 1e-2: the quantized_matmul bound of the JAX
            # tests (f32 sums in another order, one bf16 output rounding)
            for odt in hold_dtypes:
                e = hold(torch, f"{name} K={k} N={n} M={m} {odt}",
                         kern(x, *ops, odt, *extra).float(),
                         plain(x, *ops, odt, *extra).float(), 2e-2, 1e-2)
                err = max(err, e)
        print(f"{name} K={k} N={n}: max_abs_err {err:.3e} at M {HOLD_M}",
              flush=True)
        x, extra, xb = inputs(8, k)
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
        xbytes = 8 * k + 8 * 4 if a8 else 8 * k * 2
        tot["nbytes"] += uses * (k * n * wbits / 8 + side + xbytes
                                 + 8 * n * obytes)
        tot["flops"] += uses * 2 * 8 * k * n
        del qls, ops, w_bf16
    b, by = bound_ms(tot["nbytes"], tot["flops"])
    return dict(max_abs_err=err, ms=tot["ms"], plain_ms=tot["plain_ms"],
                bound_ms=b, bound_by=by, library_ms=tot["library_ms"],
                library_call="torch.matmul (bf16 dequantized W)",
                eager_ms=tot["eager_ms"])


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
    print(f"decode_attn2: kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
          f"sdpa(bf16 cache) {t_l:.4f} ms, live positions {live_pos:.0f}",
          flush=True)
    del kc, vc, ks, vs, kf, vf
    return dict(name="decode_attn2", route="cuda",
                source="piquant_tpu_torch/csrc/decode_attn2.cu",
                replaces="piquant_tpu/ops/pallas/decode_attn2.py:76 (_kernel, "
                         "kv8)",
                max_abs_err=err, ms=t_k, plain_ms=t_p, bound_ms=bnd,
                bound_by=by, library_ms=t_l, eager_ms=t_e,
                timed="one layer: B=8, Hkv=8, rep=4, S=2048, mixed positions")


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
    print(f"flash_prefill: kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
          f"sdpa(causal, gqa) {t_l:.4f} ms", flush=True)
    return dict(name="flash_prefill", route="cuda",
                source="piquant_tpu_torch/csrc/flash.cu",
                replaces="piquant_tpu/ops/pallas/flash.py:57 (_kernel; also "
                         "the JAX-shipped causal kernel called at "
                         "piquant_tpu/ops/flash_prefill.py:77)",
                max_abs_err=err, ms=t_k, plain_ms=t_p, bound_ms=bnd,
                bound_by=by, library_ms=t_l, eager_ms=t_e,
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
    from piquant_tpu_torch.ops.cuda import decode_attn2 as DA
    from piquant_tpu_torch.ops.cuda import dequantize as DQ
    from piquant_tpu_torch.ops.cuda import flash as FL
    from piquant_tpu_torch.ops.cuda import minmax as MM
    from piquant_tpu_torch.ops.cuda import qmatmul as Q
    from piquant_tpu_torch.ops.cuda import quantize as QK
    from piquant_tpu_torch.ops.cuda import ragged as R
    from piquant_tpu_torch.ops.cuda import requantize as RQ

    return {"w4_gemv": Q.w4_gemv, "decode_attn2": DA.decode_attn2,
            "flash_prefill": FL.flash_attn, "quantize": QK.quantize,
            "dequantize": DQ.dequantize, "requantize": RQ.requantize,
            "min_max": MM.min_max, "w8_gemv": Q.w8_gemv,
            "w2_gemv": Q.w2_gemv, "wg_chunk": Q.wg_chunk,
            "w4_grouped": Q.w4_grouped, "w4a8": Q.w4a8, "w8a8": Q.w8a8,
            "w2a8": Q.w2a8, "wq_ragged": R.wq_ragged,
            "wq_ragged_grouped": R.wq_ragged_grouped,
            "wq_ragged_a8": R.wq_ragged_a8, "nf4_gemv": Q.nf4_gemv,
            "decode_attn2_kv4": DA.decode_attn2_kv4}


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


def time_library(torch, dev, gen, n, errs):
    """Device ms of each library kernel at numel n (f32 input, uint8 codes),
    its plain version, its host cost per eager call, and one PyTorch call
    computing the same function as a yardstick (never used by the port)."""
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
        t_e = host_ms(call)
        t_p = cuda_ms(plain, 5)
        t_l = event_ms(lib, 50)
        b, by = bound_ms(nbytes, ops * n, F32_FLOP_PER_S)
        print(f"{name}: kernel {t_k:.4f} ms, bound {b:.4f} ms ({by}), plain "
              f"{t_p:.4f} ms, {lib_name} {t_l:.4f} ms, eager {t_e:.4f} ms "
              f"[{timed}; {card}]", flush=True)
        rows.append(dict(name=name, route="cuda",
                         source=f"piquant_tpu_torch/csrc/{source}",
                         replaces=replaces, max_abs_err=errs[name], ms=t_k,
                         plain_ms=t_p, bound_ms=b, bound_by=by,
                         library_ms=t_l, library_call=lib_name, eager_ms=t_e,
                         timed=timed))
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
        """Another path of the last row's kernel: its ms, plain ms, bound."""
        t_k = cuda_ms(call, 50)
        t_p = cuda_ms(plain, 5)
        b, _ = bound_ms(nbytes, 0)
        print(f"{rows[-1]['name']} {tag}: kernel {t_k:.4f} ms, bound {b:.4f} "
              f"ms, plain {t_p:.4f} ms [{card}]", flush=True)
        rows[-1].setdefault("variants", {})[tag] = dict(
            ms=t_k, plain_ms=t_p, bound_ms=b)

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

def generate_single(torch, M, cfg, params, prompt, n_new, dev, width=None,
                    max_len=None):
    """The port's own single-request greedy prefill + decode; with `width`
    the prompt is right-padded to it and prefilled into a cache of
    `max_len` positions, as the engine runs a request admitted alone.
    Returns the tokens and, for each, the top-2 margin of the logits that
    chose it."""
    toks = list(prompt) + [0] * ((width or len(prompt)) - len(prompt))
    max_len = max_len or len(prompt) + n_new
    if cfg.kv_bits == 4:
        max_len += max_len % 2     # whole pair rows
    cache = M.init_kv_cache(cfg, 1, max_len=max_len, device=dev)
    logits, cache = M.prefill(
        cfg, params, torch.tensor([toks], device=dev, dtype=torch.int32),
        cache, last_positions=torch.tensor([len(prompt) - 1], device=dev,
                                           dtype=torch.int32))
    toks, margins = [], []
    pos = len(prompt)
    while True:
        top = logits[0].float().topk(2)
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
                log.append((f"xsum into {n}", entered[0], a[4][0].float()))
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
    print(f"profile: a decode step takes {plain_ms:.2f} ms unprofiled; "
          f"{steps} decode steps, wall {wall_ms:.2f} ms, kernels "
          f"{busy:.2f} ms (device busy {100 * busy / wall_ms:.1f}%), "
          f"{sum(r[2] for r in rows)} kernel launches", flush=True)
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
                      library_call=t["library_call"], eager_ms=t["eager_ms"])
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
    return dict(name=name, route="cuda",
                source="piquant_tpu_torch/csrc/qmatmul_a8.cu",
                replaces=f"piquant_tpu/ops/pallas/qmatmul.py:{replaces}",
                timed=f"{what} at M={prefill}", **res[prefill],
                variants={f"{what} at M={decode}": res[decode]})


def check_act_quant(torch, dev, gen, wg_row):
    """Phase 8: one kernels-line row per a8 wrapper at the shapes the
    act-quant CLI runs give it; the chunk kernel's int8-x form joins the
    wg_chunk row (`wg_row`) as variants."""
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
                     "w8a8", "w2a8")):
    """Phase 7 (and 10 (c)): each configuration of `runs` through the CLI's
    own build and benchmark, with its launches, tokens and metrics checked.
    Returns the launches of the `counted` wrappers summed over the runs."""
    import numpy as np

    from piquant_tpu_torch.models import llama as M
    from piquant_tpu_torch.serving import __main__ as S

    total = dict.fromkeys(counted, 0)
    for flags, per_layer in runs:
        argv = ["--random", "llama3_8b", "--benchmark", "8", "--max-new",
                "32", *flags]
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
        expect["w8_gemv"] += steps + counts["prefills"]
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
            if len(r.tokens) != cli_args.max_new or not all(
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
        want, margins = generate_single(torch, M, cfg, params, r.prompt,
                                        cli_args.max_new, dev)
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
# Mixtral-8x7B's 32 layers) and, since phase 13 came, of phase 11's four
# dense family presets (widths unchanged): the later phases need the
# time, and phase 5 and the long requests serve the full depth.
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
    bf16 output)."""
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
                got = R.wq_ragged_matmul_a8(xq, xsc, st, be, odt)
                e = same(torch, f"{name} K={k} N={n} {odt}", got,
                         plain(*ops, odt))
            else:
                got = R.wq_ragged_matmul(xs, st, be, odt)
                # atol 2e-2, rtol 1e-2: bf16 operands in both, f32 sums in
                # another order, one bf16 output rounding
                e = hold(torch, f"{name} K={k} N={n} {odt}", got.float(),
                         plain(*ops, odt).float(), 2e-2, 1e-2)
            err = max(err, e)
            pad = torch.ones(xs.shape[0], dtype=torch.bool, device=dev)
            pad[r.dest] = False
            if got[pad].any():
                raise AssertionError(f"{name}: a padding row is not zero")
        t_k = cuda_ms(lambda i: kern(*ops, torch.bfloat16), 10)
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
        del st, xs, ops, w
    b, by = bound_ms(tot["nbytes"], tot["ops"],
                     INT8_OP_PER_S if a8 else BF16_FLOP_PER_S)
    return dict(max_abs_err=err, ms=tot["ms"], plain_ms=tot["plain_ms"],
                bound_ms=b, bound_by=by, library_ms=tot["library_ms"],
                library_call="torch._grouped_mm (bf16 dequantized stack)")


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
                  f"{x['library_ms']:.4f} ms [one Mixtral MoE layer, "
                  f"{MOE_T} tokens; {card}]", flush=True)
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
    print(f"decode_attn2_kv4: kernel {t_k:.4f} ms, bound {bnd:.4f} ms "
          f"({by}), plain {t_p:.4f} ms, sdpa(bf16 cache) {t_l:.4f} ms, "
          f"eager {t_e:.4f} ms, live positions {live_pos:.0f} "
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
    print(f"{tag}: max_abs_err {err:.3e}; kernel {t_k:.4f} ms, bound "
          f"{bnd:.4f} ms ({by}), plain {t_p:.4f} ms, sdpa {lib} "
          f"[{card_line()}]", flush=True)
    del q, k, v
    torch.cuda.empty_cache()
    return dict(max_abs_err=err, ms=t_k, plain_ms=t_p, bound_ms=bnd,
                bound_by=by, library_ms=t_l, library_call=call)


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
          f"{t_k:.4f} ms, bound {bnd:.4f} ms ({by}), plain {t_p:.4f} ms, "
          f"sdpa(bf16 cache slice) {t_l:.4f} ms, live positions {live:.0f} "
          f"[{card_line()}]", flush=True)
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
    add("flash_prefill", "a window off the 64-key tiles: B=2, Hkv=8, rep=4, "
        "T=2048, window 1000", hold_flash(torch, dev, gen, 2, 8, 4, 2048,
                                          1000))
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
          f"{res['library_ms']:.4f} ms [one MoE layer, {MOE_T} tokens; "
          f"{card_line()}]", flush=True)
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
# A3B_DEPTH of its 48 layers at full width: a full-depth decode step takes
# seconds of host launches, 32 steps of them the run's time limit; one
# full-depth step is profiled on its own.
A3B_RUN = (("--random", "qwen3_moe_a3b", "--benchmark", "4", "--max-new",
            "8"),
           {"decode": {"w4_gemv": 4 + 3 * 128},
            "small": {"w4_gemv": 4, "wq_ragged": 3}, "mid": {"wq_ragged": 3},
            "big": {"wq_ragged": 3}})
A3B_DEPTH = 8
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
# GPT-OSS's CLI run serves 8 of its 24 layers (its alternation kept, full
# width): every product of it runs off the kernels, about 59k launches a
# decode step, and the run's time limit needs the time
GPT_OSS_DEPTH = 8
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
        if ("registers" in line or line.startswith("==")
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
    for kern in kernels:
        kern["launches"] = launches[kern["name"]]
        if kern["name"] in gemma:
            kern["gemma_launches"] = gemma[kern["name"]]
        if kern["name"] in l4:
            kern["llama4_gpt_oss_launches"] = l4[kern["name"]]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
