"""Build the hand-written Hopper kernels with nvcc and load them.

The sources in piquant_tpu_torch/csrc/ are compiled for sm_90a, one nvcc
process per source started together, linked into one shared library with a
plain C interface, and loaded with ctypes.  The library lands in
build/piquant_tpu_torch/ under the repository root, named by a hash of the
sources and flags, so a changed source never loads a stale build.  Nothing
here runs at import: the first kernel launch builds.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
SOURCES = ("qmatmul_gemv.cu", "qmatmul_a8.cu", "qmatmul_ragged.cu",
           "qmatmul_mlp.cu", "decode_attn2.cu", "decode_wide.cu", "flash.cu",
           "flash_bwd.cu", "flash_wide.cu", "quantize.cu", "dequantize.cu",
           "requantize.cu", "minmax.cu", "ring.cu")
HEADERS = ("pq_quant.cuh", "pq_tile.cuh", "pq_hopper.cuh", "pq_gemv.cuh",
           "pq_mma.cuh", "pq_decode.cuh")
BUILD_DIR = _PKG.parent / "build" / "piquant_tpu_torch"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_I64, _U64 = ctypes.c_int64, ctypes.c_uint64
SIGNATURES = {
    # x, w, scale, zp, xsum (or null), out, m, k, n, ksplit, rows, out_bf16,
    # stream
    "pq_w4_gemv": [_P] * 6 + [_I] * 6 + [_P],
    "pq_w8_gemv": [_P] * 6 + [_I] * 6 + [_P],
    "pq_w2_gemv": [_P] * 6 + [_I] * 6 + [_P],
    # x, w, s_chunk, z_chunk, xs, out, m, k, n, gs, ch, planes, ksplit, rows,
    # out_bf16, stream
    "pq_wg_gemv": [_P] * 6 + [_I] * 9 + [_P],
    # x, w, scale, zp, out, m, k, n, gs, ksplit, rows, out_bf16, stream
    "pq_w4g_gemv": [_P] * 5 + [_I] * 7 + [_P],
    # x, w, scale, out, m, k, n, gs, ksplit, rows, out_bf16, stream
    "pq_nf4_gemv": [_P] * 4 + [_I] * 7 + [_P],
    # form, n8 tiles, gs, ksplit, out[5]
    "pq_gemv_attributes": [_I, _I, _I, _I, _P],
    # xq, xs, w, scale, zs, xsum, out, partial, m, k, n, bm, ksplit, rows,
    # out_bf16, stream
    "pq_w4a8": [_P] * 8 + [_I] * 7 + [_P],
    "pq_w8a8": [_P] * 8 + [_I] * 7 + [_P],
    "pq_w2a8": [_P] * 8 + [_I] * 7 + [_P],
    # xq, xs, w, scale, zs, xsum, block_expert, live_blocks, out, m, k, n,
    # n_experts, planes, out_bf16, stream
    "pq_wq_ragged_a8": [_P] * 9 + [_I] * 6 + [_P],
    # planes, bm, out[4]
    "pq_a8_attributes": [_I, _I, _P],
    # x, w, scale, zs, xsum, block_expert, live_blocks, out, m, k, n,
    # n_experts, planes, out_bf16, stream
    "pq_wq_ragged": [_P] * 8 + [_I] * 6 + [_P],
    # x, w, scale, zp, block_expert, live_blocks, out, m, k, n, n_experts,
    # planes, gs, out_bf16, stream
    "pq_wq_ragged_grouped": [_P] * 7 + [_I] * 7 + [_P],
    # planes, mode, out[4]
    "pq_ragged_attributes": [_I, _I, _P],
    # x, w13, s13, zp13, w2, s2, zp2, xsum (or null), out, h, part_b,
    # state, m, k, i_ff, n, ksb, rows_b, blocks, gelu, out_bf16, stream
    "pq_mlp_fused": [_P] * 12 + [_I] * 9 + [_P],
    # n8 tiles, out[6]
    "pq_mlp_attributes": [_I, _P],
    # k, i_ff, n, ksb, rows_b, out[5 * items + ksb]
    "pq_mlp_queue": [_I] * 5 + [_P],
    # q, kc, ks, vc, vs, pos, ctx, part_acc, part_ml, tickets, nb, nh, rep,
    # s_len, d, tps, sm_scale, stream
    "pq_decode_attn": [_P] * 10 + [_I] * 6 + [_F, _P],
    "pq_decode_attn_wide": [_P] * 10 + [_I] * 6 + [_F, _P],
    # q, kc, ks, vc, vs, pos, start, acc, m, l, part_acc, part_ml, tickets,
    # layer, nb, nh, rep, s_len, d, tps, sm_scale, stream
    "pq_decode_attn2": [_P] * 13 + [_I] * 7 + [_F, _P],
    "pq_decode_attn2_kv4": [_P] * 13 + [_I] * 7 + [_F, _P],
    "pq_decode_attn2_wide": [_P] * 13 + [_I] * 7 + [_F, _P],
    "pq_decode_attn2_kv4_wide": [_P] * 13 + [_I] * 7 + [_F, _P],
    # d, form (0 kv8, 1 kv4, 2 V1), out[4]
    "pq_decode_attn2_attributes": [_I, _I, _P],
    "pq_decode_wide_attributes": [_I, _I, _P],
    # q, k, v, out, lse (or null), pos0, sinks, nb, nh, rep, t, window,
    # chunk, d, sm_scale, softcap, stream
    "pq_flash_prefill": [_P] * 7 + [_I] * 7 + [_F, _F, _P],
    # q, k, v, out, pos0, sinks, nb, nh, rep, t, window, chunk, d,
    # sm_scale, softcap, stream
    "pq_flash_prefill_wide": [_P] * 6 + [_I] * 7 + [_F, _F, _P],
    # o, dout, delta, dob, rows, stream
    "pq_flash_bwd_delta": [_P] * 4 + [_I64, _P],
    # q, k, v, dob, lse, delta, dk, dv, pos0, nb, nh, rep, t, window, chunk,
    # d, sm_scale, stream
    "pq_flash_bwd_dkv": [_P] * 9 + [_I] * 7 + [_F, _P],
    # q, k, v, dob, lse, delta, dq, pos0, nb, nh, rep, t, window, chunk, d,
    # sm_scale, stream
    "pq_flash_bwd_dq": [_P] * 8 + [_I] * 7 + [_F, _P],
    # which (0 delta, 1 dkv, 2 dq), out[3]
    "pq_flash_bwd_attributes": [_I, _P],
    # d, mode, softcap, sinks, out[4]
    "pq_flash_attributes": [_I] * 4 + [_P],
    # d, out[4]
    "pq_flash_wide_attributes": [_I, _P],
    # x, out, n, in_bf16, bits, is_signed, scale_ptr, scale_val, zp_ptr,
    # zp_val, stochastic, seed, stream
    "pq_quantize": [_P, _P, _I64, _I, _I, _I, _P, _F, _P, _I, _I, _U64, _P],
    # q, out, n, bits, is_signed, out_bf16, scale_ptr, scale_val, zp_ptr,
    # zp_val, add, stream
    "pq_dequantize": [_P, _P, _I64, _I, _I, _I, _P, _F, _P, _I, _I, _P],
    # x, out, n, is_bf16, bits, is_signed, scale_ptr, scale_val, zp_ptr,
    # zp_val, stochastic, seed, add, stream
    "pq_requantize": [_P, _P, _I64, _I, _I, _I, _P, _F, _P, _I, _I, _U64,
                      _I, _P],
    # x, part, out, n, in_bf16, blocks, stream
    "pq_minmax": [_P, _P, _P, _I64, _I, _I, _P],
    # x, recv, send, x_off, x_stride, w_off, w_stride, csize, valid, nb, p,
    # rows, hop, my0, shift, vec, vals, cluster, stream
    "pq_ring_hop": [_P] * 3 + [_I64] * 6 + [_I] * 9 + [_P],
    # wire, out, x_off, x_stride, w_off, w_stride, csize, valid, nb, p, nrep,
    # loopback, vec, stream
    "pq_ring_gather": [_P] * 2 + [_I64] * 6 + [_I] * 5 + [_P],
    # kind, vals, cluster, out[4]
    "pq_ring_attributes": [_I] * 3 + [_P],
}


@dataclasses.dataclass(frozen=True)
class Build:
    path: Path
    seconds: float      # 0.0 when an existing build was reused
    log: str            # nvcc's output (register / shared-memory report)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def build() -> Build:
    """Compile the sources (if this exact build is not on disk yet)."""
    srcs = [CSRC / s for s in SOURCES]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs + [CSRC / s for s in HEADERS]:
        h.update(p.read_bytes())
    lib = BUILD_DIR / f"libpiquant_kernels_{h.hexdigest()[:16]}.so"
    if lib.exists():
        return Build(lib, 0.0, "")
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    objs = [BUILD_DIR / f"{p.stem}_{os.getpid()}.o" for p in srcs]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for src, obj in zip(srcs, objs)]
    logs, failed = [], []
    for src, p in zip(srcs, procs):
        out, _ = p.communicate()
        logs.append(f"== {src.name}\n{out}")
        if p.returncode:
            failed.append(src.name)
    log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if link.returncode:
        raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
    os.replace(tmp, lib)
    for o in objs:
        o.unlink(missing_ok=True)
    return Build(lib, time.perf_counter() - t0, log)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    lib = ctypes.CDLL(str(build().path))
    for name, args in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


# head dims of the attention kernels: flash.cu's and decode_attn2.cu's
# instances, and flash_wide.cu's and decode_wide.cu's runtime range
NARROW_D = (128, 256)
WIDE_D = tuple(range(384, 1025, 128))


def attention_entry(name: str, d: int) -> str:
    """The C entry point of attention kernel `name` ("pq_flash_prefill",
    "pq_decode_attn2", "pq_decode_attn2_kv4", "pq_decode_attn") at head dim
    d: `name` at 128 and 256, its `_wide` form at the multiples of 128 from
    384 to 1024; raises for any other head dim (wider heads: ROADMAP.md
    queue 2 item 3)."""
    if d in NARROW_D:
        return name
    if d in WIDE_D:
        return name + "_wide"
    raise NotImplementedError(
        f"{name[3:]}: head_dim {d} (the kernels take 128, 256 and the "
        "multiples of 128 from 384 to 1024; wider heads: ROADMAP.md queue 2 "
        "item 3)")


# why a kernel without a backward refuses an input that requires grad, by
# the ROADMAP.md queue item that gives it one
NO_BACKWARD = {
    "13": "gradients through quantized weights and activations come with "
          "QAT / LoRA (ROADMAP.md queue 1 item 13)",
    "16c": "gradients through the MoE expert GEMMs and the collectives come "
           "with expert and tensor parallelism (ROADMAP.md queue 1 item 16c)",
    "serving": "decode attention serves only: training attends through "
               "prefill's flash attention, or run decoding under "
               "torch.no_grad()",
    "bwd": "the flash backward's kernels have no backward of their own (no "
           "higher-order gradients, as the JAX-shipped kernel's VJP has "
           "none)",
}


def no_grad(name: str, item: str, *tensors) -> None:
    """Raise NotImplementedError where kernel `name`, which has no backward,
    is launched while grad mode is on and one of `tensors` requires grad:
    its result would leave autograd's graph without a word (every wrapper
    writes through raw pointers into a fresh tensor)."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name}: an input requires grad and the kernel has no backward, "
            f"so its result would not carry the gradient; "
            f"{NO_BACKWARD[item]}")


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_TICKETS_MIN = 4096  # int32 counts a device's buffer holds at first
_tickets_by_device = {}


def tickets(device: torch.device, n: int) -> torch.Tensor:
    """The device's int32 counts, zero between launches, that the kernels
    with an in-launch merge or work queue share (the decode kernels' tickets
    and the fused MLP's queue and counts): a kernel may use the first `n`
    and must leave them zero when it ends.  Calls on one device run in
    stream order.  Grown outside a CUDA-graph capture only."""
    buf = _tickets_by_device.get(device)
    if buf is None or buf.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("call the kernel once outside the CUDA-graph "
                               "capture first (its ticket buffer must hold "
                               f"{n})")
        buf = torch.zeros(max(n, _TICKETS_MIN), dtype=torch.int32,
                          device=device)
        _tickets_by_device[device] = buf
    return buf
