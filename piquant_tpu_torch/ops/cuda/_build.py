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
           "decode_attn2.cu", "flash.cu", "quantize.cu", "dequantize.cu",
           "requantize.cu", "minmax.cu")
HEADERS = ("pq_quant.cuh", "pq_tile.cuh")
BUILD_DIR = _PKG.parent / "build" / "piquant_tpu_torch"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_I64, _U64 = ctypes.c_int64, ctypes.c_uint64
SIGNATURES = {
    # x, w, scale, zp, xsum, out, partial, m, k, n, ksplit, rows, out_bf16,
    # stream
    "pq_w4_gemv": [_P] * 7 + [_I] * 6 + [_P],
    "pq_w8_gemv": [_P] * 7 + [_I] * 6 + [_P],
    "pq_w2_gemv": [_P] * 7 + [_I] * 6 + [_P],
    # x, w, s_chunk, z_chunk, xs, out, partial, m, k, n, gs, ch, planes,
    # ksplit, rows, out_bf16, stream
    "pq_wg_gemv": [_P] * 7 + [_I] * 9 + [_P],
    # x, w, scale, zp, out, partial, m, k, n, gs, ksplit, rows, out_bf16,
    # stream
    "pq_w4g_gemv": [_P] * 6 + [_I] * 7 + [_P],
    # x, w, scale, out, partial, m, k, n, gs, ksplit, rows, out_bf16, stream
    "pq_nf4_gemv": [_P] * 5 + [_I] * 7 + [_P],
    # xq, xs, w, scale, zs, xsum, out, partial, m, k, n, bm, ksplit, rows,
    # out_bf16, stream
    "pq_w4a8": [_P] * 8 + [_I] * 7 + [_P],
    "pq_w8a8": [_P] * 8 + [_I] * 7 + [_P],
    "pq_w2a8": [_P] * 8 + [_I] * 7 + [_P],
    # xq, xs, w, scale, zs, xsum, block_expert, out, m, k, n, planes,
    # out_bf16, stream
    "pq_wq_ragged_a8": [_P] * 8 + [_I] * 5 + [_P],
    # x, w, scale, zs, xsum, block_expert, out, m, k, n, planes, out_bf16,
    # stream
    "pq_wq_ragged": [_P] * 7 + [_I] * 5 + [_P],
    # x, w, scale, zp, block_expert, out, m, k, n, planes, gs, out_bf16,
    # stream
    "pq_wq_ragged_grouped": [_P] * 6 + [_I] * 6 + [_P],
    # q, kc, ks, vc, vs, pos, start, acc, m, l, part_acc, part_ml, layer,
    # nb, nh, rep, s_len, d, sm_scale, stream
    "pq_decode_attn2": [_P] * 12 + [_I] * 6 + [_F, _P],
    "pq_decode_attn2_kv4": [_P] * 12 + [_I] * 6 + [_F, _P],
    # q, k, v, out, pos0, sinks, nb, nh, rep, t, window, chunk, d,
    # sm_scale, softcap, stream
    "pq_flash_prefill": [_P] * 6 + [_I] * 7 + [_F, _F, _P],
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


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count
