"""Per-block timeline of the a8 prefill tiles on the card.

Builds an instrumented copy of piquant_tpu_torch/csrc/qmatmul_a8.cu: the
committed source with timestamps written by each block's thread 0 at four
points of a8_wgmma (entry, the first stage landed, the main loop's end,
the epilogue's end; clock64 for the spans, %globaltimer for the block's
start and end).  Runs the dense entries at Llama-3-8B shapes, checks each
against its plain version, and prints per shape the spread of the
blocks' starts and ends and the spans of the prologue, main loop and
epilogue in microseconds (at the clock the block measured).  The
instrumented library lands in build/a8_timeline/; the kernel the port
runs is not touched.  From the repository root, on a machine with the card
and nvcc:

    python3 tools/a8_timeline.py
"""
import ctypes
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as c  # noqa: E402
from piquant_tpu_torch.ops.cuda import _build  # noqa: E402
from piquant_tpu_torch.ops.cuda import qmatmul as Q  # noqa: E402
from piquant_tpu_torch.quant.linear import _quantize_act  # noqa: E402

BLOCKS = 8192      # timeline rows (blocks of one launch at most)
TIMELINE = f'''
__device__ long long pq_tl[{BLOCKS} * 8];
__device__ __forceinline__ long long gtime() {{
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}}
// thread 0's store, predicated inside the asm: a branch here would make
// ptxas wait on the wgmmas in flight around it
__device__ __forceinline__ void tl_put(int k, long long v) {{
  const int b = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  long long* p = pq_tl + (b % {BLOCKS}) * 8 + k;
  asm volatile("{{\\n.reg .pred q;\\nsetp.eq.u32 q, %2, 0;\\n"
               "@q st.global.s64 [%0], %1;\\n}}\\n"
               :: "l"(p), "l"(v), "r"(threadIdx.x) : "memory");
}}
'''
# (anchor in the source, the line added after it): the slot each point
# writes is 0 / 1 entry clock / time, 2 first stage, 3 loop end, 4 / 5 end
# clock / time
POINTS = (
    ("namespace {\n\nusing namespace pq;\n", TIMELINE),
    ("  extern __shared__ uint8_t smem_raw[];\n",
     "  tl_put(0, clock64());\n  tl_put(1, gtime());\n"),
    ("  mbar_wait(&full[0], 0);\n", "  tl_put(2, clock64());\n"),
    ("  wgmma_wait<0>();                          // (provably) nothing "
     "in flight\n", "  tl_put(3, clock64());\n"),
)
# the kernel's closing brace: the last line before the host side
END = ("}\n\n// ---------------------------------------------------------------"
       "------------\n// host side")


def instrumented() -> ctypes.CDLL:
    src = (_build.CSRC / "qmatmul_a8.cu").read_text()
    for anchor, add in POINTS:
        assert src.count(anchor) == 1, anchor
        src = src.replace(anchor, anchor + add)
    assert src.count(END) == 1
    src = src.replace(END, "  __syncthreads();\n  tl_put(4, clock64());\n"
                      "  tl_put(5, gtime());\n" + END)
    src += f'''
extern "C" int pq_tl_read(void* dst) {{
  return (int)cudaMemcpyFromSymbol(dst, pq_tl, sizeof(long long) * {BLOCKS} * 8);
}}
'''
    out = _build.BUILD_DIR.parent / "a8_timeline"
    out.mkdir(parents=True, exist_ok=True)
    (out / "a8_tl.cu").write_text(src)
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
                        str(_build.CSRC), "-o", str(out / "libtl.so"),
                        str(out / "a8_tl.cu")], capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed:\n{r.stdout}\n{r.stderr}")
    lib = ctypes.CDLL(str(out / "libtl.so"))
    for name in ("pq_w4a8", "pq_w8a8", "pq_w2a8"):
        getattr(lib, name).argtypes = _build.SIGNATURES[name]
    lib.pq_tl_read.argtypes = [ctypes.c_void_p]
    return lib


def spread(a) -> str:
    return (f"min {np.min(a):.2f} med {np.median(a):.2f} "
            f"max {np.max(a):.2f}")


def run(lib, dev, gen, m, k, n, planes, bm):
    """One shape through the instrumented entry (no K split); prints the
    timeline of its last of five launches."""
    bits = {1: 8, 2: 4, 4: 2}[planes]
    name = {1: "w8a8", 2: "w4a8", 4: "w2a8"}[planes]
    ql = c.random_qlin(torch, dev, gen, k, n, bits, None)
    xq, xs = _quantize_act(torch.randn((m, k), generator=gen,
                                       device=dev).to(torch.bfloat16))
    ops = (xq, xs, ql.data, *Q.a8_operands(xq, ql, 128 if bits == 8 else 0))
    out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    for _ in range(5):
        _build.check(getattr(lib, "pq_" + name)(
            *(t.data_ptr() for t in ops), out.data_ptr(), out.data_ptr(), m,
            k, n, bm, 1, k // planes, 1,
            torch.cuda.current_stream().cuda_stream), name)
    torch.cuda.synchronize()
    if not torch.equal(out, getattr(Q, name + "_plain")(*ops,
                                                        torch.bfloat16)):
        raise AssertionError(f"{name} M={m} K={k} N={n}: not bit for bit")
    buf = np.zeros(BLOCKS * 8, dtype=np.int64)
    _build.check(lib.pq_tl_read(buf.ctypes.data), "pq_tl_read")
    tiles = -(-m // bm) * -(-n // (32768 // bm))
    t = buf.reshape(BLOCKS, 8)[:tiles]
    t0 = t[:, 1].min()
    ghz = (t[:, 4] - t[:, 0]) / np.maximum(t[:, 5] - t[:, 1], 1)
    us = [(t[:, b] - t[:, a]) / ghz / 1e3 for a, b in ((0, 2), (2, 3), (3, 4))]
    print(f"P={planes} bm={bm} M={m} K={k} N={n}, {tiles} tiles: span "
          f"{(t[:, 5].max() - t0) / 1e3:.2f} us; starts "
          f"{spread((t[:, 1] - t0) / 1e3)}; ends {spread((t[:, 5] - t0) / 1e3)};"
          f" clock {np.median(ghz):.3f} GHz; us: prologue {spread(us[0])}; "
          f"loop {spread(us[1])}; epilogue {spread(us[2])} "
          f"[{c.card_line()}]", flush=True)


def main() -> None:
    lib = instrumented()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for planes, bm in ((2, 256), (1, 256), (4, 256), (4, 128), (2, 128)):
        for k in (512, 4096, 16384):
            run(lib, dev, gen, 1024, k, 4096, planes, bm)
    run(lib, dev, gen, 1024, 4096, 14336, 2, 256)
    run(lib, dev, gen, 128, 4096, 4096, 2, 128)


if __name__ == "__main__":
    main()
