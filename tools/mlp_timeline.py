"""Per-block timeline of the fused MLP (csrc/qmatmul_mlp.cu) on the card.

Builds an instrumented copy of piquant_tpu_torch/csrc/qmatmul_mlp.cu: the
committed source with %globaltimer stamps written by each block's thread 0
at its start and end, at each work item's first landed stage, around each
item's epilogue, and around each wait of a B stage for stage A's h.  Runs
Llama-3-8B's and Gemma-7B's MLPs (random codes, bf16 out, no row sums
passed) with the plan the port picks (`mlp_plan`, or a split given on the
command line), checks each against its plain version, and prints for the
last of five launches: the span, the spread of the blocks' ends, the
clock, and per stage (A, B) the items' stream time (first stage landed to
epilogue start), epilogue time and the gap before them (waiting for the
first stage), and the blocks' time waiting for h.  The instrumented
library lands in build/mlp_timeline/; the kernel the port runs is not
touched.  From the repository root, on a machine with the card and nvcc:

    python3 tools/mlp_timeline.py [KSB ...]

(each KSB runs again with stage B in that many splits, as even as whole
ring stages allow).
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

BLOCKS = 1024      # timeline rows (blocks of one launch at most)
ITEMS = 24         # items a block's row holds
ROW = 8 + 4 * ITEMS
TIMELINE = f'''
__device__ long long pq_tl[{BLOCKS} * {ROW}];
__device__ __forceinline__ long long gtime() {{
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}}
__device__ __forceinline__ void tl_put(int k, long long v) {{
  if (threadIdx.x == 0) pq_tl[(blockIdx.x % {BLOCKS}) * {ROW} + k] = v;
}}
'''
# (anchor in the source, code added before it, code added after it); a row
# is [start, end, h wait ns, items, clock at start, clock at end, -, -,
# then per item: id, first stage landed, epilogue start, epilogue end]
POINTS = (
    ("using namespace pq::gemv;   // the tile geometry and loop helpers\n",
     "", TIMELINE),
    ("  extern __shared__ uint8_t smem_raw[];\n", "",
     "  const long long tl_t0 = gtime(), tl_c0 = clock64();\n"
     "  long long tl_wait = 0;\n  int tl_n = 0;\n"),
    ("      wait_count(ready + q0, qu.feeds(q0));\n",
     "      const long long tl_w0 = gtime();\n",
     "      tl_wait += gtime() - tl_w0;\n"),
    ("    const int kk = tag_k[slot];\n", "",
     f"    if (kk == 0 && tl_n < {ITEMS}) {{\n"
     "      tl_put(8 + 4 * tl_n, id);\n      tl_put(9 + 4 * tl_n, gtime());\n"
     "    }\n"),
    ("      epilogue(id, n_items & 1);\n",
     f"      if (tl_n < {ITEMS}) tl_put(10 + 4 * tl_n, gtime());\n",
     f"      if (tl_n < {ITEMS}) tl_put(11 + 4 * tl_n, gtime());\n"
     "      ++tl_n;\n"),
    ("  // the last block out leaves the state zero for the next launch\n",
     "  tl_put(0, tl_t0);\n  tl_put(1, gtime());\n  tl_put(2, tl_wait);\n"
     "  tl_put(3, tl_n);\n  tl_put(4, tl_c0);\n  tl_put(5, clock64());\n", ""),
)


def instrumented() -> ctypes.CDLL:
    src = (_build.CSRC / "qmatmul_mlp.cu").read_text()
    for anchor, before, after in POINTS:
        assert src.count(anchor) == 1, anchor
        src = src.replace(anchor, before + anchor + after)
    src += f'''
extern "C" int pq_tl_read(void* dst) {{
  return (int)cudaMemcpyFromSymbol(dst, pq_tl,
                                   sizeof(long long) * {BLOCKS} * {ROW});
}}
'''
    out = _build.BUILD_DIR.parent / "mlp_timeline"
    out.mkdir(parents=True, exist_ok=True)
    (out / "mlp_tl.cu").write_text(src)
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
                        str(_build.CSRC), "-o", str(out / "libtl.so"),
                        str(out / "mlp_tl.cu")], capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed:\n{r.stdout}\n{r.stderr}")
    lib = ctypes.CDLL(str(out / "libtl.so"))
    for name in ("pq_mlp_fused", "pq_mlp_attributes"):
        fn = getattr(lib, name)
        fn.argtypes = _build.SIGNATURES[name]
        fn.restype = ctypes.c_int
    lib.pq_tl_read.argtypes = [ctypes.c_void_p]
    return lib


def spread(a) -> str:
    if len(a) == 0:
        return "none"
    return (f"min {np.min(a):.2f} med {np.median(a):.2f} "
            f"max {np.max(a):.2f}")


def run(lib, dev, gen, label, m, k, i_ff, n, act, splits=None):
    """One MLP through the instrumented entry; prints the timeline of the
    last of five launches."""
    bf = torch.bfloat16
    w13 = torch.randint(0, 256, (k // 2, 2 * i_ff), generator=gen,
                        device=dev, dtype=torch.uint8)
    w2 = torch.randint(0, 256, (i_ff // 2, n), generator=gen, device=dev,
                       dtype=torch.uint8)
    s13 = torch.rand(2 * i_ff, generator=gen, device=dev) * 1e-3 + 1e-3
    s2 = torch.rand(n, generator=gen, device=dev) * 1e-3 + 1e-3
    z13 = torch.randint(0, 16, (2 * i_ff,), generator=gen, device=dev,
                        dtype=torch.int32)
    z2 = torch.randint(0, 16, (n,), generator=gen, device=dev,
                       dtype=torch.int32)
    x = torch.randn((m, k), generator=gen, device=dev).to(bf)
    mt, blocks, ksb, rows_b = Q.mlp_plan(dev.index or 0, m, k, i_ff, n)
    if splits is not None:              # stage B in `splits` splits
        att = Q.mlp_attributes(mt, dev.index or 0)
        full = _build.sm_count(dev.index or 0) * att[5]
        stages = -(-(i_ff // 2) // att[4])
        rows_b = -(-stages // splits) * att[4]
        ksb = -(-(i_ff // 2) // rows_b)
        blocks = min(full, i_ff // Q.MLP_HIDDEN + -(-n // Q.MLP_TILE) * ksb)
    out = torch.empty((m, n), dtype=bf, device=dev)
    h = torch.empty((m, i_ff), dtype=bf, device=dev)
    part_b = torch.empty((ksb, m, n), device=dev)
    state = torch.zeros(2 + -(-n // Q.MLP_TILE) + ksb, dtype=torch.int32,
                        device=dev)
    for _ in range(5):
        _build.check(lib.pq_mlp_fused(
            x.data_ptr(), w13.data_ptr(), s13.data_ptr(), z13.data_ptr(),
            w2.data_ptr(), s2.data_ptr(), z2.data_ptr(), None,
            out.data_ptr(), h.data_ptr(), part_b.data_ptr(),
            state.data_ptr(), m, k, i_ff, n, ksb, rows_b, blocks,
            int(act == "gelu"), 1,
            torch.cuda.current_stream().cuda_stream), "pq_mlp_fused")
    torch.cuda.synchronize()
    want = Q.mlp_fused_plain(x, w13, s13, z13, w2, s2, z2, None, act, bf)
    torch.testing.assert_close(out.float(), want.float(), atol=2e-2,
                               rtol=1e-2)
    buf = np.zeros(BLOCKS * ROW, dtype=np.int64)
    _build.check(lib.pq_tl_read(buf.ctypes.data), "pq_tl_read")
    t = buf.reshape(BLOCKS, ROW)[:blocks]
    t0 = t[:, 0].min()
    ghz = (t[:, 5] - t[:, 4]) / np.maximum(t[:, 1] - t[:, 0], 1)
    n_ai = i_ff // Q.MLP_HIDDEN
    stats = {"A": ([], [], []), "B": ([], [], [])}
    for row in t:
        prev_end = row[0]
        for i in range(min(int(row[3]), ITEMS)):
            iid, ready, e0, e1 = row[8 + 4 * i: 12 + 4 * i]
            s = stats["A" if iid < n_ai else "B"]
            s[0].append((e0 - ready) / 1e3)
            s[1].append((e1 - e0) / 1e3)
            s[2].append((ready - prev_end) / 1e3)
            prev_end = e1
    print(f"{label} M={m}: plan blocks {blocks}, ksb {ksb} x {rows_b}; span {(t[:, 1].max() - t0) / 1e3:.2f} us; "
          f"block ends {spread((t[:, 1] - t0) / 1e3)}; clock "
          f"{np.median(ghz):.3f} GHz; items a block "
          f"{spread(t[:, 3])}; h wait a block {spread(t[:, 2] / 1e3)} us "
          f"[{c.card_line()}]", flush=True)
    for kind, (stream, epi, gap) in stats.items():
        print(f"  {kind} items ({len(stream)}): stream {spread(stream)} us; "
              f"epilogue {spread(epi)} us; gap before {spread(gap)} us",
              flush=True)


def main() -> None:
    lib = instrumented()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for splits in [None] + [int(a) for a in sys.argv[1:]]:
        for m in (8, 64):
            run(lib, dev, gen, "Llama-3-8B", m, 4096, 14336, 4096, "silu",
                splits)
        run(lib, dev, gen, "Gemma-7B", 8, 3072, 24576, 3072, "gelu", splits)


if __name__ == "__main__":
    main()
