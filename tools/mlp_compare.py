"""Time the fused MLP (row 23) and the dequantize kernel (rows 7, 8) of one
tree.

    python3 tools/mlp_compare.py TREE LABEL

TREE is a checkout of the repository (e.g. a parent commit unpacked with
`git archive` under the ignored build/); its own chip_smoke.py and port are
imported, so two trees are compared by running this once a tree, in turns
(parent, this, this, parent) in one call on the card.  Prints the device ms
(CUDA-graph replay, `chip_smoke.cuda_ms`) of:
  * `mlp_fused` at Llama-3-8B's MLP (K 4096, I 14336, N 4096, SiLU) and
    Gemma-7B's (K 3072, I 24576, N 3072, GeGLU) at M 1, 8 and 64, bf16 out,
    two weight copies (each call streams from HBM), each tree with the
    operands its dispatch hands the wrapper (since the redesign no row sums
    of x; before it the sums its dispatch made in launches of their own,
    which the times leave out), and beside it the tree's two-kernel route
    on the same weights (`w4_gemv` on w13, the activation, `w4_gemv` on w2,
    no row sums);
  * `dequantize` u8 -> f32 SET and ADD and uint4 -> f32 SET at numel
    27,264,000, and u8 -> f32 SET at 1,048,576, by graph replay and by
    events around eager launches (`chip_smoke.event_ms`, as the phase 4
    yardstick is timed), and the host's wall time a call (`chip_smoke.host_ms`:
    eager calls, synchronised at the end), which bounds the events reading
    where a call's device time is shorter than its launch.
Ends with one `RESULT {...}` line.
"""
import json
import os
import sys

tree, label = os.path.abspath(sys.argv[1]), sys.argv[2]
sys.path.insert(0, tree)
os.chdir(tree)
import torch  # noqa: E402

import chip_smoke as c  # noqa: E402
from piquant_tpu_torch.dtypes import DTYPES  # noqa: E402
from piquant_tpu_torch.ops.cuda import dequantize as DQ  # noqa: E402
from piquant_tpu_torch.ops.cuda import qmatmul as Q  # noqa: E402

dev = torch.device("cuda")
bf = torch.bfloat16
out = {"tree": label, "card": c.card_line()}
own_sums = hasattr(Q, "mlp_plan")     # the redesigned wrapper sums x itself


def side(g, cols):
    return (torch.rand(cols, generator=g, device=dev) * 1e-3 + 1e-3,
            torch.randint(0, 16, (cols,), generator=g, device=dev,
                          dtype=torch.int32))


for tag, (k, i_ff, n, act) in (("Llama-3-8B", (4096, 14336, 4096, "silu")),
                               ("Gemma-7B", (3072, 24576, 3072, "gelu"))):
    g = torch.Generator(device=dev).manual_seed(k + i_ff)
    ws = [(torch.randint(0, 256, (k // 2, 2 * i_ff), generator=g, device=dev,
                         dtype=torch.uint8), *side(g, 2 * i_ff),
           torch.randint(0, 256, (i_ff // 2, n), generator=g, device=dev,
                         dtype=torch.uint8), *side(g, n))
          for _ in range(2)]
    for m in (1, 8, 64):
        x = torch.randn((m, k), generator=g, device=dev).to(bf)
        xsum = None if own_sums else x.float().sum(1, keepdim=True)
        t = c.cuda_ms(lambda i: Q.mlp_fused(x, *ws[i % 2], xsum, act, bf), 20)

        def two(i):
            w13, s13, z13, w2, s2, z2 = ws[i % 2]
            gu = Q.w4_gemv(x, w13, s13, z13, None, bf).float()
            h = (Q._mlp_act(gu[:, :i_ff], act) * gu[:, i_ff:]).to(bf)
            return Q.w4_gemv(h, w2, s2, z2, None, bf)

        t2 = c.cuda_ms(two, 20)
        out[f"mlp_fused {tag} M={m}"] = t
        out[f"two-kernel {tag} M={m}"] = t2
        print(f"{label} mlp_fused {tag} M={m}: {t:.4f} ms, two-kernel route "
              f"{t2:.4f} ms", flush=True)
    del ws
    torch.cuda.empty_cache()

u8, u4, f32 = DTYPES["uint8"], DTYPES["uint4"], DTYPES["f32"]
g = torch.Generator(device=dev).manual_seed(0)
n = c.LIB_N
codes = torch.randint(0, 256, (n,), generator=g, device=dev, dtype=torch.uint8)
codes4 = torch.randint(0, 256, (n // 2,), generator=g, device=dev,
                       dtype=torch.uint8)
acc = torch.zeros(n, device=dev)
small = codes[:1_048_576]
for tag, call in (
        ("u8 -> f32 SET", lambda i: DQ.dequantize(codes, n, 0.02, 3, u8, f32)),
        ("u8 -> f32 ADD",
         lambda i: DQ.dequantize(codes, n, 0.02, 3, u8, f32, acc)),
        ("uint4 -> f32 SET",
         lambda i: DQ.dequantize(codes4, n, 0.02, 3, u4, f32)),
        ("u8 -> f32 SET numel 1048576",
         lambda i: DQ.dequantize(small, small.numel(), 0.02, 3, u8, f32))):
    t, te, th = c.cuda_ms(call, 50), c.event_ms(call, 50), c.host_ms(call)
    out[f"dequantize {tag}"] = t
    out[f"dequantize {tag} events"] = te
    out[f"dequantize {tag} host"] = th
    print(f"{label} dequantize {tag}: {t:.4f} ms (events {te:.4f} ms, host "
          f"wall a call {th:.4f} ms)", flush=True)
print("RESULT " + json.dumps(out), flush=True)
