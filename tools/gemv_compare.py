"""Time the decode GEMV rows of one tree, or count their main-loop SASS.

    python3 tools/gemv_compare.py TREE LABEL kernels   # or: sass, clusters

TREE is a checkout of the repository (e.g. a parent commit unpacked with
`git archive` under the ignored build/); its own chip_smoke.py and port are
imported, so two trees are compared by running this once a tree, in turns
(parent, this, this, parent) in one call on the card.  `kernels`: the device
ms (CUDA-graph replay, enough weight copies that every call streams from
HBM) of each GEMV row at the shapes PERF.md lists, summed over a layer's
uses: w4_gemv over a decode layer of Llama-3-8B, Qwen2-7B, Qwen3-8B,
Phi-3-mini and Qwen3-30B-A3B at M = 8 (and Llama-3-8B at M = 64), w2 alone,
the INT8 lm_head (f32 out), a --bits 2 layer, g256 w2, the INT4-g128 layer
and INT2-g32 MLP in both x forms, NF4 channelwise / g64 / g128; each tree
with the operands its dispatch hands the wrapper (`gemv_operands`: since
the redesign no row sums for the channelwise forms; before it, the sums
its dispatch made in launches of their own, which the times leave out).
`sass`:
cuobjdump -sass of the tree's built kernels; for the INT4 channelwise, the
INT2-g32 chunk and the NF4-g128 instances at M <= 8, the instructions of
the innermost loop that holds the tensor-core products, their opcodes, and
the instructions a thread issues per packed byte: the static count (every
branch of the body, so both row-sum paths of the channelwise loop and all
four planes of the INT2 chunk loop, where a warp runs one path and two
planes) times 32 lanes over the packed bytes one pass of the loop covers a
warp.  `clusters`: for each form of the template at 1 and 8 n8 token
tiles, the packed rows a ring stage and the clusters of 2, 3, 4 and 8
blocks the card holds at once (cudaOccupancyMaxActiveClusters through
pq_gemv_attributes): what the K split's chooser reads.  Prints one
`RESULT {...}` line.
"""
import json
import os
import re
import subprocess
import sys
from collections import Counter

tree, label, what = os.path.abspath(sys.argv[1]), sys.argv[2], sys.argv[3]
sys.path.insert(0, tree)
os.chdir(tree)
import torch  # noqa: E402

import chip_smoke as c  # noqa: E402

out = {"tree": label, "card": c.card_line()}
if what == "kernels":
    from piquant_tpu_torch.ops.cuda import qmatmul as Q
    from piquant_tpu_torch.quant.linear import _quantize_act

    dev = torch.device("cuda")
    bf, f32 = torch.bfloat16, torch.float32
    rows = [("row 1 Llama-3-8B", "w4_gemv", 4, None, c.W4_SHAPES, bf, False, 8)]
    rows += [(f"row 1 {fam}", "w4_gemv", 4, None, shapes, bf, False, 8)
             for fam, shapes in c.FAMILY_SHAPES]
    rows += [("row 1 Llama-3-8B M=64", "w4_gemv", 4, None, c.W4_SHAPES, bf,
              False, 64),
             ("row 2 w2", "w4_gemv", 4, None, ((14336, 4096, 1),), bf, False,
              8),
             ("row 11 lm_head", "w8_gemv", 8, None, ((4096, 128256, 1),), f32,
              False, 8),
             ("row 12 --bits 2", "w2_gemv", 2, None, c.W4_SHAPES, bf, False, 8),
             ("row 17 g256 w2", "w4_grouped", 4, 256, ((14336, 4096, 1),), bf,
              False, 8),
             ("row 18 INT4-g128", "wg_chunk", 4, 128, c.W4_SHAPES, bf, False,
              8),
             ("row 18 INT2-g32 MLP", "wg_chunk", 2, 32, c.MLP_SHAPES, bf, False,
              8),
             ("row 18 int8-x INT2-g32 MLP", "wg_chunk", 2, 32, c.MLP_SHAPES,
              bf, True, 8),
             ("row 18 int8-x INT4-g128", "wg_chunk", 4, 128, c.W4_SHAPES, bf,
              True, 8),
             ("row 19 NF4", "nf4_gemv", "nf4", None, c.W4_SHAPES, bf, False, 8),
             ("row 19 NF4 g64", "nf4_gemv", "nf4", 64, c.W4_SHAPES, bf, False,
              8),
             ("row 19 NF4 g128", "nf4_gemv", "nf4", 128, c.W4_SHAPES, bf,
              False, 8)]
    for tag, name, bits, gs, shapes, odt, a8, m in rows:
        kern = getattr(Q, name)
        wbits = 4 if bits == "nf4" else bits
        tot, per = 0.0, {}
        for k, n, uses in shapes:
            g = torch.Generator(device=dev).manual_seed(k + n + wbits)
            copies = max(2, -(-256 * 2**20 // (k * n * wbits // 8)))
            qls = [c.random_qlin(torch, dev, g, k, n, bits, gs)
                   for _ in range(copies)]
            xb = torch.randn((m, k), generator=g, device=dev).to(bf)
            x, extra = xb, ()
            if a8:
                x, xs = _quantize_act(xb)
                extra = (xs,)
            ops = [c.gemv_operands(name, ql, x)[0] for ql in qls]
            t = c.cuda_ms(lambda i: kern(x, *ops[i % copies], odt, *extra), 30)
            per[f"{k}x{n}"] = t
            tot += uses * t
            del qls, ops
            torch.cuda.empty_cache()
        out[tag] = tot
        out[tag + " shapes"] = per
        print(f"{label} {tag}: {tot:.4f} ms", flush=True)
elif what == "clusters":
    from piquant_tpu_torch.ops.cuda import qmatmul as Q

    for form, tag in enumerate(Q.GEMV_FORMS):
        for mt in (1, 8):
            got = {}
            for ks in (2, 3, 4, 8):
                a = Q.gemv_attributes(form, mt, 128, ks)
                got[ks] = a[4]
            out[f"{tag} M<={8 * mt}"] = {"shared": a[2], "stage_rows": a[5],
                                         "clusters": got}
            print(f"{label} {tag} M<={8 * mt}: {a[2]} B shared, {a[5]} rows "
                  f"a stage; clusters of 2, 3, 4, 8: {list(got.values())}",
                  flush=True)
else:
    from piquant_tpu_torch.ops.cuda import _build

    lib = _build.build().path
    sass = subprocess.run(["cuobjdump", "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    funcs = re.split(r"\n\s+Function : ", sass)
    line = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
                      r"([^;]*);")
    # (tag, instance, packed bytes a pass of the loop covers a warp): one
    # 16-row block of 128 columns; one 32-row unit of 64; one 16-row block
    # of 64
    for tag, inst, warp_bytes in (
            ("INT4 channelwise M<=8", "gemv_tcILi2ELi0ELb0ELi1E", 16 * 128),
            ("INT2-g32 chunk M<=8", "gemv_tcILi4ELi1ELb0ELi1E", 32 * 64),
            ("NF4-g128 M<=8", "gemv_tcILi2ELi4ELb0ELi1E", 16 * 64)):
        body = next(f for f in funcs if f.startswith("_Z") and inst in
                    f.split("\n", 1)[0])
        ins = [(int(a, 16), op, rest) for a, _, op, rest in line.findall(body)]
        # the loop: the shortest backward branch whose body holds products
        best = None
        for addr, op, rest in ins:
            tgt = re.search(r"0x([0-9a-f]+)", rest)
            if op.startswith("BRA") and tgt and int(tgt.group(1), 16) < addr:
                lo = int(tgt.group(1), 16)
                inner = [o for a, o, _ in ins if lo <= a <= addr]
                mma = sum(o.startswith("HMMA") or o.startswith("IMMA")
                          for o in inner)
                if mma and (best is None or len(inner) < len(best[1])):
                    best = (mma, inner)
        ops = Counter(o.split(".")[0] for o in best[1] if o != "NOP")
        total = sum(ops.values())
        conv = sum(v for k, v in ops.items()
                   if k in ("I2F", "F2F", "I2FP", "F2I", "F2FP"))
        out[tag] = {"loop_instructions": total,
                    "per_packed_byte": total * 32 / warp_bytes,
                    "conversions": conv, "opcodes": dict(ops.most_common())}
        print(f"{label} {tag}: {total} instructions, "
              f"{total * 32 / warp_bytes:.2f} a packed byte, "
              f"{conv} conversions; {dict(ops.most_common(12))}", flush=True)
print("RESULT " + json.dumps(out), flush=True)
