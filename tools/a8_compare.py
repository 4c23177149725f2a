"""Time the int8-activation kernels, or the act-quant CLI runs, of one tree.

    python3 tools/a8_compare.py TREE LABEL kernels   # or: cli

TREE is a checkout of the repository (e.g. a parent commit unpacked with
`git archive` under the ignored build/); its own chip_smoke.py and port are
imported, so two trees are compared by running this once a tree, in turns
(parent, this, this, parent) in one call on the card.  `kernels`: the device
ms (CUDA-graph replay) of w4a8, w8a8 and w2a8 summed over a Llama-3-8B
layer's projections at M = 1024 and M = 8, and of wq_ragged_a8 over a
Mixtral MoE layer (1024 tokens; the routing's live_blocks where the tree's
wrapper takes them).  `cli`: prefill and decode tok/s of the CLI's
benchmark at 4 layers under --act-quant-prefill (INT4, INT8),
--bits 2 --act-quant-decode and Mixtral's --act-quant-prefill.  Prints one
`RESULT {...}` line.
"""
import inspect
import json
import os
import sys

tree, label, what = os.path.abspath(sys.argv[1]), sys.argv[2], sys.argv[3]
sys.path.insert(0, tree)
os.chdir(tree)
import torch  # noqa: E402

import chip_smoke as c  # noqa: E402

dev = torch.device("cuda")
out = {"tree": label}
if what == "kernels":
    from piquant_tpu_torch.ops.cuda import qmatmul as Q
    from piquant_tpu_torch.ops.cuda import ragged as R
    from piquant_tpu_torch.quant import moe as MO
    from piquant_tpu_torch.quant.linear import _quantize_act

    gen = torch.Generator(device=dev).manual_seed(0)
    for name, bits, shapes in (("w4a8", 4, c.W4_SHAPES),
                               ("w8a8", 8, c.W4_SHAPES[:3]),
                               ("w2a8", 2, c.W4_SHAPES)):
        kern = getattr(Q, name)
        for m in (1024, 8):
            tot = 0.0
            per = {}
            for k, n, uses in shapes:
                g = torch.Generator(device=dev).manual_seed(k + n + bits)
                qls = [c.random_qlin(torch, dev, g, k, n, bits, None)
                       for _ in range(2)]
                xq, xs = _quantize_act(torch.randn(
                    (m, k), generator=g, device=dev).to(torch.bfloat16))
                ops = [(xq, xs, ql.data, *Q.a8_operands(
                    xq, ql, 128 if bits == 8 else 0)) for ql in qls]
                t = c.cuda_ms(lambda i: kern(*ops[i % 2], torch.bfloat16), 20)
                per[f"{k}x{n}"] = t
                tot += uses * t
            out[f"{name} M={m}"] = tot
            out[f"{name} M={m} shapes"] = per
    r, counts, ends = c.moe_routing(torch, dev, gen, c.MOE_T)
    live = ("live_blocks" in inspect.signature(R.wq_ragged_a8).parameters)
    for bits in (4, 2):
        tot = 0.0
        for k, n, uses in c.MOE_SHAPES:
            st = c.random_stack(torch, dev, gen, k, n, bits, None)
            xs_ = MO.scatter_tokens(torch.randn(
                (c.MOE_T, k), generator=gen, device=dev).to(torch.bfloat16),
                r)
            xq, xsc = _quantize_act(xs_)
            s, zs = R._channel_side(st)
            ops = (xq, xsc, st.data, s, zs, xq.float().sum(1, keepdim=True),
                   r.block_expert, torch.bfloat16)
            extra = (r.live_blocks,) if live else ()
            tot += uses * c.cuda_ms(lambda i: R.wq_ragged_a8(*ops, *extra),
                                    10)
            del st
        out[f"wq_ragged_a8 INT{bits}"] = tot
else:
    from piquant_tpu_torch.serving import __main__ as S

    for preset, flags in (("llama3_8b", ("--act-quant-prefill",)),
                          ("llama3_8b", ("--bits", "8",
                                         "--act-quant-prefill")),
                          ("llama3_8b", ("--bits", "2",
                                         "--act-quant-decode")),
                          ("mixtral_8x7b", ("--act-quant-prefill",))):
        with c.cut_depth(preset, c.CLI_DEPTH):
            a = S.build_parser().parse_args(
                ["--random", preset, "--benchmark", "8", "--max-new", "32",
                 *flags])
            cfg, params, eng, sp = S.build(a)
            metrics, done = S.benchmark(a, cfg, eng, sp)
            torch.cuda.synchronize()
            out[f"{preset} {' '.join(flags)}"] = {
                k: metrics[k] for k in ("prefill_tokens_per_s",
                                        "decode_tokens_per_s")
                if k in metrics}
            del cfg, params, eng, sp, done
            torch.cuda.empty_cache()
print("RESULT " + json.dumps(out), flush=True)
