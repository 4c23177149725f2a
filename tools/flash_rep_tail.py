"""Read the tail of flash's gap to its plain version at GQA reps 8 and 64.

    python3 tools/flash_rep_tail.py [SEEDS]

On the card, flash against `flash_attn_plain` at head_dim 256 and 128, T 256,
Hkv 2, with the inputs drawn as tests/test_torch_cuda.py's
test_flash_reps_above_8 draws them (its seed for the case, then the next
SEEDS - 1, default 16 in all): causal and a window of 63 at rep 64 and B 2,
at rep 8 and B 16 (the same 16,777,216 context elements at D 256), and at
rep 8 and B 2.  For each case and seed: the elements past the test's stated
bound 2e-3 + 2e-2 |want|, the largest |got - want| and its ratio to that
bound, and the largest ratio to the bound plus twice `rounding_bound`.
Prints a line a case and one `RESULT {...}` line, with the card's name and
power limit.
"""
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import card_line  # noqa: E402
from piquant_tpu_torch.ops.cuda import flash as FL  # noqa: E402

T, HKV = 256, 2
MODES = {"causal": {}, "window": dict(window=63)}
CASES = ((64, 2), (8, 16), (8, 2))             # (rep, B)


def read(rep, b, d, mode, seed):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, HKV, rep, T, d), generator=g, device=dev)
    k = torch.randn((b, HKV, T, d), generator=g, device=dev)
    v = torch.randn((b, HKV, T, d), generator=g, device=dev)
    kw, sm = MODES[mode], d ** -0.5
    got = FL.flash_attn(q, k, v, sm, **kw)
    want = FL.flash_attn_plain(q, k, v, sm, **kw)
    gap = (got - want).abs()
    stated = 2e-3 + 2e-2 * want.abs()
    wide = stated + 2 * FL.rounding_bound(q, k, v, sm, **kw)
    return {"past": int((gap > stated).sum()), "max_gap": float(gap.max()),
            "max_ratio": float((gap / stated).max()),
            "max_ratio_rounding": float((gap / wide).max())}


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    seeds = int(sys.argv[1]) if len(sys.argv) > 1 else 16
    torch.backends.cuda.matmul.allow_tf32 = False
    out = []
    for d in (256, 128):
        for mode in MODES:
            for rep, b in CASES:
                first = 9200 + rep * T + d + len(mode)   # the test's seed
                rows = [read(rep, b, d, mode, first + i) for i in range(seeds)]
                case = {
                    "d": d, "mode": mode, "rep": rep, "b": b,
                    "elements": b * HKV * rep * T * d, "seeds": seeds,
                    "past_by_seed": [r["past"] for r in rows],
                    "seeds_past": sum(r["past"] > 0 for r in rows),
                    "max_gap": max(r["max_gap"] for r in rows),
                    "max_ratio": max(r["max_ratio"] for r in rows),
                    "max_ratio_rounding": max(r["max_ratio_rounding"]
                                              for r in rows)}
                print(json.dumps(case), flush=True)
                out.append(case)
    print("RESULT " + json.dumps({"card": card_line(), "cases": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
