"""Time the wide-head flash kernel of one tree, to compare two trees in turns.

    python3 tools/flash_wide_compare.py TREE LABEL

Imports `chip_smoke` and `piquant_tpu_torch` from TREE (a checkout or an
unpacked `git archive`), builds its kernels there, and on the card times
`flash_attn` (events over 10 launches, `chip_smoke.cuda_ms`) at head_dim 384,
512 and 1024, rep 4: causal at B 8, Hkv 2, T 1024 and a window of 256 at B 2,
each with its largest gap to `flash_attn_plain`.  Prints one line: LABEL, the
build's seconds, each case's ms (and gap), the card's name and power limit.
Run parent, change, change, parent in one call to compare two trees.
"""
import os
import sys

tree = os.path.abspath(sys.argv[1])
label = sys.argv[2]
sys.path.insert(0, tree)
os.chdir(tree)

import torch  # noqa: E402

import chip_smoke as c  # noqa: E402
from piquant_tpu_torch.ops.cuda import _build  # noqa: E402
from piquant_tpu_torch.ops.cuda import flash as FL  # noqa: E402

if not str(_build.CSRC).startswith(tree):
    sys.exit(f"the package comes from {_build.CSRC}, not from {tree}")
build = _build.build()
_build.library()
dev = torch.device("cuda")
gen = torch.Generator(device=dev).manual_seed(0)
out = []
for d in (384, 512, 1024):
    for b, hkv, t, window in ((8, 2, 1024, None), (2, 2, 1024, 256)):
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16) for shape in ((b, hkv, 4, t, d), (b, hkv, t, d),
                                          (b, hkv, t, d)))
        err = float((FL.flash_attn(q, k, v, d ** -0.5, window)
                     - FL.flash_attn_plain(q, k, v, d ** -0.5, window))
                    .abs().max())
        ms = c.cuda_ms(lambda i: FL.flash_attn(q, k, v, d ** -0.5, window),
                       10)
        out.append(f"D{d} {'causal' if window is None else 'w256'} "
                   f"{ms:.4f} ({err:.1e})")
print(label, "build", f"{build.seconds:.1f}", " | ".join(out), c.card_line(),
      flush=True)
