"""Read decode attention's gap to its global-maximum form at a split edge
with one or two live positions on one side.

    python3 tools/split_edge.py reference [SEEDS]   # the CPU (imports JAX)
    python3 tools/split_edge.py card [SEEDS]        # the card

Both kernels round the probabilities to bf16 against a maximum of their
own: the reference's Pallas kernel (piquant_tpu/ops/pallas/decode_attn2.py,
in interpret mode) its 512-position chunk's running maximum, the port's
kernels (csrc/decode_attn2.cu, csrc/decode_wide.cu) each split's maximum
(at S 1024: splits of 2 tiles of 64 positions, edges at 128, 256, ...).
The yardstick rounds them against the global maximum: the port's
`decode_attn2_plain`, the jnp form's function in plain PyTorch, on the CPU
for `reference` and on the card for `card`.  Every batch row holds one
window [start, pos) of WINDOWS, each with 1 or 2 live positions on one side
of position 512 (an edge of both) or the edge inside a window of a few
positions; kv8 and kv4, Hkv 1, rep 4, S 1024, head_dim 128, 384, 512 and
1024.  For each form and head_dim: the largest
|got - want| of the normalized context over SEEDS seeds (default 8), and
the atol that rtol 2e-2 then needs.  Prints a line each and a
`RESULT {...}` line (on the card with its name and power limit).
"""
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from piquant_tpu_torch.ops.cuda import decode_attn2 as DA  # noqa: E402

S, HKV, REP = 1024, 1, 4
WIDTHS = (128, 384, 512, 1024)
# (start, pos): 1 or 2 live positions before the edge at 512, 1 or 2 after,
# 2 or 4 in all across it, and a long window for scale
WINDOWS = ((511, 700), (510, 700), (300, 513), (300, 514), (511, 513),
           (510, 514), (511, 512), (0, 513))


def inputs(seed, kv, d):
    """A stacked cache of one layer (codes and scales as the GPU tests draw
    them), q and the windows, as numpy arrays."""
    rng = np.random.default_rng(seed)
    b = len(WINDOWS)
    if kv == "kv4":
        codes = [rng.integers(0, 256, (1, b, HKV, S // 2, d)).astype(np.uint8)
                 for _ in range(2)]
        scales = [(rng.random((1, b, HKV, 2, S // 2)) * 0.02).astype(
            np.float32) for _ in range(2)]
    else:
        codes = [rng.integers(-127, 128, (1, b, HKV, S, d)).astype(np.int8)
                 for _ in range(2)]
        scales = [(rng.random((1, b, HKV, S, 1)) * 0.02).astype(np.float32)
                  for _ in range(2)]
    q = rng.normal(0, 1, (b, HKV, REP, d)).astype(np.float32)
    start = np.array([w[0] for w in WINDOWS], np.int32)
    pos = np.array([w[1] for w in WINDOWS], np.int32)
    return q, codes[0], scales[0], codes[1], scales[1], pos, start


def gap(got, want):
    """(largest |got - want|, the atol rtol 2e-2 needs) of two contexts."""
    err = np.abs(got - want)
    return float(err.max()), float((err - 2e-2 * np.abs(want)).max())


def plain_ctx(args, dev, d):
    q, kc, ks, vc, vs, pos, start = (torch.from_numpy(a).to(dev)
                                     for a in args)
    acc, _, l = DA.decode_attn2_plain(q, kc, ks, vc, vs, pos, start,
                                      d ** -0.5, 0)
    return (acc / l).cpu().numpy()


def reference(seeds):
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from piquant_tpu.ops.pallas.decode_attn2 import decode_attention_state

    jax.config.update("jax_platforms", "cpu")
    out = {}
    for kv, d in ((kv, d) for kv in ("kv8", "kv4") for d in WIDTHS):
        worst = (0.0, -1.0)
        for seed in range(seeds):
            args = inputs(seed, kv, d)
            q, kc, ks, vc, vs, pos, start = args
            with jax.enable_x64(False), pltpu.force_tpu_interpret_mode():
                acc, _, l = decode_attention_state(
                    *(jnp.asarray(a) for a in (q, kc, ks, vc, vs, pos)),
                    d ** -0.5, layer=0, starts=jnp.asarray(start),
                    interpret=True)
            g = gap(np.asarray(acc) / np.asarray(l),
                    plain_ctx(args, torch.device("cpu"), d))
            worst = max(worst[0], g[0]), max(worst[1], g[1])
        out[f"{kv} D={d}"] = worst
        print(f"reference Pallas {kv} D={d}: max |err| {worst[0]:.4e}, atol "
              f"needed at rtol 2e-2 {worst[1]:.4e} ({seeds} seeds)",
              flush=True)
    print("RESULT " + json.dumps({"reference": out}), flush=True)


def card(seeds):
    from chip_smoke import card_line

    dev = torch.device("cuda")
    out = {}
    for kv in ("kv8", "kv4"):
        kern = DA.decode_attn2_kv4 if kv == "kv4" else DA.decode_attn2
        for d in WIDTHS:
            worst = (0.0, -1.0)
            for seed in range(seeds):
                args = inputs(seed, kv, d)
                q, kc, ks, vc, vs, pos, start = (
                    torch.from_numpy(a).to(dev) for a in args)
                acc, _, l = kern(q, kc, ks, vc, vs, pos, start, d ** -0.5, 0)
                g = gap((acc / l).cpu().numpy(), plain_ctx(args, dev, d))
                worst = max(worst[0], g[0]), max(worst[1], g[1])
            out[f"{kv} D={d}"] = worst
            print(f"port kernel {kv} D={d}: max |err| {worst[0]:.4e}, atol "
                  f"needed at rtol 2e-2 {worst[1]:.4e} ({seeds} seeds)",
                  flush=True)
    print("RESULT " + json.dumps({"card": card_line(), "port": out}),
          flush=True)


if __name__ == "__main__":
    mode = sys.argv[1]
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    {"reference": reference, "card": card}[mode](n)
