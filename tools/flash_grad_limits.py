"""Read where the flash backward's checks sit between sound kernels and
planted faults, over several seeds.

    python3 tools/flash_grad_limits.py [SEEDS [PARTS]]

On the card, for SEEDS seeds (default 3), the parts in PARTS (default
"ab"):

(a) at each of `chip_smoke.BWD_SHAPES`: flash_attn's gradients through
    FlashAttnFunction against `flash_attn_bwd_plain`: the largest share of
    `bwd_rounding_bound` (with one bf16 rounding of the gradient) and the
    norm-wise gap `bwd_norm_gap` of dq / dk / dv; the norm-wise gap of the
    faults that `chip_smoke.planted_faults` plants in the kernels'
    arguments; and the gap of the kernels' plain versions (their recipe
    in plain PyTorch, on the card).
(b) Llama-3-8B's widths at `chip_smoke.TRAIN_DEPTH` layers (f32 params
    from the seed), one row of T 2048 tokens: the loss's gradients through
    flash (mask None), through the materialized path (an explicit additive
    causal mask), through the materialized path with every bf16 operand
    rounding of its attention left out (an f32 reference), through flash
    with `flash_attn_bwd_plain` for its backward, through flash with delta
    taken from the f32 dO (the first design; dP takes the bf16 one), and
    through the materialized path with the bf16 roundings of its backward
    left out.  For each pair, the largest over the leaves of the largest
    |difference| over the leaf's largest |gradient| (chip_smoke's
    TRAIN_GRAD_RTOL reading) and of ||difference|| / ||leaf||; and the
    same for flash with faults planted in its backward (delta 0, a query
    tile skipped, a tile's lse from the tile before, the keys more than
    1024 back dropped) against the masked path.

Prints a line a reading, with the card's name and power limit.
"""
import dataclasses
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as CS  # noqa: E402
from piquant_tpu_torch.models import llama as M  # noqa: E402
from piquant_tpu_torch.ops.cuda import _build  # noqa: E402
from piquant_tpu_torch.ops.cuda import flash as FL  # noqa: E402
from piquant_tpu_torch.utils import tree  # noqa: E402


def kernels(dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    for label, b, hkv, rep, t, window, chunk, pos0 in CS.BWD_SHAPES:
        d, sm = 128, 128 ** -0.5
        q, k, v = (torch.randn(s, generator=gen, device=dev).to(
            torch.bfloat16) for s in ((b, hkv, rep, t, d), (b, hkv, t, d),
                                      (b, hkv, t, d)))
        do = torch.randn((b, hkv, rep, t, d), generator=gen, device=dev)
        p0 = (None if pos0 is None
              else torch.tensor(pos0, dtype=torch.int32, device=dev))
        qs, ks, vs = (a.detach().requires_grad_() for a in (q, k, v))
        got = torch.autograd.grad(
            FL.flash_attn(qs, ks, vs, sm, window, None, chunk, p0),
            (qs, ks, vs), do)
        want = FL.flash_attn_bwd_plain(q, k, v, do, sm, window, chunk, p0)
        bounds = FL.bwd_rounding_bound(q, k, v, do, sm, window, chunk, p0)
        share = max(float(((g.float() - w).abs()
                           / (bd + 2.0 ** -8 * w.abs())).max())
                    for g, w, bd in zip(got, want, bounds))
        del bounds
        norm = FL.bwd_norm_gap(got, want)
        p0c = FL._chunk_pos0(q, chunk, p0)
        o, lse = FL._forward(q, k, v, sm, window, None, chunk, p0c, None,
                             True, _build.attention_entry(
                                 "pq_flash_prefill", d))
        delta, dob = FL.flash_bwd_delta(o, do)
        args = (q, k, v, dob, lse, delta, sm, window, chunk, p0c)
        direct = FL.bwd_norm_gap(
            (FL.flash_bwd_dq(*args),) + FL.flash_bwd_dkv(*args), want)
        faults = CS.planted_faults(torch, FL, args, want)
        plain = FL.bwd_norm_gap(
            (FL.flash_bwd_dq_plain(*args),) + FL.flash_bwd_dkv_plain(*args),
            want)
        print(f"(a) seed {seed} {label}: bound share {share:.3f}; norm-wise "
              f"dq / dk / dv {norm[0]:.3e} / {norm[1]:.3e} / {norm[2]:.3e} "
              f"(kernels' f32 outputs {max(direct):.3e}, their plain "
              f"versions {max(plain):.3e}; limit {FL.BWD_NORM_RTOL:.3e}); "
              "faults " + ", ".join(
                  f"{f} {r:.3e}" for f, r in faults.items()), flush=True)
        del q, k, v, do, got, want, o, lse, delta, dob, args, qs, ks, vs
        torch.cuda.empty_cache()


def leaf_names(params):
    names = []

    def walk(node, path):
        if isinstance(node, dict):
            for key in sorted(node):
                walk(node[key], f"{path}.{key}" if path else key)
        elif isinstance(node, (list, tuple)):
            for i, x in enumerate(node):
                walk(x, f"{path}[{i}]")
        else:
            names.append(path)
    walk(params, "")
    return names


def f32_dot(eq, a, b):
    return torch.einsum(eq, a.float(), b.float())


class _RoundForward(torch.autograd.Function):
    """x rounded to bf16 in the forward; the gradient passed on in f32."""

    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).float()

    @staticmethod
    def backward(ctx, g):
        return g


def forward_rounded_dot(eq, a, b):
    """`_dot_bf16`'s forward with its backward's bf16 roundings left out."""
    return torch.einsum(eq, _RoundForward.apply(a), _RoundForward.apply(b))


def plant(kind):
    """FL's backward wrappers replaced by ones that plant `kind`; returns
    the originals."""
    orig = FL.flash_bwd_dkv, FL.flash_bwd_dq

    def bad(args, dq_side):
        qb, kb, vb, dob, lse, delta, sm, window, chunk, p0 = args
        t = qb.shape[-2]
        s0 = t // 128 * 64
        tile = slice(s0, s0 + 64)
        if kind == "delta 0":
            delta = torch.zeros_like(delta)
        elif kind == "a query tile skipped" and not dq_side:
            dob, delta = dob.clone(), delta.clone()
            dob[..., tile, :] = 0
            delta[..., tile] = 0
        elif kind == "a tile's lse from the tile before":
            lse = lse.clone()
            lse[..., tile] = lse[..., s0 - 64:s0]
        elif kind == "keys over 1024 back dropped":
            window = 1024
        return qb, kb, vb, dob, lse, delta, sm, window, chunk, p0

    def dkv(*a):
        return orig[0](*bad(a, False))

    def dq(*a):
        g = orig[1](*bad(a, True))
        if kind == "a query tile skipped":
            s0 = g.shape[-2] // 128 * 64
            g[..., s0:s0 + 64, :] = 0
        return g

    dkv.launches = dq.launches = 0     # the wrappers count on their name
    FL.flash_bwd_dkv, FL.flash_bwd_dq = dkv, dq
    return orig


def plain_backward(ctx, dout):
    """FlashAttnFunction's backward through `flash_attn_bwd_plain` (the f32
    autograd of the plain version) on the saved inputs."""
    qb, kb, vb, _, _, p0 = ctx.saved_tensors
    sm_scale, window, chunk = ctx.args
    grads = FL.flash_attn_bwd_plain(qb, kb, vb, dout, sm_scale, window,
                                    chunk, p0)
    return tuple(g.to(dt) for g, dt in zip(grads, ctx.dtypes)) + (None,) * 5


def model(dev, seed):
    cfg = dataclasses.replace(M.LlamaConfig.llama3_8b(),
                              n_layers=CS.TRAIN_DEPTH, dtype=torch.float32)
    params = M.init_params(cfg, seed=seed, device=dev)
    names = leaf_names(params)
    leaves, unflatten = tree.flatten(params)
    g = torch.Generator(device=dev).manual_seed(seed + 21)
    tokens = torch.randint(0, cfg.vocab_size, (1, CS.TRAIN_T + 1),
                           generator=g, device=dev)
    t = CS.TRAIN_T
    idx = torch.arange(t, device=dev)
    causal = torch.where(idx[None] <= idx[:, None], 0.0, -1e9)[None, None]

    def grads(mask):
        views = [x.detach().requires_grad_() for x in leaves]
        logits, _ = M.forward(cfg, unflatten(views), tokens[:, :-1],
                              mask=mask)
        lp = torch.log_softmax(logits.float(), dim=-1)
        loss = -lp.gather(-1, tokens[:, 1:, None].long()).mean()
        del logits, lp
        return torch.autograd.grad(loss, views)

    def read(a, b):
        """(max shares, norm shares, both worst with their leaves)."""
        mx = [float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30)
              for x, y in zip(a, b)]
        nm = [float((x - y).norm()) / max(float(y.norm()), 1e-30)
              for x, y in zip(a, b)]
        i, j = max(range(len(mx)), key=mx.__getitem__), \
            max(range(len(nm)), key=nm.__getitem__)
        return mx, nm, f"max {mx[i]:.3e} ({names[i]}), norm {nm[j]:.3e} " \
                       f"({names[j]})"

    g_flash = grads(None)
    g_mask = grads(causal)
    dot = M._dot_bf16
    M._dot_bf16 = f32_dot
    try:
        g_ref = grads(causal)
    finally:
        M._dot_bf16 = dot
    mx, nm, fm = read(g_flash, g_mask)
    print(f"(b) seed {seed}: flash vs masked: {fm}", flush=True)
    print(f"(b) seed {seed}: per leaf, flash vs masked (max, norm): " +
          "; ".join(f"{n} {a:.2e} {b:.2e}" for n, a, b in zip(names, mx, nm)),
          flush=True)
    print(f"(b) seed {seed}: flash vs f32 reference: "
          f"{read(g_flash, g_ref)[2]}", flush=True)
    mx, nm, fm = read(g_mask, g_ref)
    print(f"(b) seed {seed}: masked vs f32 reference: {fm}", flush=True)
    print(f"(b) seed {seed}: per leaf, masked vs f32 reference (max, norm): "
          + "; ".join(f"{n} {a:.2e} {b:.2e}"
                      for n, a, b in zip(names, mx, nm)), flush=True)
    del g_ref
    torch.cuda.empty_cache()
    kernel_bwd = FL.FlashAttnFunction.__dict__["backward"]
    FL.FlashAttnFunction.backward = staticmethod(plain_backward)
    try:
        g_plain = grads(None)
    finally:
        FL.FlashAttnFunction.backward = kernel_bwd
    print(f"(b) seed {seed}: flash vs flash with the f32 plain backward: "
          f"{read(g_flash, g_plain)[2]}; the latter vs masked: "
          f"{read(g_plain, g_mask)[2]}", flush=True)
    del g_plain
    torch.cuda.empty_cache()
    # delta from the f32 dO (the first design) where dP takes the bf16 one
    delta_fn = FL.flash_bwd_delta

    def f32_delta(o, dout):
        return ((o.float() * dout.float()).sum(-1),
                dout.to(torch.bfloat16).contiguous())

    f32_delta.launches = 0
    FL.flash_bwd_delta = f32_delta
    try:
        g_cons = grads(None)
    finally:
        FL.flash_bwd_delta = delta_fn
    M._dot_bf16 = forward_rounded_dot
    try:
        g_mfwd = grads(causal)
    finally:
        M._dot_bf16 = dot
    print(f"(b) seed {seed}: flash with delta from the f32 dO vs masked: "
          f"{read(g_cons, g_mask)[2]}; vs flash: {read(g_cons, g_flash)[2]};"
          f" masked with its backward unrounded vs masked: "
          f"{read(g_mfwd, g_mask)[2]}; vs flash: {read(g_mfwd, g_flash)[2]}"
          f"; vs flash with delta from the f32 dO: "
          f"{read(g_mfwd, g_cons)[2]}", flush=True)
    del g_cons, g_mfwd
    torch.cuda.empty_cache()
    for kind in ("delta 0", "a query tile skipped",
                 "a tile's lse from the tile before",
                 "keys over 1024 back dropped"):
        orig = plant(kind)
        try:
            g_bad = grads(None)
        finally:
            FL.flash_bwd_dkv, FL.flash_bwd_dq = orig
        print(f"(b) seed {seed}: fault {kind} vs masked: "
              f"{read(g_bad, g_mask)[2]}", flush=True)
        del g_bad
        torch.cuda.empty_cache()
    del g_flash, g_mask, params, leaves
    torch.cuda.empty_cache()


def main() -> int:
    seeds = int(sys.argv[1]) if len(sys.argv) > 1 else 3
    parts = sys.argv[2] if len(sys.argv) > 2 else "ab"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    print(CS.card_line(), flush=True)
    _build.build()
    for seed in range(seeds if "a" in parts else 0):
        kernels(dev, seed)
    for seed in range(seeds if "b" in parts else 0):
        model(dev, seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
