"""Time the int8 ring's kernels (row 25: `ring_hop`, `ring_gather`) of one
tree.

    python3 tools/ring_compare.py TREE LABEL [variants]

TREE is a checkout of the repository (e.g. a parent commit unpacked with
`git archive` under the ignored build/); its own chip_smoke.py and port are
imported, so two trees are compared by running this once a tree, in turns
(parent, this, this, parent) in one call on the card.  At Llama-3-8B's w1
gradient (chip_smoke.RING_N f32 a rank, P = 8, chunks of 65,536 values)
it prints the device ms (CUDA-graph replay, `chip_smoke.cuda_ms`), each
beside its byte bound, of:
  * `ring_hop` stacked: hop 1 (a received term) of all 8 rank rows in one
    launch;
  * `ring_hop` in the process-group form: one rank row a launch (rows 1,
    my0 r), the 8 ranks in turn, each launch with its own x, recv and send
    rows, so none finds the previous launch's bytes in L2;
  * `ring_gather` at nrep 8 (stacked: 8 replica rows) and nrep 1 (the
    group form: owned [P, bytes] into out [1, n]);
  * the whole stacked call (`rdma_all_reduce_shard`: 8 hops, 1 gather);
  * `fill_` of the gather's output rows (8 and 1), the card's write-only
    line for the gather.
With `variants` (a tree with `ring.hop_plan`): `ring_hop` in both forms
under each plan that holds the chunk on chip and under the two-pass path,
each held equal to the default plan's output.
Ends with one `RESULT {...}` line.
"""
import json
import os
import sys

tree, label = os.path.abspath(sys.argv[1]), sys.argv[2]
variants = sys.argv[3:] == ["variants"]
sys.path.insert(0, tree)
os.chdir(tree)
import torch  # noqa: E402

import chip_smoke as c  # noqa: E402
from piquant_tpu_torch.ops.cuda import ring as RG  # noqa: E402
from piquant_tpu_torch.parallel import rdma_all_reduce_shard  # noqa: E402

dev = torch.device("cuda")
p, n = c.RING_P, c.RING_N
g = torch.Generator(device=dev).manual_seed(0)
x = torch.randn((p, n), generator=g, device=dev)
segs, nbytes = RG.segments(n, p, c.RING_CHUNK)
seg = segs[0]
bufs = torch.empty((2, p, nbytes), dtype=torch.uint8, device=dev)
out = torch.empty((p, n), device=dev)
out1 = torch.empty((1, n), device=dev)
axis = c.ring_mesh(dev, p)
RG.ring_hop(x, seg, p, 0, bufs[0])
res = {"tree": label, "card": c.card_line()}


def row(r):
    return slice(r % p, r % p + 1)


def stacked(i):
    RG.ring_hop(x, seg, p, 1, bufs[1], bufs[0], 0, 1)


def group(i):
    r = i % p
    RG.ring_hop(x[row(r)], seg, p, 1, bufs[1][row(r)], bufs[0][row(r - 1)],
                r, 0)


vals = seg.nb * seg.csize           # values of a rank row a hop quantizes
bounds = {
    "ring_hop stacked": c.bound_ms(6 * p * vals + 8 * p * seg.nb, 0)[0],
    "ring_hop group": c.bound_ms(6 * vals + 8 * seg.nb, 0)[0],
    "ring_gather nrep 8": c.bound_ms(n + 4 * p * seg.nb + 4 * p * n, 0)[0],
    "ring_gather nrep 1": c.bound_ms(n + 4 * p * seg.nb + 4 * n, 0)[0],
    "whole call": c.bound_ms(8 * p * n, 0)[0],
}
calls = {
    "ring_hop stacked": (stacked, 20),
    "ring_hop group": (group, 64),
    "ring_gather nrep 8": (lambda i: RG.ring_gather(bufs[1], seg, p, out), 10),
    "ring_gather nrep 1": (lambda i: RG.ring_gather(bufs[1], seg, p, out1),
                           20),
    "whole call": (lambda i: rdma_all_reduce_shard(
        x, axis, max_chunk_elems=c.RING_CHUNK), 3),
    "fill_ 8 rows": (lambda i: out.fill_(0.5), 10),
    "fill_ 1 row": (lambda i: out1.fill_(0.5), 20),
}
bounds["fill_ 8 rows"] = c.bound_ms(4 * p * n, 0)[0]
bounds["fill_ 1 row"] = c.bound_ms(4 * n, 0)[0]


def report(name, fn, iters, bnd):
    t = c.cuda_ms(fn, iters)
    res[name] = t
    print(f"{label} {name}: {t:.4f} ms (bound {bnd:.4f}, "
          f"{c.bound_share(t, bnd)})", flush=True)


for name, (fn, iters) in calls.items():
    report(name, fn, iters, bounds[name])

if variants:
    stacked(0)
    torch.cuda.synchronize()
    ref = bufs[1].clone()
    plans = [RG.HopPlan(v, cl) for v in RG.HOP_VALS for cl in RG.CLUSTERS
             if seg.csize <= cl * RG.HOP_THREADS * v < 4 * seg.csize]
    for plan in plans + [RG.HopPlan(0, cl) for cl in (4, 8)]:
        tag = f"vals {plan.vals} cluster {plan.cluster}"

        def st(i, plan=plan):
            RG._hop_launch(x, seg, p, 1, bufs[1], bufs[0], 0, 1, plan)

        def gr(i, plan=plan):
            r = i % p
            RG._hop_launch(x[row(r)], seg, p, 1, bufs[1][row(r)],
                           bufs[0][row(r - 1)], r, 0, plan)

        bufs[1].zero_()
        st(0)
        torch.cuda.synchronize()
        if not torch.equal(bufs[1], ref):
            raise AssertionError(f"ring_hop {tag} differs from the default")
        report(f"ring_hop stacked {tag}", st, 20, bounds["ring_hop stacked"])
        report(f"ring_hop group {tag}", gr, 64, bounds["ring_hop group"])
print("RESULT " + json.dumps(res), flush=True)
