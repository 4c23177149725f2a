"""Quantized matmuls of piquant_tpu/ops/pallas/qmatmul.py: the weight-only
`quantized_matmul` dispatch for decode-sized M and the activation-quantized
(int8 x) dispatch, with the TPU kernels they reach for affine weights:

    w4_gemv     _w4_kernel, _w4_kernel_ksplit    INT4 split-half, channelwise
    w8_gemv     _w8_kernel                       INT8, channelwise (lm_head)
    w2_gemv     _w2_kernel                       INT2 split-quarter, channelwise
    wg_chunk    _wg_chunk_kernel (bf16 / int8 x) grouped INT2/INT4
    w4_grouped  _w4_grouped_kernel               grouped INT4, W4A16 numerics
    nf4_gemv    _nf4_kernel                      NF4, channelwise or grouped
    w4a8        _w4a8_kernel, _w4a8_kernel_ksplit  int8 x, INT4 channelwise
    w8a8        _w8a8_kernel                     int8 x, INT8 channelwise
    w2a8        _w2a8_kernel                     int8 x, INT2 channelwise
    mlp_fused   _mlp_fused_kernel                w13 -> SwiGLU / GeGLU -> w2

Each wrapper launches its hand-written kernel (the first six are one
template in csrc/qmatmul_gemv.cu, the int8-x GEMMs one template in
csrc/qmatmul_a8.cu, the fused MLP csrc/qmatmul_mlp.cu) on CUDA tensors, counts the launch in `.launches`, and
runs `<name>_plain`, the same function in plain PyTorch, on CPU tensors.
The dispatch keeps the reference's shape gates, which decide whether a
call takes a kernel (and whether activations are quantized at all):
grouped plane rows divisible by the group size, N % 128, K % 256, M <= 64,
INT2 K % 512, the chunk kernel's own gate; for int8 x, w4a8 N % 256 and
K % 512, w2a8 N % 128 and K % 512, w8a8 N % 128, K % 256, K <= 8192 and
no groups, grouped a8 M rounded up to 32 at most M_MAX; for NF4 N % 128,
K % 256, (K/2) % gs, gs % 8, M <= 64.  It drops the TPU's tile choices and
VMEM budgets (bm, bn, bkh, W_BLOCK_VMEM_LIMIT, XK_VMEM_LIMIT and the
PIQUANT_W4_* / QMM_VMEM knobs), none of which
declines a Llama-3-8B shape: the kernels stage x in chunks and need no
whole-K block.
"""

from __future__ import annotations

import functools
import os
from typing import Callable, List, Optional

import torch
import torch.nn.functional as F

from piquant_tpu_torch.ops.cuda import _build

M_MAX = 64        # decode-sized M; larger M takes the dequant matmul path
_COLS = 128       # output columns per block (csrc/qmatmul_gemv.cu, qmatmul_mlp.cu)
PLANES = {2: 4, 4: 2, 8: 1}   # codes per byte by bit width
GEMV_CLUSTER = 8  # blocks of a thread-block cluster, the portable limit
# The instances of csrc/qmatmul_gemv.cu by number (pq_gemv_attributes' form)
GEMV_FORMS = ("INT8", "INT4", "INT2", "INT4 chunk", "INT2 chunk",
              "int8-x INT4 chunk", "int8-x INT2 chunk", "W4A16", "NF4",
              "NF4 grouped")
_FORM = {name: i for i, name in enumerate(GEMV_FORMS)}


def code_planes(data: torch.Tensor, planes: int) -> List[torch.Tensor]:
    """uint8 [K/P, N] -> the P code planes (plane p holds code rows
    p*K/P .. (p+1)*K/P - 1 in bits [p*8/P, (p+1)*8/P))."""
    bits = 8 // planes
    mask = (1 << bits) - 1
    return [(data >> (bits * p)) & mask for p in range(planes)]


def gemv_tiles(m: int) -> int:
    """n8 token tiles of a GEMV block: every row of M <= 64 in one block."""
    return 1 if m <= 8 else 2 if m <= 16 else 4 if m <= 32 else 8


def gemv_split(k: int, n: int, sms: int, planes: int, stage: int,
               resident: Optional[Callable[[int], int]] = None):
    """(ksplit, packed rows a split) of csrc/qmatmul_gemv.cu.  A block
    holds 128 columns and all M rows and streams whole ring stages of
    `stage` packed rows (the instance's, a multiple of 32).  K splits over
    the blocks of a thread-block cluster: the largest ksplit up to
    GEMV_CLUSTER and the stage count whose grid (column tiles x ksplit) the
    card holds at once, `resident(ksplit)` blocks (clusters of that size
    that fit, times the size; default `sms`).  The last split may hold
    fewer rows.  Every 32-row unit of a split lies in one group of any
    group size the kernels take, so a split need not hold whole groups."""
    stages = -(-(k // planes) // stage)
    tiles = n // _COLS
    best = 1
    for ks in range(2, min(GEMV_CLUSTER, stages) + 1):
        if tiles * ks <= (resident(ks) if resident else sms):
            best = ks
    per = -(-stages // best)
    return -(-stages // per), per * stage


def gemv_attributes(form: int, mt: int, gs: int, ksplit: int = 0,
                    device: Optional[int] = None) -> tuple:
    """pq_gemv_attributes of the instance of csrc/qmatmul_gemv.cu for
    `form` (an index of GEMV_FORMS), `mt` n8 token tiles and group size
    `gs`, on `device`: (registers, local (spill) bytes, dynamic shared
    memory, ring stages, clusters of `ksplit` blocks the card holds at once
    (0 for ksplit 0), packed rows a stage)."""
    import ctypes

    out = (ctypes.c_int * 6)()
    with torch.cuda.device(device):
        _build.check(_build.library().pq_gemv_attributes(form, mt, gs, ksplit,
                                                         out),
                     "pq_gemv_attributes")
    return tuple(out)


@functools.lru_cache(maxsize=None)
def gemv_plan(device: int, form: int, m: int, k: int, n: int, gs: int,
              planes: int):
    """(n8 token tiles, ksplit, packed rows a split) of a GEMV call on
    `device`: gemv_split with the instance's stage rows and cluster
    residency, asked of the card once a shape."""
    mt = gemv_tiles(m)
    stage = gemv_attributes(form, mt, gs, 0, device)[5]
    return (mt,) + gemv_split(
        k, n, _build.sm_count(device), planes, stage,
        lambda ks: ks * gemv_attributes(form, mt, gs, ks, device)[4])


def _check(name: str, ok: bool, err=ValueError, what: str = "") -> None:
    if not ok:
        raise err(f"{name}: {what}")


def _check_operands(name: str, x2: torch.Tensor, *rest) -> None:
    for t in (x2,) + rest:
        _check(name, t is None or (t.is_contiguous() and t.device == x2.device
                                   and t.data_ptr() % 16 == 0),
               what="operands must be contiguous, 16-byte aligned and on "
                    "one device")


def _launch(name: str, entry: str, form: str, x2: torch.Tensor,
            data: torch.Tensor, side: tuple, ints: tuple, planes: int,
            out_dtype, gs: int = 1, x_dtype=torch.bfloat16) -> torch.Tensor:
    """Shared checks and the one launch of the GEMV entry points (a None in
    `side` passes a null pointer); `form` (a GEMV_FORMS name) and `gs` name
    the kernel instance whose stage rows and cluster residency set the K
    split."""
    m, k = x2.shape
    n = data.shape[1]
    _check(name, out_dtype in (torch.bfloat16, torch.float32), TypeError,
           f"out dtype {out_dtype} not supported")
    _check(name, x2.dtype == x_dtype and data.dtype == torch.uint8,
           TypeError, f"x {x_dtype} and uint8 codes expected")
    _check(name, data.shape[0] * planes == k and n % _COLS == 0
           and k % 256 == 0 and 0 < m <= M_MAX,
           what=f"unsupported shape m={m} k={k} n={n}")
    _check_operands(name, x2, data, *side)
    _, ksplit, rows = gemv_plan(x2.device.index, _FORM[form], m, k, n, gs,
                                planes)
    out = torch.empty((m, n), dtype=out_dtype, device=x2.device)
    err = getattr(_build.library(), entry)(
        x2.data_ptr(), data.data_ptr(),
        *(None if t is None else t.data_ptr() for t in side),
        out.data_ptr(), m, k, n, *ints, ksplit, rows,
        int(out_dtype == torch.bfloat16), _build.stream_ptr(x2))
    _build.check(err, name)
    return out


# ---------------------------------------------------------------------------
# channelwise: w4_gemv, w8_gemv, w2_gemv
# ---------------------------------------------------------------------------

def _channel_plain(x2, data, scale, zp, xsum, out_dtype, planes):
    """The P plane products of the raw codes with f32 accumulation, then
    acc * scale - xsum * (zp * scale); xsum None: the f32 row sums of x2."""
    rows = data.shape[0]
    acc = None
    for p, plane in enumerate(code_planes(data, planes)):
        part = x2[:, p * rows:(p + 1) * rows].float() @ plane.float()
        acc = part if acc is None else acc + part
    if xsum is None:
        xsum = x2.float().sum(1, keepdim=True)
    return (acc * scale - xsum * (zp.float() * scale)).to(out_dtype)


def w4_gemv_plain(x2: torch.Tensor, data: torch.Tensor, scale: torch.Tensor,
                  zp: torch.Tensor, xsum: Optional[torch.Tensor],
                  out_dtype) -> torch.Tensor:
    """x2 [M, K] bf16, data [K/2, N] uint8, scale [N] f32, zp [N] int32,
    xsum [M, 1] f32 (the row sums of x2; None: computed here) -> [M, N]:
    the two nibble-plane products with f32 accumulation, then acc * scale -
    xsum * (zp * scale)."""
    return _channel_plain(x2, data, scale, zp, xsum, out_dtype, 2)


def w8_gemv_plain(x2, data, scale, zp, xsum, out_dtype) -> torch.Tensor:
    """As w4_gemv_plain for INT8 codes data [K, N] (`_w8_kernel`)."""
    return _channel_plain(x2, data, scale, zp, xsum, out_dtype, 1)


def w2_gemv_plain(x2, data, scale, zp, xsum, out_dtype) -> torch.Tensor:
    """As w4_gemv_plain for split-quarter INT2 data [K/4, N]: four plane
    products (`_w2_kernel`)."""
    return _channel_plain(x2, data, scale, zp, xsum, out_dtype, 4)


def _channel(name, entry, planes, x2, data, scale, zp, xsum, out_dtype):
    form = {1: "INT8", 2: "INT4", 4: "INT2"}[planes]
    _check(name, scale.dtype == torch.float32 and zp.dtype == torch.int32
           and (xsum is None or xsum.dtype == torch.float32), TypeError,
           "scale f32, zp int32, xsum f32 expected")
    n = data.shape[1]
    _check(name, scale.numel() == n and zp.numel() == n
           and (xsum is None or xsum.numel() == x2.shape[0]),
           what="scale/zp [N], xsum [M, 1]")
    return _launch(name, entry, form, x2, data, (scale, zp, xsum), (),
                   planes, out_dtype)


def w4_gemv(x2: torch.Tensor, data: torch.Tensor, scale: torch.Tensor,
            zp: torch.Tensor, xsum: Optional[torch.Tensor],
            out_dtype) -> torch.Tensor:
    """Kernel wrapper; see `w4_gemv_plain` for the function (xsum None: the
    kernel sums the rows of x2 itself)."""
    if not x2.is_cuda:
        return w4_gemv_plain(x2, data, scale, zp, xsum, out_dtype)
    _build.no_grad("w4_gemv", "13", x2, scale, zp)
    out = _channel("w4_gemv", "pq_w4_gemv", 2, x2, data, scale, zp, xsum,
                   out_dtype)
    w4_gemv.launches += 1
    return out


def w8_gemv(x2, data, scale, zp, xsum, out_dtype) -> torch.Tensor:
    """Kernel wrapper; see `w8_gemv_plain` for the function."""
    if not x2.is_cuda:
        return w8_gemv_plain(x2, data, scale, zp, xsum, out_dtype)
    _build.no_grad("w8_gemv", "13", x2, scale, zp)
    out = _channel("w8_gemv", "pq_w8_gemv", 1, x2, data, scale, zp, xsum,
                   out_dtype)
    w8_gemv.launches += 1
    return out


def w2_gemv(x2, data, scale, zp, xsum, out_dtype) -> torch.Tensor:
    """Kernel wrapper; see `w2_gemv_plain` for the function."""
    if not x2.is_cuda:
        return w2_gemv_plain(x2, data, scale, zp, xsum, out_dtype)
    _build.no_grad("w2_gemv", "13", x2, scale, zp)
    _check("w2_gemv", x2.shape[1] % 512 == 0,
           what=f"K={x2.shape[1]} is not a multiple of 512")
    out = _channel("w2_gemv", "pq_w2_gemv", 4, x2, data, scale, zp, xsum,
                   out_dtype)
    w2_gemv.launches += 1
    return out


w4_gemv.launches = w8_gemv.launches = w2_gemv.launches = 0


# ---------------------------------------------------------------------------
# grouped: wg_chunk, w4_grouped
# ---------------------------------------------------------------------------

def wg_chunk_plain(x2: torch.Tensor, data: torch.Tensor,
                   s_chunk: torch.Tensor, z_chunk: torch.Tensor, gs: int,
                   ch: int, out_dtype, xs: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """x2 [M, K] bf16 (or int8 with per-row scales xs [M, 1] f32), data
    [K/P, N] uint8 (P = 4 for INT2, 2 for INT4), s_chunk [G, N] bf16 and
    z_chunk [G, N] int8 in chunk-major group order -> [M, N]: per group, the
    raw-code product in f32 scaled after the product by that group's bf16
    scale; minus xg @ (z * s), with xg the group's sum of x in f32; times xs
    for int8 x (`_wg_chunk_kernel`, xdt 'bf16' or 'i8')."""
    from piquant_tpu_torch.quant.linear import grouped_chunk_perm

    m, k = x2.shape
    n = data.shape[1]
    planes = k // data.shape[0]
    g = k // gs
    perm = torch.from_numpy(grouped_chunk_perm(k, gs, ch, planes)).long()
    inv = torch.argsort(perm).to(data.device)
    s = s_chunk.float()[inv]                       # natural group order
    z = z_chunk.float()[inv]
    codes = torch.cat(code_planes(data, planes)).float().reshape(g, gs, n)
    xg = x2.float().reshape(m, g, gs).transpose(0, 1)    # [G, M, gs]
    acc = (torch.bmm(xg, codes) * s[:, None]).sum(0)
    acc = acc - xg.sum(-1).transpose(0, 1) @ (z * s)
    if xs is not None:
        acc = acc * xs
    return acc.to(out_dtype)


def w4_grouped_plain(x2: torch.Tensor, data: torch.Tensor,
                     scale: torch.Tensor, zp: torch.Tensor, gs: int,
                     out_dtype) -> torch.Tensor:
    """x2 [M, K] bf16, data [K/2, N] uint8, scale [G, N] f32, zp [G, N]
    int32 -> [M, N]: w = (c - z) * s in bf16 (scale and zero point cast to
    bf16), then the two bf16 plane products with f32 accumulation
    (`_w4_grouped_kernel`)."""
    kh = data.shape[0]
    s = scale.to(torch.bfloat16).repeat_interleave(gs, dim=0)
    z = zp.to(torch.bfloat16).repeat_interleave(gs, dim=0)
    lo, hi = (p.to(torch.bfloat16) for p in code_planes(data, 2))
    w_lo = (lo - z[:kh]) * s[:kh]
    w_hi = (hi - z[kh:]) * s[kh:]
    acc = (x2[:, :kh].float() @ w_lo.float()
           + x2[:, kh:].float() @ w_hi.float())
    return acc.to(out_dtype)


def _grouped_shape(name, x2, data, s, z, gs, planes):
    k, n = x2.shape[1], data.shape[1]
    _check(name, planes in (2, 4) and gs > 0 and gs % 8 == 0
           and (k // planes) % gs == 0,
           what=f"group size {gs} does not tile the planes of K={k}")
    _check(name, tuple(s.shape) == (k // gs, n) == tuple(z.shape),
           what="side streams must be [K / group_size, N]")


def wg_chunk(x2, data, s_chunk, z_chunk, gs: int, ch: int, out_dtype,
             xs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel wrapper; see `wg_chunk_plain` for the function."""
    if not x2.is_cuda:
        return wg_chunk_plain(x2, data, s_chunk, z_chunk, gs, ch, out_dtype,
                              xs)
    _build.no_grad("wg_chunk", "13", x2, s_chunk, z_chunk)
    name = "wg_chunk"
    planes = x2.shape[1] // data.shape[0]
    _grouped_shape(name, x2, data, s_chunk, z_chunk, gs, planes)
    _check(name, s_chunk.dtype == torch.bfloat16
           and z_chunk.dtype == torch.int8, TypeError,
           "s_chunk bf16, z_chunk int8 expected")
    _check(name, ch > 0 and (x2.shape[1] // planes // gs) % ch == 0,
           what=f"chunk factor {ch} does not divide the groups of a plane")
    _check(name, gs % 32 == 0,
           what=f"group size {gs} is off the kernel's 32-row units")
    if xs is not None:
        _check(name, xs.dtype == torch.float32, TypeError, "xs f32 expected")
        _check(name, xs.numel() == x2.shape[0], what="xs must be [M, 1]")
    form = ("" if xs is None else "int8-x ") + f"INT{8 // planes} chunk"
    out = _launch(name, "pq_wg_gemv", form, x2, data, (s_chunk, z_chunk, xs),
                  (gs, ch, planes), planes, out_dtype, gs,
                  torch.bfloat16 if xs is None else torch.int8)
    wg_chunk.launches += 1
    return out


def w4_grouped(x2, data, scale, zp, gs: int, out_dtype) -> torch.Tensor:
    """Kernel wrapper; see `w4_grouped_plain` for the function."""
    if not x2.is_cuda:
        return w4_grouped_plain(x2, data, scale, zp, gs, out_dtype)
    _build.no_grad("w4_grouped", "13", x2, scale, zp)
    name = "w4_grouped"
    _check(name, x2.shape[1] == 2 * data.shape[0],
           what="split-half INT4 codes expected")
    _grouped_shape(name, x2, data, scale, zp, gs, 2)
    _check(name, scale.dtype == torch.float32 and zp.dtype == torch.int32,
           TypeError, "scale f32, zp int32 expected")
    out = _launch(name, "pq_w4g_gemv", "W4A16", x2, data, (scale, zp), (gs,),
                  2, out_dtype, gs)
    w4_grouped.launches += 1
    return out


wg_chunk.launches = w4_grouped.launches = 0


# ---------------------------------------------------------------------------
# NF4 codebook: nf4_gemv
# ---------------------------------------------------------------------------

def nf4_gemv_plain(x2: torch.Tensor, data: torch.Tensor,
                   scale: torch.Tensor, gs: int, out_dtype) -> torch.Tensor:
    """x2 [M, K] bf16, data [K/2, N] uint8 split-half NF4 codes, scale f32
    [N] (channelwise, gs 0) or [G, N] (grouped, gs = K / G) -> [M, N]: each
    plane's codes through the codebook rounded to bf16; channelwise the two
    plane products in f32, then times the scale; grouped the values times
    the bf16 group scale, rounded to bf16, before the products
    (`_nf4_kernel`)."""
    from piquant_tpu_torch.quant.linear import codebook_lut

    kh = data.shape[0]
    lut = codebook_lut("nf4", torch.bfloat16, data.device)
    lo, hi = (lut[p.long()] for p in code_planes(data, 2))
    if gs:
        s = scale.to(torch.bfloat16).repeat_interleave(gs, dim=0)
        lo, hi = lo * s[:kh], hi * s[kh:]
    acc = (x2[:, :kh].float() @ lo.float() + x2[:, kh:].float() @ hi.float())
    if not gs:
        acc = acc * scale
    return acc.to(out_dtype)


def nf4_gemv(x2, data, scale, gs: int, out_dtype) -> torch.Tensor:
    """Kernel wrapper; see `nf4_gemv_plain` for the function."""
    if not x2.is_cuda:
        return nf4_gemv_plain(x2, data, scale, gs, out_dtype)
    _build.no_grad("nf4_gemv", "13", x2, scale)
    name = "nf4_gemv"
    k, n = x2.shape[1], data.shape[1]
    _check(name, x2.shape[1] == 2 * data.shape[0],
           what="split-half NF4 codes expected")
    _check(name, scale.dtype == torch.float32, TypeError, "scale f32 expected")
    if gs:
        _grouped_shape(name, x2, data, scale, scale, gs, 2)
    else:
        _check(name, scale.numel() == n, what="scale must be [N]")
    out = _launch(name, "pq_nf4_gemv", "NF4 grouped" if gs else "NF4", x2,
                  data, (scale,), (gs,), 2, out_dtype, gs or 1)
    nf4_gemv.launches += 1
    return out


nf4_gemv.launches = 0


def nf4_matmul(x: torch.Tensor, ql, out_dtype=torch.bfloat16
               ) -> Optional[torch.Tensor]:
    """x [..., K] @ NF4 weight -> [..., N] through nf4_gemv; None where the
    reference's `nf4_matmul` declines (N % 128, K % 256, (K/2) % gs, gs % 8,
    M > M_MAX)."""
    k, n, gs = ql.k, ql.n, ql.group_size
    if n % 128 or k % 256:
        return None
    if gs is not None and ((k // 2) % gs or gs % 8):
        return None
    lead = x.shape[:-1]
    m = 1
    for d in lead:
        m *= d
    if m > M_MAX:
        return None
    x2 = x.reshape(m, k).to(torch.bfloat16).contiguous()
    scale = (ql.scale.float().contiguous() if gs is not None
             else ql.scale.float().reshape(-1).expand(n).contiguous())
    return nf4_gemv(x2, ql.data, scale, gs or 0, out_dtype).reshape(*lead, n)


def wg_grouped_matmul(x2: torch.Tensor, ql, out_dtype,
                      xs: Optional[torch.Tensor] = None
                      ) -> Optional[torch.Tensor]:
    """Grouped INT2/INT4 through the chunk kernel, bf16 x or int8 x with
    per-row scales xs; None where the reference's `wg_grouped_matmul`
    declines (no chunk factor, a group size off the 32 quantum, no cached
    side streams, N % 128)."""
    from piquant_tpu_torch.quant.linear import grouped_chunk_factor

    k, n, gs = ql.k, ql.n, ql.group_size
    planes = PLANES[ql.bits]
    ch = grouped_chunk_factor(k, gs, planes)
    if ch is None or gs % 32 or ql.s_chunk is None or n % 128:
        return None
    return wg_chunk(x2, ql.data, ql.s_chunk, ql.z_chunk, gs, ch, out_dtype,
                    xs)


def quantized_matmul(x: torch.Tensor, ql, out_dtype=torch.bfloat16
                     ) -> Optional[torch.Tensor]:
    """x [..., K] @ packed weight -> [..., N]; None where the reference
    dispatch has no kernel either."""
    k, n = ql.k, ql.n
    gs = ql.group_size
    if gs is not None:
        plane_rows = {4: k // 2, 2: k // 4}.get(ql.bits)
        if plane_rows is None or plane_rows % gs or gs % 8:
            return None
    if n % 128 or k % 256:
        return None
    lead = x.shape[:-1]
    m = 1
    for d in lead:
        m *= d
    if m > M_MAX:
        return None
    if ql.bits == 2 and gs is None and k % 512:
        return None
    x2 = x.reshape(m, k).to(torch.bfloat16).contiguous()
    if gs is not None:
        y = wg_grouped_matmul(x2, ql, out_dtype)
        if y is None:
            if ql.bits == 2:
                return None
            y = w4_grouped(x2, ql.data, ql.scale.float().contiguous(),
                           ql.zero_point.to(torch.int32).contiguous(), gs,
                           out_dtype)
        return y.reshape(*lead, n)
    scale = ql.scale.float().reshape(-1).expand(n).contiguous()
    zp = ql.zero_point.to(torch.int32).reshape(-1).expand(n).contiguous()
    gemv = {4: w4_gemv, 8: w8_gemv, 2: w2_gemv}[ql.bits]
    return gemv(x2, ql.data, scale, zp, None, out_dtype).reshape(*lead, n)


# ---------------------------------------------------------------------------
# int8 activations: w4a8, w8a8, w2a8 (csrc/qmatmul_a8.cu)
# ---------------------------------------------------------------------------

_A8_COLS = 128    # output columns of a decode tile (csrc/qmatmul_a8.cu)
_A8_ROWS = 32     # packed rows of a decode tile's pipeline step
_A8_MIN_STAGES = 4   # stages (of 128 / P packed rows) a split at least


def a8_prefill_bm(m: int, k: int, planes: int) -> int:
    """Tokens of a prefill tile: 128 (a block of 256 weight columns) up to
    M 128, where 256 tokens would be half padding; above it 256 (a block of
    128 columns, which unpacks half the codes a product), except at INT2
    with K > 8192, where its stages of 32-byte x rows (1.5x the other
    tile's bytes) run the long K loop slower (chip_smoke.a8_tiles times
    both)."""
    if m <= 128:
        return 128
    return 256 if planes <= 2 or k <= 8192 else 128


def a8_split(m: int, k: int, n: int, sms: int, planes: int,
             prefill_bm: Optional[int] = None):
    """(tokens a block, ksplit, packed rows a split).  Decode M (<= M_MAX):
    mma.sync tiles of 16 or 64 rows x 128 columns, K split over blocks up
    to four blocks an SM, >= 128 packed rows a split, each a multiple of
    the 32-row pipeline step.  Prefill M: wgmma tiles of `prefill_bm`
    (default `a8_prefill_bm`) tokens x 32768 / prefill_bm columns, K split
    in whole stages of 128 / P packed rows (>= _A8_MIN_STAGES a split)
    where the tiles fill less than one wave of one block an SM."""
    rows = k // planes
    if m <= M_MAX:
        bm = 16 if m <= 16 else 64
        blocks = (n // _A8_COLS) * -(-m // bm)
        want = max(1, 4 * sms // blocks)
        ksplit = max(1, min(want, rows // 128))
        per = -(-rows // ksplit)
        per += -per % _A8_ROWS
        return bm, -(-rows // per), per
    bm = prefill_bm or a8_prefill_bm(m, k, planes)
    stages = k // 128
    tiles = -(-n // (32768 // bm)) * -(-m // bm)
    ksplit = max(1, min(sms // tiles, stages // _A8_MIN_STAGES))
    per = -(-stages // ksplit)
    return bm, -(-stages // per), per * (128 // planes)


def _a8_plain(xq, xs, data, scale, zs, xsum, out_dtype, planes, shift):
    """The P plane products of xq and the (shifted) codes, exact: in f64
    (every partial sum is an integer below 2^53) and cast to int32, as the
    kernels' int32 accumulator holds it; then the epilogue in f32,
    (f32(acc) * scale - xsum * zs) * xs."""
    rows = data.shape[0]
    acc = None
    for p, plane in enumerate(code_planes(data, planes)):
        part = xq[:, p * rows:(p + 1) * rows].double() @ (plane.double()
                                                           - shift)
        acc = part if acc is None else acc + part
    acc = acc.to(torch.int32).float()
    return ((acc * scale - xsum * zs) * xs).to(out_dtype)


def w4a8_plain(xq: torch.Tensor, xs: torch.Tensor, data: torch.Tensor,
               scale: torch.Tensor, zs: torch.Tensor, xsum: torch.Tensor,
               out_dtype) -> torch.Tensor:
    """xq [M, K] int8, xs [M, 1] f32, data [K/2, N] uint8 split-half, scale
    [N] f32, zs [N] f32 (= zp * scale), xsum [M, 1] f32 (the row sums of xq)
    -> [M, N]: acc = xq @ codes in int32, then (acc * scale - xsum * zs) *
    xs (`_w4a8_kernel`, `_w4a8_kernel_ksplit`)."""
    return _a8_plain(xq, xs, data, scale, zs, xsum, out_dtype, 2, 0)


def w8a8_plain(xq, xs, data, scale, zs, xsum, out_dtype) -> torch.Tensor:
    """As w4a8_plain for INT8 codes data [K, N] shifted to int8, cs = c -
    128, with zs = (zp - 128) * scale (`_w8a8_kernel`)."""
    return _a8_plain(xq, xs, data, scale, zs, xsum, out_dtype, 1, 128)


def w2a8_plain(xq, xs, data, scale, zs, xsum, out_dtype) -> torch.Tensor:
    """As w4a8_plain for split-quarter INT2 data [K/4, N]: four plane
    products (`_w2a8_kernel`)."""
    return _a8_plain(xq, xs, data, scale, zs, xsum, out_dtype, 4, 0)


def _a8(name, entry, planes, xq, xs, data, scale, zs, xsum, out_dtype):
    """Shared checks, scratch and launch of the a8 entry points."""
    m, k = xq.shape
    n = data.shape[1]
    _check(name, out_dtype in (torch.bfloat16, torch.float32), TypeError,
           f"out dtype {out_dtype} not supported")
    _check(name, xq.dtype == torch.int8 and data.dtype == torch.uint8
           and all(t.dtype == torch.float32 for t in (xs, scale, zs, xsum)),
           TypeError, "xq int8, uint8 codes, xs / scale / zs / xsum f32 "
                      "expected")
    _check(name, data.shape[0] * planes == k and n % _A8_COLS == 0
           and k % 256 == 0 and m > 0,
           what=f"unsupported shape m={m} k={k} n={n}")
    _check(name, scale.numel() == n and zs.numel() == n
           and xs.numel() == m and xsum.numel() == m,
           what="scale / zs [N], xs / xsum [M, 1]")
    _check_operands(name, xq, data, xs, scale, zs, xsum)
    bm, ksplit, rows = a8_split(m, k, n, _build.sm_count(xq.device.index),
                                planes)
    out = torch.empty((m, n), dtype=out_dtype, device=xq.device)
    partial = (torch.empty((ksplit, m, n), dtype=torch.int32,
                           device=xq.device) if ksplit > 1 else out)
    err = getattr(_build.library(), entry)(
        xq.data_ptr(), xs.data_ptr(), data.data_ptr(), scale.data_ptr(),
        zs.data_ptr(), xsum.data_ptr(), out.data_ptr(), partial.data_ptr(),
        m, k, n, bm, ksplit, rows, int(out_dtype == torch.bfloat16),
        _build.stream_ptr(xq))
    _build.check(err, name)
    return out


def w4a8(xq, xs, data, scale, zs, xsum, out_dtype) -> torch.Tensor:
    """Kernel wrapper; see `w4a8_plain` for the function."""
    if not xq.is_cuda:
        return w4a8_plain(xq, xs, data, scale, zs, xsum, out_dtype)
    _build.no_grad("w4a8", "13", xs, scale, zs)
    out = _a8("w4a8", "pq_w4a8", 2, xq, xs, data, scale, zs, xsum, out_dtype)
    w4a8.launches += 1
    return out


def w8a8(xq, xs, data, scale, zs, xsum, out_dtype) -> torch.Tensor:
    """Kernel wrapper; see `w8a8_plain` for the function."""
    if not xq.is_cuda:
        return w8a8_plain(xq, xs, data, scale, zs, xsum, out_dtype)
    _build.no_grad("w8a8", "13", xs, scale, zs)
    out = _a8("w8a8", "pq_w8a8", 1, xq, xs, data, scale, zs, xsum, out_dtype)
    w8a8.launches += 1
    return out


def w2a8(xq, xs, data, scale, zs, xsum, out_dtype) -> torch.Tensor:
    """Kernel wrapper; see `w2a8_plain` for the function."""
    if not xq.is_cuda:
        return w2a8_plain(xq, xs, data, scale, zs, xsum, out_dtype)
    _build.no_grad("w2a8", "13", xs, scale, zs)
    out = _a8("w2a8", "pq_w2a8", 4, xq, xs, data, scale, zs, xsum, out_dtype)
    w2a8.launches += 1
    return out


w4a8.launches = w8a8.launches = w2a8.launches = 0


def a8_operands(xq: torch.Tensor, ql, shift: int = 0):
    """(scale, zs, xsum) of a channelwise weight for the a8 wrappers, in the
    reference's f32 order: zs = (zp - shift) * scale, xsum the row sums of
    xq (exact in f32: |sum| <= 127 K < 2^24)."""
    n = ql.n
    s = ql.scale.float()
    zs = (ql.zero_point.float() - shift) * s
    return (s.reshape(-1).expand(n).contiguous(),
            zs.reshape(-1).expand(n).contiguous(),
            xq.float().sum(dim=1, keepdim=True))


def _grouped_a8(xq, xs, ql, out_dtype):
    """Grouped INT2/INT4 with int8 x: the chunk kernel up to M_MAX rows
    (M rounded up to the reference's 32-row int8 quantum), else None."""
    m = xq.shape[0]
    if m + (-m % 32) > M_MAX:
        return None
    return wg_grouped_matmul(xq, ql, out_dtype, xs=xs)


def w4a8_matmul(xq: torch.Tensor, xs: torch.Tensor, ql, out_dtype
                ) -> Optional[torch.Tensor]:
    """xq [M, K] int8 with per-row scales xs [M, 1] against an INT4 weight
    (channelwise, or grouped through the chunk kernel); None where the
    reference's `w4a8_matmul` declines."""
    if ql.bits != 4:
        return None
    if ql.group_size is not None:
        return _grouped_a8(xq, xs, ql, out_dtype)
    if ql.n % 256 or ql.k % 512:
        return None
    return w4a8(xq, xs, ql.data, *a8_operands(xq, ql), out_dtype)


def w8a8_matmul(xq, xs, ql, out_dtype) -> Optional[torch.Tensor]:
    """As w4a8_matmul for a channelwise INT8 weight; None where the
    reference's `w8a8_matmul` declines (grouped, N % 128, K % 256,
    K > 8192)."""
    k, n = ql.k, ql.n
    if ql.group_size is not None or n % 128 or k % 256 or k > 8192:
        return None
    return w8a8(xq, xs, ql.data, *a8_operands(xq, ql, 128), out_dtype)


def w2a8_matmul(xq, xs, ql, out_dtype) -> Optional[torch.Tensor]:
    """As w4a8_matmul for an INT2 weight (channelwise: N % 128, K % 512)."""
    if ql.bits != 2:
        return None
    if ql.group_size is not None:
        return _grouped_a8(xq, xs, ql, out_dtype)
    if ql.n % 128 or ql.k % 512:
        return None
    return w2a8(xq, xs, ql.data, *a8_operands(xq, ql), out_dtype)


# ---------------------------------------------------------------------------
# the fused MLP: mlp_fused (csrc/qmatmul_mlp.cu)
# ---------------------------------------------------------------------------

_BLOCKS = (1024, 512, 256)   # the reference's tile sizes, kept as a gate
MLP_TILE = 256    # weight columns a work item of csrc/qmatmul_mlp.cu
                  # streams: two 128-column boxes (an A item's gate and up
MLP_HIDDEN = 128  # columns of 128 hidden ones)
MLP_EPILOGUE = 3.0   # an item's epilogue and the wait for its first
                     # stage, in ring stages (H100, M <= 8: ~2.2 + ~1.9 us
                     # against ~1.7 us a stage, tools/mlp_timeline.py)


def mlp_queue(k: int, i_ff: int, n: int, rows_b: int) -> list:
    """The fused MLP's work items in the order its blocks claim them, the
    kernel's `Queue` (csrc/qmatmul_mlp.cu; `pq_mlp_queue` reports it, and a
    GPU test holds the two equal): I / 128 A items ("A", hidden tile, 0,
    K/2 packed rows, first and last B split whose h they write), the tiles
    j and j + I/2 in pairs, then split-major the B items ("B", output tile
    of 256, its split's packed rows r0, r1, split), w2's I/2 packed rows
    in splits of `rows_b`."""
    ih, n_a = i_ff // 2, i_ff // MLP_HIDDEN
    items = []
    for u in range(n_a):
        tile = (u & 1) * (n_a // 2) + (u >> 1)
        j = tile * MLP_HIDDEN % ih
        items.append(("A", tile, 0, k // 2, j // rows_b,
                      (j + MLP_HIDDEN - 1) // rows_b))
    for q in range(-(-ih // rows_b)):
        for c in range(-(-n // MLP_TILE)):
            items.append(("B", c, q * rows_b, min(q * rows_b + rows_b, ih),
                          q, q))
    return items


def mlp_makespan(k: int, i_ff: int, n: int, stage: int, blocks: int,
                 per: int) -> float:
    """The fused MLP's time in ring stages (csrc/qmatmul_mlp.cu) with stage
    B split in `per` stages of `stage` rows: `blocks` blocks take the
    items of mlp_queue in order, each when it is free, a B item no sooner
    than the last A item that writes its split's h ends; an item costs its
    stages plus MLP_EPILOGUE."""
    import heapq

    free = [0.0] * blocks
    ready = {}                          # when each B split's h is written
    for kind, _, r0, r1, q0, q1 in mlp_queue(k, i_ff, n, per * stage):
        start = heapq.heappop(free)
        if kind == "B":
            start = max(start, ready[q0])
        end = start + -(-(r1 - r0) // stage) + MLP_EPILOGUE
        heapq.heappush(free, end)
        if kind == "A":
            for q in range(q0, q1 + 1):
                ready[q] = max(ready.get(q, 0.0), end)
    return max(free)


def mlp_split(k: int, i_ff: int, n: int, stage: int, blocks: int):
    """(ksb, packed rows a split) of the fused MLP's stage B
    (csrc/qmatmul_mlp.cu): the I/2 packed rows of w2 in whole ring stages
    of `stage` rows, split for the shortest mlp_makespan (ties: fewer
    splits, so fewer epilogues and parts).  The last split may hold fewer
    rows."""
    stages = -(-(i_ff // 2) // stage)
    best = None
    for ksb in sorted({-(-stages // p) for p in range(1, stages + 1)}):
        per = -(-stages // ksb)
        t = mlp_makespan(k, i_ff, n, stage, blocks, per)
        if best is None or t < best[0] - 1e-9:
            best = (t, -(-stages // per), per * stage)
    return best[1], best[2]


def mlp_attributes(mt: int, device: Optional[int] = None) -> tuple:
    """pq_mlp_attributes of the fused MLP's instance at `mt` n8 token tiles
    on `device`: (registers, local (spill) bytes, dynamic shared memory,
    ring stages, packed rows a stage, blocks an SM holds at once)."""
    import ctypes

    out = (ctypes.c_int * 6)()
    with torch.cuda.device(device):
        _build.check(_build.library().pq_mlp_attributes(mt, out),
                     "pq_mlp_attributes")
    return tuple(out)


@functools.lru_cache(maxsize=None)
def mlp_plan(device: int, m: int, k: int, i_ff: int, n: int):
    """(n8 token tiles, blocks, ksb, packed rows a B split) of a fused-MLP
    call on `device`: a persistent grid of the blocks the card holds at
    once (no more than the work items), and mlp_split with the instance's
    stage rows; asked of the card once a shape.  Stage A is not split: its
    i_ff / 128 items (112 at Llama-3-8B, 192 at Gemma-7B) each stream all
    of K, and the queue balances them with stage B's, whose weight boxes
    load while stage A ends (a K split of stage A, its parts added by a
    ticket, ran slower on an H100 at every split tried)."""
    mt = gemv_tiles(m)
    att = mlp_attributes(mt, device)
    blocks = _build.sm_count(device) * att[5]
    ksb, rows_b = mlp_split(k, i_ff, n, att[4], blocks)
    items = i_ff // MLP_HIDDEN + -(-n // MLP_TILE) * ksb
    return mt, min(blocks, items), ksb, rows_b


def _mlp_act(g: torch.Tensor, act: str) -> torch.Tensor:
    """SiLU, or GELU's tanh form (jax.nn.gelu(approximate=True)), in f32."""
    return F.gelu(g, approximate="tanh") if act == "gelu" else F.silu(g)


def mlp_fused_plain(x2: torch.Tensor, w13: torch.Tensor, s13: torch.Tensor,
                    zp13: torch.Tensor, w2: torch.Tensor, s2: torch.Tensor,
                    zp2: torch.Tensor, xsum: Optional[torch.Tensor], act: str,
                    out_dtype) -> torch.Tensor:
    """x2 [M, K] bf16, w13 [K/2, 2 I] uint8 split-half codes of [w1 | w3]
    with s13 / zp13 [2 I] f32 / int32, w2 [I/2, N] uint8 with s2 / zp2 [N],
    xsum [M, 1] f32 (the row sums of x2; None: computed here) -> [M, N]
    (`_mlp_fused_kernel`): g | u = acc * s13 - xsum * (zp13 * s13) from the
    raw-code products in f32, h = bf16(act(g) * u); then per chunk of bkh
    packed w2 rows (the reference's: the first of 1024, 512, 256 dividing
    I/2) (h_lo . lo + h_hi . hi) * s2 - hsum * (zp2 * s2), hsum the chunk's
    f32 sum of both h slices, the chunks summed in f32 and rounded once.
    (The reference adds each chunk into the output in the output dtype;
    at f32 output the two are the same function.)"""
    i_ff = w13.shape[1] // 2
    ih = w2.shape[0]
    acc = _channel_plain(x2, w13, s13, zp13, xsum, torch.float32, 2)
    h = (_mlp_act(acc[:, :i_ff], act) * acc[:, i_ff:]).to(torch.bfloat16)
    lo, hi = (p.float() for p in code_planes(w2, 2))
    zs2 = zp2.float() * s2
    bkh = next(c for c in _BLOCKS if ih % c == 0)
    y = None
    for c in range(0, ih, bkh):
        hlo = h[:, c:c + bkh].float()
        hhi = h[:, ih + c:ih + c + bkh].float()
        part = hlo @ lo[c:c + bkh] + hhi @ hi[c:c + bkh]
        hsum = (hlo.sum(dim=1, keepdim=True) + hhi.sum(dim=1, keepdim=True))
        part = part * s2 - hsum * zs2
        y = part if y is None else y + part
    return y.to(out_dtype)


def mlp_fused(x2: torch.Tensor, w13: torch.Tensor, s13: torch.Tensor,
              zp13: torch.Tensor, w2: torch.Tensor, s2: torch.Tensor,
              zp2: torch.Tensor, xsum: Optional[torch.Tensor], act: str,
              out_dtype) -> torch.Tensor:
    """Kernel wrapper; see `mlp_fused_plain` for the function (xsum None:
    the kernel sums the rows of x2 itself)."""
    if not x2.is_cuda:
        return mlp_fused_plain(x2, w13, s13, zp13, w2, s2, zp2, xsum, act,
                               out_dtype)
    _build.no_grad("mlp_fused", "13", x2, s13, zp13, s2, zp2)
    name = "mlp_fused"
    m, k = x2.shape
    i_ff, n = w13.shape[1] // 2, w2.shape[1]
    _check(name, out_dtype in (torch.bfloat16, torch.float32), TypeError,
           f"out dtype {out_dtype} not supported")
    _check(name, act in ("silu", "gelu"), ValueError, f"act {act!r}")
    _check(name, x2.dtype == torch.bfloat16 and w13.dtype == torch.uint8
           and w2.dtype == torch.uint8
           and all(t is None or t.dtype == torch.float32
                   for t in (s13, s2, xsum))
           and zp13.dtype == torch.int32 and zp2.dtype == torch.int32,
           TypeError, "x bf16, uint8 codes, f32 scales and xsum, int32 zero "
                      "points expected")
    _check(name, w13.shape[0] * 2 == k and w2.shape[0] * 2 == i_ff
           and w13.shape[1] % 2 == 0 and k % 256 == 0 and i_ff % 256 == 0
           and n % _COLS == 0 and 0 < m <= M_MAX,
           what=f"unsupported shape m={m} k={k} i_ff={i_ff} n={n}")
    _check(name, s13.numel() == zp13.numel() == 2 * i_ff
           and s2.numel() == zp2.numel() == n
           and (xsum is None or xsum.numel() == m),
           what="s13 / zp13 [2 I], s2 / zp2 [N], xsum [M, 1]")
    _check_operands(name, x2, w13, s13, zp13, w2, s2, zp2, xsum)
    _, blocks, ksb, rows_b = mlp_plan(x2.device.index, m, k, i_ff, n)
    out = torch.empty((m, n), dtype=out_dtype, device=x2.device)
    h = torch.empty((m, i_ff), dtype=torch.bfloat16, device=x2.device)
    part_b = torch.empty((ksb, m, n), dtype=torch.float32, device=x2.device)
    state = _build.tickets(x2.device, 2 + -(-n // MLP_TILE) + ksb)
    err = _build.library().pq_mlp_fused(
        x2.data_ptr(), w13.data_ptr(), s13.data_ptr(), zp13.data_ptr(),
        w2.data_ptr(), s2.data_ptr(), zp2.data_ptr(),
        None if xsum is None else xsum.data_ptr(), out.data_ptr(),
        h.data_ptr(), part_b.data_ptr(), state.data_ptr(), m, k, i_ff, n,
        ksb, rows_b, blocks, int(act == "gelu"),
        int(out_dtype == torch.bfloat16), _build.stream_ptr(x2))
    _build.check(err, name)
    mlp_fused.launches += 1
    return out


mlp_fused.launches = 0


def _channelwise_int4(ql) -> bool:
    return (getattr(ql, "bits", None) == 4 and ql.group_size is None
            and getattr(ql, "codebook", None) is None)


def mlp_fused_matmul(x: torch.Tensor, w13, w2, act: str,
                     out_dtype=torch.bfloat16) -> Optional[torch.Tensor]:
    """The decode-M gated MLP x [..., K] -> [..., N] through mlp_fused, or
    None where the reference's `mlp_fused_matmul` declines: the switch
    PIQUANT_MLP_FUSE=1 is off (read at call time), either weight is not
    channelwise INT4, M > M_MAX, w13.n is odd, the weights' K do not chain,
    no block size of 1024 / 512 / 256 divides I, N or I/2, K % 256 or
    I % 256.  The reference's VMEM budget (PIQUANT_QMM_VMEM_MB) is a TPU
    tile limit and is dropped."""
    if os.environ.get("PIQUANT_MLP_FUSE", "0") != "1":
        return None
    if not (_channelwise_int4(w13) and _channelwise_int4(w2)):
        return None
    lead, k = x.shape[:-1], x.shape[-1]
    m = 1
    for d in lead:
        m *= d
    if m > M_MAX or w13.n % 2:
        return None
    i_ff, n = w13.n // 2, w2.n
    if w2.k != i_ff or w13.k != k:
        return None
    if (any(all(v % c for c in _BLOCKS) for v in (i_ff, n, i_ff // 2))
            or k % 256 or i_ff % 256):
        return None
    x2 = x.reshape(m, k).to(torch.bfloat16).contiguous()

    def side(ql):
        return (ql.scale.float().reshape(-1).expand(ql.n).contiguous(),
                ql.zero_point.to(torch.int32).reshape(-1).expand(ql.n)
                .contiguous())

    y = mlp_fused(x2, w13.data, *side(w13), w2.data, *side(w2), None, act,
                  out_dtype)
    return y.reshape(*lead, n)
