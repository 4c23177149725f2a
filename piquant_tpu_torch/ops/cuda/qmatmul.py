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

Each wrapper launches its hand-written kernel (the first six are one
template in csrc/qmatmul_gemv.cu, the int8-x GEMMs one template in
csrc/qmatmul_a8.cu) on CUDA tensors, counts the launch in `.launches`, and
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

from typing import List, Optional

import torch

from piquant_tpu_torch.ops.cuda import _build

M_MAX = 64        # decode-sized M; larger M takes the dequant matmul path
_COLS = 128       # output columns per block (csrc/qmatmul_gemv.cu)
_MT = 8           # x rows per block
PLANES = {2: 4, 4: 2, 8: 1}   # codes per byte by bit width


def code_planes(data: torch.Tensor, planes: int) -> List[torch.Tensor]:
    """uint8 [K/P, N] -> the P code planes (plane p holds code rows
    p*K/P .. (p+1)*K/P - 1 in bits [p*8/P, (p+1)*8/P))."""
    bits = 8 // planes
    mask = (1 << bits) - 1
    return [(data >> (bits * p)) & mask for p in range(planes)]


def split_k(m: int, k: int, n: int, sms: int, planes: int = 2,
            align: int = 8):
    """(ksplit, rows per split): split the K/planes packed rows over blocks
    up to four blocks per SM (so the grid is about one wave), keeping >= 64
    packed rows a split and each split a multiple of `align` rows (whole
    groups for grouped weights)."""
    total = k // planes
    blocks = (n // _COLS) * -(-m // _MT)
    want = max(1, 4 * sms // blocks)
    ksplit = max(1, min(want, total // 64))
    rows = -(-total // ksplit)
    rows += -rows % align
    return -(-total // rows), rows


def _check(name: str, ok: bool, err=ValueError, what: str = "") -> None:
    if not ok:
        raise err(f"{name}: {what}")


def _check_operands(name: str, x2: torch.Tensor, *rest) -> None:
    for t in (x2,) + rest:
        _check(name, t is None or (t.is_contiguous() and t.device == x2.device
                                   and t.data_ptr() % 16 == 0),
               what="operands must be contiguous, 16-byte aligned and on "
                    "one device")


def _launch(name: str, entry: str, x2: torch.Tensor, data: torch.Tensor,
            side: tuple, ints: tuple, planes: int, align: int,
            out_dtype, x_dtype=torch.bfloat16) -> torch.Tensor:
    """Shared checks, scratch and launch of the GEMV entry points (a None
    in `side` passes a null pointer)."""
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
    ksplit, rows = split_k(m, k, n, _build.sm_count(x2.device.index), planes,
                           align)
    out = torch.empty((m, n), dtype=out_dtype, device=x2.device)
    partial = (torch.empty((ksplit, m, n), dtype=torch.float32,
                           device=x2.device) if ksplit > 1 else out)
    err = getattr(_build.library(), entry)(
        x2.data_ptr(), data.data_ptr(),
        *(None if t is None else t.data_ptr() for t in side),
        out.data_ptr(), partial.data_ptr(), m, k, n, *ints, ksplit, rows,
        int(out_dtype == torch.bfloat16), _build.stream_ptr(x2))
    _build.check(err, name)
    return out


# ---------------------------------------------------------------------------
# channelwise: w4_gemv, w8_gemv, w2_gemv
# ---------------------------------------------------------------------------

def _channel_plain(x2, data, scale, zp, xsum, out_dtype, planes):
    """The P plane products of the raw codes with f32 accumulation, then
    acc * scale - xsum * (zp * scale)."""
    rows = data.shape[0]
    acc = None
    for p, plane in enumerate(code_planes(data, planes)):
        part = x2[:, p * rows:(p + 1) * rows].float() @ plane.float()
        acc = part if acc is None else acc + part
    return (acc * scale - xsum * (zp.float() * scale)).to(out_dtype)


def w4_gemv_plain(x2: torch.Tensor, data: torch.Tensor, scale: torch.Tensor,
                  zp: torch.Tensor, xsum: torch.Tensor,
                  out_dtype) -> torch.Tensor:
    """x2 [M, K] bf16, data [K/2, N] uint8, scale [N] f32, zp [N] int32,
    xsum [M, 1] f32 -> [M, N]: the two nibble-plane products with f32
    accumulation, then acc * scale - xsum * (zp * scale)."""
    return _channel_plain(x2, data, scale, zp, xsum, out_dtype, 2)


def w8_gemv_plain(x2, data, scale, zp, xsum, out_dtype) -> torch.Tensor:
    """As w4_gemv_plain for INT8 codes data [K, N] (`_w8_kernel`)."""
    return _channel_plain(x2, data, scale, zp, xsum, out_dtype, 1)


def w2_gemv_plain(x2, data, scale, zp, xsum, out_dtype) -> torch.Tensor:
    """As w4_gemv_plain for split-quarter INT2 data [K/4, N]: four plane
    products (`_w2_kernel`)."""
    return _channel_plain(x2, data, scale, zp, xsum, out_dtype, 4)


def _channel(name, entry, planes, x2, data, scale, zp, xsum, out_dtype):
    _check(name, scale.dtype == torch.float32 and zp.dtype == torch.int32
           and xsum.dtype == torch.float32, TypeError,
           "scale f32, zp int32, xsum f32 expected")
    n = data.shape[1]
    _check(name, scale.numel() == n and zp.numel() == n
           and xsum.numel() == x2.shape[0], what="scale/zp [N], xsum [M, 1]")
    return _launch(name, entry, x2, data, (scale, zp, xsum), (), planes, 8,
                   out_dtype)


def w4_gemv(x2: torch.Tensor, data: torch.Tensor, scale: torch.Tensor,
            zp: torch.Tensor, xsum: torch.Tensor, out_dtype) -> torch.Tensor:
    """Kernel wrapper; see `w4_gemv_plain` for the function."""
    if not x2.is_cuda:
        return w4_gemv_plain(x2, data, scale, zp, xsum, out_dtype)
    out = _channel("w4_gemv", "pq_w4_gemv", 2, x2, data, scale, zp, xsum,
                   out_dtype)
    w4_gemv.launches += 1
    return out


def w8_gemv(x2, data, scale, zp, xsum, out_dtype) -> torch.Tensor:
    """Kernel wrapper; see `w8_gemv_plain` for the function."""
    if not x2.is_cuda:
        return w8_gemv_plain(x2, data, scale, zp, xsum, out_dtype)
    out = _channel("w8_gemv", "pq_w8_gemv", 1, x2, data, scale, zp, xsum,
                   out_dtype)
    w8_gemv.launches += 1
    return out


def w2_gemv(x2, data, scale, zp, xsum, out_dtype) -> torch.Tensor:
    """Kernel wrapper; see `w2_gemv_plain` for the function."""
    if not x2.is_cuda:
        return w2_gemv_plain(x2, data, scale, zp, xsum, out_dtype)
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
    name = "wg_chunk"
    planes = x2.shape[1] // data.shape[0]
    _grouped_shape(name, x2, data, s_chunk, z_chunk, gs, planes)
    _check(name, s_chunk.dtype == torch.bfloat16
           and z_chunk.dtype == torch.int8, TypeError,
           "s_chunk bf16, z_chunk int8 expected")
    _check(name, ch > 0 and (x2.shape[1] // planes // gs) % ch == 0,
           what=f"chunk factor {ch} does not divide the groups of a plane")
    if xs is not None:
        _check(name, xs.dtype == torch.float32, TypeError, "xs f32 expected")
        _check(name, xs.numel() == x2.shape[0], what="xs must be [M, 1]")
    out = _launch(name, "pq_wg_gemv", x2, data, (s_chunk, z_chunk, xs),
                  (gs, ch, planes), planes, gs, out_dtype,
                  torch.bfloat16 if xs is None else torch.int8)
    wg_chunk.launches += 1
    return out


def w4_grouped(x2, data, scale, zp, gs: int, out_dtype) -> torch.Tensor:
    """Kernel wrapper; see `w4_grouped_plain` for the function."""
    if not x2.is_cuda:
        return w4_grouped_plain(x2, data, scale, zp, gs, out_dtype)
    name = "w4_grouped"
    _check(name, x2.shape[1] == 2 * data.shape[0],
           what="split-half INT4 codes expected")
    _grouped_shape(name, x2, data, scale, zp, gs, 2)
    _check(name, scale.dtype == torch.float32 and zp.dtype == torch.int32,
           TypeError, "scale f32, zp int32 expected")
    out = _launch(name, "pq_w4g_gemv", x2, data, (scale, zp), (gs,), 2, gs,
                  out_dtype)
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
    name = "nf4_gemv"
    k, n = x2.shape[1], data.shape[1]
    _check(name, x2.shape[1] == 2 * data.shape[0],
           what="split-half NF4 codes expected")
    _check(name, scale.dtype == torch.float32, TypeError, "scale f32 expected")
    if gs:
        _grouped_shape(name, x2, data, scale, scale, gs, 2)
    else:
        _check(name, scale.numel() == n, what="scale must be [N]")
    out = _launch(name, "pq_nf4_gemv", x2, data, (scale,), (gs,), 2,
                  gs or 8, out_dtype)
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
    xsum = x2.float().sum(dim=1, keepdim=True)
    scale = ql.scale.float().reshape(-1).expand(n).contiguous()
    zp = ql.zero_point.to(torch.int32).reshape(-1).expand(n).contiguous()
    gemv = {4: w4_gemv, 8: w8_gemv, 2: w2_gemv}[ql.bits]
    return gemv(x2, ql.data, scale, zp, xsum, out_dtype).reshape(*lead, n)


# ---------------------------------------------------------------------------
# int8 activations: w4a8, w8a8, w2a8 (csrc/qmatmul_a8.cu)
# ---------------------------------------------------------------------------

_A8_COLS = 128    # output columns per block (csrc/qmatmul_a8.cu)
_A8_ROWS = 32     # packed rows per pipeline step


def a8_split(m: int, k: int, n: int, sms: int, planes: int):
    """(output rows per block, ksplit, packed rows per split): blocks of 16
    rows at decode batch, 64 up to M_MAX, 128 at prefill M; K is split
    over blocks when the output tiles are fewer than one wave (prefill
    tiles) or four blocks an SM (decode tiles), keeping >= 128 packed rows
    a split, each a multiple of the 32-row pipeline step."""
    bm = 16 if m <= 16 else 64 if m <= M_MAX else 128
    rows = k // planes
    blocks = (n // _A8_COLS) * -(-m // bm)
    want = max(1, (sms if bm == 128 else 4 * sms) // blocks)
    ksplit = max(1, min(want, rows // 128))
    per = -(-rows // ksplit)
    per += -per % _A8_ROWS
    return bm, -(-rows // per), per


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
    out = _a8("w4a8", "pq_w4a8", 2, xq, xs, data, scale, zs, xsum, out_dtype)
    w4a8.launches += 1
    return out


def w8a8(xq, xs, data, scale, zs, xsum, out_dtype) -> torch.Tensor:
    """Kernel wrapper; see `w8a8_plain` for the function."""
    if not xq.is_cuda:
        return w8a8_plain(xq, xs, data, scale, zs, xsum, out_dtype)
    out = _a8("w8a8", "pq_w8a8", 1, xq, xs, data, scale, zs, xsum, out_dtype)
    w8a8.launches += 1
    return out


def w2a8(xq, xs, data, scale, zs, xsum, out_dtype) -> torch.Tensor:
    """Kernel wrapper; see `w2a8_plain` for the function."""
    if not xq.is_cuda:
        return w2a8_plain(xq, xs, data, scale, zs, xsum, out_dtype)
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
