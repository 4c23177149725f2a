"""Multi-head Latent Attention, DeepSeek-V2 style (counterpart of
piquant_tpu/models/mla.py), with an INT8 or INT4 quantized LATENT cache.

MLA compresses each position's K/V into one rank-R latent vector
(`kv_a`) plus a small rope key shared by the heads.  Decode never builds
per-head K/V: it ABSORBS the up-projection `kv_b` into the query and
output sides,

    q_nope[h] . k_nope[h,s] = (W_k[h] q_nope[h]) . c_s        (scores)
    sum_s p[s] v[h,s]       = W_v[h]^T (sum_s p[s] c_s)       (output)

so decode attention reads only the latent cache: R + rope_dim values a
position (DeepSeek-V2-Lite at kv8: 512 + 4 + 128 = 644 bytes a position
and layer).  The latent is per-token symmetric INT8 (or pair-packed INT4)
with the KV cache's scheme (`quant/kv_cache.py::_quantize_sym`), and the
projections take QuantizedLinear weights through `quantized_matmul`.

Parameters are a plain dict of tensors / QuantizedLinear /
QuantizedExpertStack (the reference pytree's layout); the functions take
an explicit config, draw random numbers from a `torch.Generator`, and run
on the GPU unless a `device` says otherwise.  The latent attention is
plain PyTorch with the reference's roundings: operands it casts to bf16
are rounded to bf16, products accumulate in f32, and the result is cast
where the reference casts it.  Masks are additive -1e9, as there.

Rope: DeepSeek-V2 rotates interleaved (even, odd) pairs, as
`models/llama.py::apply_rope` does, so `params_from_hf` permutes no
columns; YaRN's attention factor scales cos and sin.

Scope: the dense-MLP geometry (V2-Lite as `v2_lite_config` builds it)
and MoE-MLA (routed experts by the `greedy`, `group_limited_greedy` or
`noaux_tc` router, shared experts, `first_k_dense` dense layers), every
routed expert on every token, as the reference's scan runs them.  Not
ported yet: expert parallelism and `param_shardings` (ROADMAP.md queue 1
item 16b), LoRA projections (item 13).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from piquant_tpu_torch._device import DeviceLike, resolve_device
from piquant_tpu_torch.models.llama import _expert_weight
from piquant_tpu_torch.models.llama import _mm as _llama_mm
from piquant_tpu_torch.models.llama import apply_rope, rms_norm
from piquant_tpu_torch.models.loader import _Fields
from piquant_tpu_torch.quant.kv_cache import _quantize_sym, unpack4
from piquant_tpu_torch.quant.linear import (
    QuantizedExpertStack,
    QuantizedLinear,
    quantize_linear_weight,
)


@dataclasses.dataclass(frozen=True)
class YarnParams:
    """YaRN rope scaling (DeepSeek-V2's long-context recipe): the
    interpolated and extrapolated inverse frequencies mixed by a linear
    ramp, and an attention factor from mscale / mscale_all_dim that
    multiplies cos and sin (transformers' _compute_yarn_parameters)."""

    factor: float = 1.0
    original_max_position_embeddings: int = 4096
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 0.0


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    vocab_size: int = 102_400
    d_model: int = 5120
    n_layers: int = 60
    n_heads: int = 128
    d_ff: int = 12_288
    kv_lora_rank: int = 512
    q_lora_rank: Optional[int] = None   # None: one q projection (V2-Lite)
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 10_000.0
    rms_eps: float = 1e-6
    max_seq_len: int = 4096
    dtype: Any = torch.bfloat16
    # DeepSeek-MoE: routed experts and always-on shared experts; layers
    # below first_k_dense keep the dense MLP
    n_experts: int = 0                  # 0: dense MLP everywhere
    moe_top_k: int = 6
    moe_d_ff: int = 0                   # a routed expert's hidden size
    n_shared_experts: int = 0           # shared MLP hidden: n * moe_d_ff
    first_k_dense: int = 1
    routed_scaling: float = 1.0
    norm_topk_prob: bool = False
    # "greedy", "group_limited_greedy" (only the topk_group groups of the
    # highest per-group max stay eligible) or "noaux_tc" (DeepSeek-V3)
    topk_method: str = "greedy"
    n_group: int = 1
    topk_group: int = 1
    # expert parallelism: not ported yet (set, _mlp raises)
    ep_axis: Optional[str] = None
    yarn: Optional[YarnParams] = None
    kv_bits: int = 8                    # latent code width: 8 or 4

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    def moe_layer(self, li: int) -> bool:
        return self.n_experts > 0 and li >= self.first_k_dense

    @staticmethod
    def tiny(vocab: int = 256, **kw) -> "MLAConfig":
        return MLAConfig(
            vocab_size=vocab, d_model=128, n_layers=2, n_heads=4, d_ff=256,
            kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
            v_head_dim=16, max_seq_len=128, **kw)

    @staticmethod
    def tiny_moe(vocab: int = 256, **kw) -> "MLAConfig":
        """Tiny DeepSeek-V2 geometry: MoE-MLA with YaRN."""
        kw.setdefault("yarn", YarnParams(
            factor=4.0, original_max_position_embeddings=32,
            mscale=0.707, mscale_all_dim=0.707))
        return MLAConfig.tiny(
            vocab=vocab, n_experts=4, moe_top_k=2, moe_d_ff=96,
            n_shared_experts=2, first_k_dense=1, routed_scaling=1.0,
            norm_topk_prob=False, **kw)


def v2_lite_config(**kw) -> MLAConfig:
    """DeepSeek-V2-Lite's attention geometry with a dense MLP (the real
    model is MoE; d_ff 10944 is its dense layer's width)."""
    return MLAConfig(
        vocab_size=102_400, d_model=2048, n_layers=27, n_heads=16,
        d_ff=10_944, kv_lora_rank=512, q_lora_rank=None,
        qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
        rope_theta=10_000.0, max_seq_len=4096, **kw)


# ---------------------------------------------------------------------------
# the latent cache: INT8 (or pair-packed INT4) c and a bf16 rope key
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LatentKVCache:
    """Stacked per-layer latent cache; batch on axis 1 of every leaf (the
    engine's slot copies rely on it):

    c_codes: [L, B, S, R] int8, or [L, B, S, R/2] uint8 pack4'ed (kv4):
             per-token symmetric codes of the normed latent;
    c_scale: [L, B, S, 1] f32;
    k_pe:    [L, B, S, rope_dim] bf16, after rope;
    length:  [L, B] int32.

    The forwards write it in place and return it."""

    c_codes: torch.Tensor
    c_scale: torch.Tensor
    k_pe: torch.Tensor
    length: torch.Tensor

    @property
    def max_len(self) -> int:
        return self.c_codes.shape[2]

    @property
    def bits(self) -> int:
        return 4 if self.c_codes.dtype == torch.uint8 else 8

    def tensors(self):
        return (self.c_codes, self.c_scale, self.k_pe, self.length)


def init_latent_cache(cfg: MLAConfig, batch: int, max_len: int, *,
                      device: DeviceLike = None) -> LatentKVCache:
    """An empty latent cache (unit scales).  kv4 codes are pack4'ed along
    R, so it needs an even kv_lora_rank."""
    if cfg.kv_bits == 4 and cfg.kv_lora_rank % 2:
        raise ValueError(
            f"kv_bits=4 needs an even kv_lora_rank, got {cfg.kv_lora_rank}")
    dev = resolve_device(device)
    kv4 = cfg.kv_bits == 4
    lead = (cfg.n_layers, batch, max_len)
    return LatentKVCache(
        c_codes=torch.zeros(lead + (cfg.kv_lora_rank // (2 if kv4 else 1),),
                            dtype=torch.uint8 if kv4 else torch.int8,
                            device=dev),
        c_scale=torch.ones(lead + (1,), dtype=torch.float32, device=dev),
        k_pe=torch.zeros(lead + (cfg.qk_rope_head_dim,),
                         dtype=torch.bfloat16, device=dev),
        length=torch.zeros((cfg.n_layers, batch), dtype=torch.int32,
                           device=dev))


def init_kv_cache(cfg: MLAConfig, batch: int,
                  max_len: Optional[int] = None, *,
                  device: DeviceLike = None) -> LatentKVCache:
    return init_latent_cache(cfg, batch, max_len or cfg.max_seq_len,
                             device=device)


def copy_cache_rows(dst: LatentKVCache, src: LatentKVCache,
                    rows: torch.Tensor, n: Optional[int] = None
                    ) -> LatentKVCache:
    """Copy the first `n` positions (default: all) of `src` into batch rows
    `rows` of `dst`, with its lengths (at most `n`).  In place."""
    if dst.bits != src.bits:
        raise ValueError("caches of different code widths")
    s = src.max_len if n is None else n
    for big, small in zip(dst.tensors()[:3], src.tensors()[:3]):
        big[:, rows, :s] = small[:, :, :s]
    dst.length[:, rows] = torch.clamp(src.length, max=s)
    return dst


def _codes_f32(cc: torch.Tensor, bits: int) -> torch.Tensor:
    """Cache codes as the f32 operand of the latent products (the
    reference's bf16 codes: small integers, exact in both)."""
    if bits == 4:
        cc = unpack4(cc)
    return cc.float()


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def init_params(cfg: MLAConfig, seed: int = 0, *,
                device: DeviceLike = None) -> Dict:
    """Random float init (std 0.02, ones for the norms, a zero router bias
    for noaux_tc), from a seed, on the device."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = cfg.dtype

    def dense(din, dout):
        return (torch.randn((din, dout), generator=gen, device=dev)
                * 0.02).to(dt)

    def ones(n):
        return torch.ones(n, dtype=dt, device=dev)

    params: Dict[str, Any] = {
        "embed": dense(cfg.vocab_size, cfg.d_model),
        "final_norm": ones(cfg.d_model),
        "lm_head": dense(cfg.d_model, cfg.vocab_size),
        "layers": [],
    }
    h, qk, d = cfg.n_heads, cfg.qk_head_dim, cfg.d_model
    for li in range(cfg.n_layers):
        layer = {
            "attn_norm": ones(d), "mlp_norm": ones(d),
            "kv_a": dense(d, cfg.kv_lora_rank + cfg.qk_rope_head_dim),
            "kv_a_norm": ones(cfg.kv_lora_rank),
            "kv_b": dense(cfg.kv_lora_rank,
                          h * (cfg.qk_nope_head_dim + cfg.v_head_dim)),
            "wo": dense(h * cfg.v_head_dim, d),
        }
        if cfg.moe_layer(li):
            e, dff = cfg.n_experts, cfg.moe_d_ff
            layer["router"] = dense(d, e)
            if cfg.topk_method == "noaux_tc":
                layer["router_bias"] = torch.zeros(e, dtype=torch.float32,
                                                   device=dev)
            layer["moe_w1"] = torch.stack([dense(d, dff) for _ in range(e)])
            layer["moe_w3"] = torch.stack([dense(d, dff) for _ in range(e)])
            layer["moe_w2"] = torch.stack([dense(dff, d) for _ in range(e)])
            if cfg.n_shared_experts:
                sh = cfg.n_shared_experts * dff
                layer.update(shared_w1=dense(d, sh), shared_w3=dense(d, sh),
                             shared_w2=dense(sh, d))
        else:
            layer.update(w1=dense(d, cfg.d_ff), w3=dense(d, cfg.d_ff),
                         w2=dense(cfg.d_ff, d))
        if cfg.q_lora_rank is None:
            layer["wq"] = dense(d, h * qk)
        else:
            layer["wq_a"] = dense(d, cfg.q_lora_rank)
            layer["q_a_norm"] = ones(cfg.q_lora_rank)
            layer["wq_b"] = dense(cfg.q_lora_rank, h * qk)
        params["layers"].append(layer)
    return params


_MLA_QUANT_KEYS = ("wq", "wq_a", "wq_b", "kv_a", "kv_b", "wo",
                   "w1", "w2", "w3", "shared_w1", "shared_w2", "shared_w3")
_MLA_QUANT_STACKS = ("moe_w1", "moe_w2", "moe_w3")


def quantize_params(params: Dict, bits: int = 4, *,
                    group_size: Optional[int] = None) -> Dict:
    """Weight-only quantization of every projection (kv_b included; the
    absorbed path dequantizes it whole) and of each routed expert,
    restacked; norms, embedding, router and lm_head stay float."""
    out = dict(params)
    out["layers"] = []
    for layer in params["layers"]:
        ql = dict(layer)
        for k in _MLA_QUANT_KEYS:
            if k in layer:
                ql[k] = quantize_linear_weight(layer[k], bits,
                                               group_size=group_size)
        for k in _MLA_QUANT_STACKS:
            if k in layer:
                ql[k] = QuantizedExpertStack.stack(
                    [quantize_linear_weight(w, bits, group_size=group_size)
                     for w in layer[k]])
        out["layers"].append(ql)
    return out


def random_quantized_params(cfg: MLAConfig, seed: int = 0, bits=4,
                            lm_head_bits=None, *,
                            device: DeviceLike = None) -> Dict:
    """Quantized params built from random codes on the device, with the
    reference's scales and zero points (bits "nf4": an absmax scale of
    1/sqrt(K)); kv_b stays dense (the absorbed path splits it by head).
    Every layer takes the dense MLP, as in the reference."""
    for b in (bits, lm_head_bits):
        if b is not None and b not in (2, 4, 8, "nf4"):
            raise NotImplementedError(f"random {b}-bit weights: the port "
                                      "builds INT2, INT4, INT8 and NF4")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = cfg.dtype

    def qlin(din, dout, b=None):
        b = b if b is not None else bits
        codebook = "nf4" if b == "nf4" else None
        nb = 4 if codebook else b
        rows = {2: din // 4, 4: din // 2}.get(nb, din)
        data = torch.randint(0, 256, (rows, dout), generator=gen, device=dev,
                             dtype=torch.uint8)
        s0, z0 = ((1.0 / din ** 0.5, 0) if codebook else
                  (2.0 / ((1 << b) - 1) / din ** 0.5, 1 << (b - 1)))
        return QuantizedLinear(
            data=data,
            scale=torch.full((1, dout), s0, dtype=torch.float32, device=dev),
            zero_point=torch.full((1, dout), z0, dtype=torch.int32,
                                  device=dev),
            bits=nb, k=din, codebook=codebook)

    def dense(din, dout):
        return (torch.randn((din, dout), generator=gen, device=dev)
                * 0.02).to(dt)

    def ones(n):
        return torch.ones(n, dtype=dt, device=dev)

    h, qk, d = cfg.n_heads, cfg.qk_head_dim, cfg.d_model
    params: Dict[str, Any] = {
        "embed": dense(cfg.vocab_size, d),
        "final_norm": ones(d),
        "lm_head": (dense(d, cfg.vocab_size) if lm_head_bits is None
                    else qlin(d, cfg.vocab_size, lm_head_bits)),
        "layers": [],
    }
    for _ in range(cfg.n_layers):
        layer = {
            "attn_norm": ones(d), "mlp_norm": ones(d),
            "kv_a": dense(d, cfg.kv_lora_rank + cfg.qk_rope_head_dim),
            "kv_a_norm": ones(cfg.kv_lora_rank),
            "kv_b": dense(cfg.kv_lora_rank,
                          h * (cfg.qk_nope_head_dim + cfg.v_head_dim)),
            "wo": qlin(h * cfg.v_head_dim, d),
            "w1": qlin(d, cfg.d_ff), "w3": qlin(d, cfg.d_ff),
            "w2": qlin(cfg.d_ff, d),
        }
        if cfg.q_lora_rank is None:
            layer["wq"] = qlin(d, h * qk)
        else:
            layer["wq_a"] = qlin(d, cfg.q_lora_rank)
            layer["q_a_norm"] = ones(cfg.q_lora_rank)
            layer["wq_b"] = qlin(cfg.q_lora_rank, h * qk)
        params["layers"].append(layer)
    return params


def param_shardings(cfg: MLAConfig, params: Dict, tp_axis: str = "tp"):
    raise NotImplementedError("MLA tensor-parallel shardings are not ported "
                              "yet (ROADMAP.md queue 1 item 16b)")


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

def _mm(x: torch.Tensor, w, out_dtype) -> torch.Tensor:
    if type(w).__name__ in ("LoraLinear", "MultiLoraLinear"):
        raise NotImplementedError("LoRA projections are not ported yet "
                                  "(ROADMAP.md queue 1 item 13)")
    return _llama_mm(x, w, out_dtype)


def _ein(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum in f32 (the reference's preferred_element_type=float32): the
    callers round an operand to bf16 first where the reference does."""
    return torch.einsum(eq, a.float(), b.float())


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16)


def _w_dense(w) -> torch.Tensor:
    """kv_b is split by head for absorption: dequantized to bf16 whole
    when quantized (R x H*(nope+v) is small)."""
    return w.dequantize(torch.bfloat16) if isinstance(w, QuantizedLinear) \
        else w


def _yarn_inv_freq(cfg: MLAConfig, dev) -> Tuple[torch.Tensor, float]:
    """YaRN inverse frequencies and attention factor (transformers'
    _compute_yarn_parameters, as the reference derives them)."""
    y = cfg.yarn
    rd, base = cfg.qk_rope_head_dim, cfg.rope_theta
    pos_freqs = base ** (torch.arange(0, rd, 2, dtype=torch.float32,
                                      device=dev) / rd)
    inv_extra = 1.0 / pos_freqs
    inv_inter = 1.0 / (y.factor * pos_freqs)

    def corr_dim(n_rot):
        return ((rd * math.log(y.original_max_position_embeddings
                               / (n_rot * 2 * math.pi)))
                / (2 * math.log(base)))

    low = max(math.floor(corr_dim(y.beta_fast)), 0)
    high = min(math.ceil(corr_dim(y.beta_slow)), rd - 1)
    ramp = torch.clamp(
        (torch.arange(rd // 2, dtype=torch.float32, device=dev) - low)
        / max(high - low, 1e-3), 0.0, 1.0)
    extra = 1.0 - ramp
    inv = inv_inter * (1.0 - extra) + inv_extra * extra

    def mscale(scale, m=1.0):
        return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0

    if y.mscale and y.mscale_all_dim:
        att = mscale(y.factor, y.mscale) / mscale(y.factor, y.mscale_all_dim)
    else:
        att = mscale(y.factor)
    return inv, float(att)


def _rope(cfg: MLAConfig, positions: torch.Tensor):
    """cos / sin [..., rope_dim / 2] at `positions`; YaRN's attention
    factor scales both."""
    rd = cfg.qk_rope_head_dim
    dev = positions.device
    if cfg.yarn is not None:
        inv, att = _yarn_inv_freq(cfg, dev)
    else:
        inv = 1.0 / (cfg.rope_theta ** (
            torch.arange(0, rd, 2, dtype=torch.float32, device=dev) / rd))
        att = 1.0
    ang = positions[..., None].float() * inv
    return torch.cos(ang) * att, torch.sin(ang) * att


def _project_q(cfg: MLAConfig, layer: Dict, x: torch.Tensor, cos, sin):
    """x [B, T, D] -> q_nope [B, H, T, nope], q_pe [B, H, T, rope]."""
    b, t, _ = x.shape
    dt = cfg.dtype
    if "wq" in layer:
        q = _mm(x, layer["wq"], dt)
    else:
        qa = rms_norm(_mm(x, layer["wq_a"], dt), layer["q_a_norm"],
                      cfg.rms_eps)
        q = _mm(qa, layer["wq_b"], dt)
    q = q.reshape(b, t, cfg.n_heads, cfg.qk_head_dim).transpose(1, 2)
    q_nope = q[..., :cfg.qk_nope_head_dim]
    q_pe = apply_rope(q[..., cfg.qk_nope_head_dim:], cos, sin)
    return q_nope, q_pe


def _project_latent(cfg: MLAConfig, layer: Dict, x: torch.Tensor, cos, sin):
    """x [B, T, D] -> the normed latent c [B, T, R] and the shared rope key
    k_pe [B, T, rope] after rope."""
    ckv = _mm(x, layer["kv_a"], cfg.dtype)
    c = rms_norm(ckv[..., :cfg.kv_lora_rank], layer["kv_a_norm"],
                 cfg.rms_eps)
    k_pe = apply_rope(ckv[:, None, :, cfg.kv_lora_rank:], cos, sin)[:, 0]
    return c, k_pe


def _split_kv_b(cfg: MLAConfig, layer: Dict):
    """kv_b [R, H*(nope+v)] -> W_k [R, H, nope], W_v [R, H, v]."""
    wb = _w_dense(layer["kv_b"]).reshape(
        cfg.kv_lora_rank, cfg.n_heads, cfg.qk_nope_head_dim + cfg.v_head_dim)
    return wb[..., :cfg.qk_nope_head_dim], wb[..., cfg.qk_nope_head_dim:]


def _silu_mlp(cfg: MLAConfig, w1, w3, w2, x: torch.Tensor) -> torch.Tensor:
    dt = cfg.dtype
    g = _mm(x, w1, dt)
    u = _mm(x, w3, dt)
    return _mm((F.silu(g.float()) * u.float()).to(dt), w2, dt)


def _group_limit(cfg: MLAConfig, choice: torch.Tensor,
                 group_score: torch.Tensor) -> torch.Tensor:
    """Zero the experts outside the topk_group best groups."""
    per = choice.shape[-1] // cfg.n_group
    gi = torch.topk(group_score, cfg.topk_group, dim=-1).indices
    gmask = F.one_hot(gi, cfg.n_group).sum(dim=-2)           # [B, T, G]
    keep = gmask.repeat_interleave(per, dim=-1) > 0
    return torch.where(keep, choice, 0.0)


def _route(cfg: MLAConfig, layer: Dict, x: torch.Tensor):
    """The router: f32 logits -> (gate weights [B, T, k] f32, expert ids
    [B, T, k]), by softmax scores (greedy, group_limited_greedy) or the
    sigmoid scores with a selection-only bias (noaux_tc)."""
    logits = x.float() @ layer["router"].float()
    bsz, t, e = logits.shape
    if cfg.n_group > 1 and e % cfg.n_group:
        raise ValueError(f"n_experts={e} not divisible by "
                         f"n_group={cfg.n_group}")
    per = e // cfg.n_group
    if cfg.topk_method == "noaux_tc":
        scores = torch.sigmoid(logits)
        choice = scores + layer["router_bias"].float()
        if cfg.n_group > 1:
            grp = choice.reshape(bsz, t, cfg.n_group, per)
            gscore = torch.topk(grp, 2, dim=-1).values.sum(dim=-1)
            choice = _group_limit(cfg, choice, gscore)
        topi = torch.topk(choice, cfg.moe_top_k, dim=-1).indices
        probs = torch.gather(scores, -1, topi)
        if cfg.norm_topk_prob:
            probs = probs / (probs.sum(dim=-1, keepdim=True) + 1e-20)
    else:
        scores = torch.softmax(logits, dim=-1)
        if cfg.topk_method == "group_limited_greedy" and cfg.n_group > 1:
            gmax = scores.reshape(bsz, t, cfg.n_group, per).amax(dim=-1)
            scores = _group_limit(cfg, scores, gmax)
        probs, topi = torch.topk(scores, cfg.moe_top_k, dim=-1)
        if cfg.norm_topk_prob:
            probs = probs / probs.sum(dim=-1, keepdim=True)
    return probs * cfg.routed_scaling, topi


def _mlp(cfg: MLAConfig, layer: Dict, x: torch.Tensor) -> torch.Tensor:
    """The dense MLP, or DeepSeek-MoE: every routed expert on every token
    weighted by its gate (zero where unpicked) into an f32 sum in expert
    order, as the reference's scan adds them, then the shared experts."""
    if "router" not in layer:
        return _silu_mlp(cfg, layer["w1"], layer["w3"], layer["w2"], x)
    if cfg.ep_axis is not None:
        raise NotImplementedError("MLA expert parallelism (ep_axis) is not "
                                  "ported yet (ROADMAP.md queue 1 item 16b)")
    probs, topi = _route(cfg, layer, x)
    w1s, w3s, w2s = layer["moe_w1"], layer["moe_w3"], layer["moe_w2"]
    n_e = (w1s.n_experts if isinstance(w1s, QuantizedExpertStack)
           else w1s.shape[0])
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for e in range(n_e):
        gate = torch.where(topi == e, probs, 0.0).sum(dim=-1, keepdim=True)
        h = _silu_mlp(cfg, _expert_weight(w1s, e), _expert_weight(w3s, e),
                      _expert_weight(w2s, e), x)
        y = y + h.float() * gate
    if "shared_w1" in layer:
        y = y + _silu_mlp(cfg, layer["shared_w1"], layer["shared_w3"],
                          layer["shared_w2"], x).float()
    return y.to(cfg.dtype)


def _causal_mask(kv_len: int, positions: torch.Tensor) -> torch.Tensor:
    """Additive [B, 1, T, kv_len] f32: 0 where the cache position <= the
    query's, -1e9 elsewhere."""
    kv_pos = torch.arange(kv_len, device=positions.device)
    return torch.where(kv_pos[None, None, None, :]
                       <= positions[:, None, :, None], 0.0, -1e9)


def _absorbed_attention(cfg: MLAConfig, cache: LatentKVCache, li: int,
                        q_nope: torch.Tensor, q_pe: torch.Tensor,
                        w_k: torch.Tensor, w_v: torch.Tensor, w: int,
                        mask: torch.Tensor) -> torch.Tensor:
    """Attention of q [B, H, T, *] over layer li's first w cached latents
    -> context [B, T, H * v] in the model dtype: the query moved into
    latent space through W_k, scores against the codes times their scales
    plus the rope scores, the context taken in latent space and moved out
    through W_v."""
    b, _, t, _ = q_nope.shape
    q_lat = _ein("bhtn,rhn->bhtr", _bf16(q_nope), w_k)
    cc = _codes_f32(cache.c_codes[li, :, :w], cfg.kv_bits)    # [B, w, R]
    cs = cache.c_scale[li, :, :w, 0][:, None, None]           # [B,1,1,w]
    scores = (_ein("bhtr,bsr->bhts", _bf16(q_lat), cc) * cs
              + _ein("bhtr,bsr->bhts", _bf16(q_pe), cache.k_pe[li, :, :w])
              ) * cfg.qk_head_dim ** -0.5 + mask
    probs = torch.softmax(scores, dim=-1)
    ctx_lat = _ein("bhts,bsr->bhtr", _bf16(probs * cs), cc)
    ctx = _ein("bhtr,rhv->bhtv", _bf16(ctx_lat), w_v)
    return ctx.to(cfg.dtype).transpose(1, 2).reshape(
        b, t, cfg.n_heads * cfg.v_head_dim)


def _write_latents(cache: LatentKVCache, li: int, c: torch.Tensor,
                   k_pe: torch.Tensor, bits: int, rows, cols) -> None:
    """Quantize the latents c [B, T, R] (per-token symmetric INT8 or
    pack4'ed INT4: the KV cache's scheme) and write them and k_pe at cache
    [li, rows, cols], in place."""
    codes, cscale = _quantize_sym(c, bits)
    cache.c_codes[li, rows, cols] = codes
    cache.c_scale[li, rows, cols] = cscale
    cache.k_pe[li, rows, cols] = k_pe.to(torch.bfloat16)


def _lm_head(cfg: MLAConfig, params: Dict, x: torch.Tensor) -> torch.Tensor:
    return _mm(rms_norm(x, params["final_norm"], cfg.rms_eps),
               params["lm_head"], torch.float32)


def _embed(cfg: MLAConfig, params: Dict, tokens: torch.Tensor):
    return params["embed"][tokens.long()].to(cfg.dtype)


def _block(cfg: MLAConfig, layer: Dict, x: torch.Tensor, attend):
    """One layer: x + attention(norm(x)) (`attend(hx)` -> the context),
    through wo, then x + MLP(norm(x))."""
    hx = rms_norm(x, layer["attn_norm"], cfg.rms_eps)
    x = x + _mm(attend(hx), layer["wo"], cfg.dtype)
    return x + _mlp(cfg, layer, rms_norm(x, layer["mlp_norm"], cfg.rms_eps))


# ---------------------------------------------------------------------------
# forwards
# ---------------------------------------------------------------------------

def forward(cfg: MLAConfig, params: Dict, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None,
            cache: Optional[LatentKVCache] = None,
            logit_positions: Optional[torch.Tensor] = None,
            ) -> Tuple[torch.Tensor, Optional[LatentKVCache]]:
    """The full forward (prefill): materialized per-head K/V attention,
    the HF DeepseekV2 data flow, causal over the sequence; writes the
    latent cache's positions [0, T) when given one (it is not read).
    Returns (logits [B, T, V] f32, or [B, V] at `logit_positions` [B],
    and the cache)."""
    b, t = tokens.shape
    dt = cfg.dtype
    dev = tokens.device
    if positions is None:
        positions = torch.arange(t, dtype=torch.int32, device=dev).expand(b, t)
    x = _embed(cfg, params, tokens)
    cos, sin = _rope(cfg, positions)
    ar = torch.arange(t, device=dev)
    mask = torch.where(ar[None, :] <= ar[:, None], 0.0, -1e9)[None, None]
    scale = cfg.qk_head_dim ** -0.5

    for li, layer in enumerate(params["layers"]):
        def attend(hx):
            q_nope, q_pe = _project_q(cfg, layer, hx, cos, sin)
            c, k_pe = _project_latent(cfg, layer, hx, cos, sin)
            w_k, w_v = _split_kv_b(cfg, layer)
            # per-head K/V built (prefill is compute-bound; absorption
            # saves decode's bandwidth)
            k_nope = _ein("btr,rhn->bhtn", _bf16(c), w_k).to(dt)
            v = _ein("btr,rhv->bhtv", _bf16(c), w_v).to(dt)
            scores = (_ein("bhtn,bhsn->bhts", _bf16(q_nope), _bf16(k_nope))
                      + _ein("bhtr,bsr->bhts", _bf16(q_pe), _bf16(k_pe))
                      ) * scale + mask
            probs = torch.softmax(scores, dim=-1)
            ctx = _ein("bhts,bhsv->bhtv", _bf16(probs), v)
            if cache is not None:
                _write_latents(cache, li, c, k_pe, cfg.kv_bits,
                               slice(None), slice(0, t))
            return ctx.to(dt).transpose(1, 2).reshape(
                b, t, cfg.n_heads * cfg.v_head_dim)

        x = _block(cfg, layer, x, attend)

    if logit_positions is not None:
        # the lm_head only at the requested positions
        x = x[torch.arange(b, device=dev), logit_positions.long()]
    logits = _lm_head(cfg, params, x)
    if cache is not None:
        cache.length += t
    return logits, cache


def prefill(cfg: MLAConfig, params: Dict, tokens: torch.Tensor,
            cache: LatentKVCache,
            last_positions: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, LatentKVCache]:
    """The engine's prefill: fills the latent cache and returns logits
    [B, V] at `last_positions` (default: the final position)."""
    b, t = tokens.shape
    if last_positions is None:
        last_positions = torch.full((b,), t - 1, dtype=torch.int32,
                                    device=tokens.device)
    return forward(cfg, params, tokens, cache=cache,
                   logit_positions=last_positions)


def forward_chunk(cfg: MLAConfig, params: Dict, tokens: torch.Tensor,
                  positions: torch.Tensor, cache: LatentKVCache,
                  last_positions: torch.Tensor, kv_write_start: int,
                  attn_window: Optional[int] = None
                  ) -> Tuple[torch.Tensor, LatentKVCache]:
    """Chunked prefill through the ABSORBED path: the chunk's latents are
    written at [start, start + T) for the whole batch (one start: the
    reference's offset[0]; clamped so the chunk fits, as its
    dynamic_update_slice clamps), then attention reads the latent cache,
    so the chunk sees its own latents quantized.  Returns (logits [B, V]
    at `last_positions`, the cache)."""
    b, t = tokens.shape
    st = int(kv_write_start)
    w = min(attn_window or cache.max_len, cache.max_len)
    x = _embed(cfg, params, tokens)
    cos, sin = _rope(cfg, positions)
    mask = _causal_mask(w, positions)
    st_c = max(0, min(st, cache.max_len - t))

    for li, layer in enumerate(params["layers"]):
        def attend(hx):
            q_nope, q_pe = _project_q(cfg, layer, hx, cos, sin)
            c, k_pe = _project_latent(cfg, layer, hx, cos, sin)
            _write_latents(cache, li, c, k_pe, cfg.kv_bits, slice(None),
                           slice(st_c, st_c + t))
            w_k, w_v = _split_kv_b(cfg, layer)
            return _absorbed_attention(cfg, cache, li, q_nope, q_pe, w_k, w_v,
                                       w, mask)

        x = _block(cfg, layer, x, attend)

    x = x[torch.arange(b, device=x.device), last_positions.long()]
    logits = _lm_head(cfg, params, x)
    torch.clamp(cache.length, min=st + t, out=cache.length)
    return logits, cache


def decode_step(cfg: MLAConfig, params: Dict, token: torch.Tensor,
                position: torch.Tensor, cache: LatentKVCache,
                attn_window: Optional[int] = None
                ) -> Tuple[torch.Tensor, LatentKVCache]:
    """One decode step through the ABSORBED path: token [B], position [B];
    each row's latent is written at its position (clamped to the last, as
    the reference's dynamic_update_slice clamps), then attention reads
    only the latent cache's first min(max_len, attn_window) positions.
    Returns (logits [B, V] f32, the cache)."""
    b = token.shape[0]
    s_max = (min(cache.max_len, attn_window) if attn_window
             else cache.max_len)
    x = _embed(cfg, params, token[:, None])
    pos = position[:, None]
    cos, sin = _rope(cfg, pos)
    mask = _causal_mask(s_max, pos)
    rows = torch.arange(b, device=token.device)[:, None]
    at = torch.clamp(pos, 0, cache.max_len - 1).long()

    for li, layer in enumerate(params["layers"]):
        def attend(hx):
            q_nope, q_pe = _project_q(cfg, layer, hx, cos, sin)
            c, k_pe = _project_latent(cfg, layer, hx, cos, sin)
            _write_latents(cache, li, c, k_pe, cfg.kv_bits, rows, at)
            w_k, w_v = _split_kv_b(cfg, layer)
            return _absorbed_attention(cfg, cache, li, q_nope, q_pe, w_k, w_v,
                                       s_max, mask)

        x = _block(cfg, layer, x, attend)

    logits = _lm_head(cfg, params, x[:, 0])
    cache.length += 1
    return logits, cache


def forward_verify(cfg: MLAConfig, params: Dict, tokens: torch.Tensor,
                   positions: torch.Tensor, cache: LatentKVCache,
                   attn_window: Optional[int] = None
                   ) -> Tuple[torch.Tensor, LatentKVCache]:
    """The T-token cached forward of speculative verification: each row's
    latents are written at [positions[b, 0], positions[b, 0] + T) (a start
    for each row, clamped so the T fit), attention reads the latent cache
    with per-position causal masks, and the FULL logits [B, T, V] f32 come
    back.  Rejected drafts' latents stay beyond the row's next position,
    masked until overwritten."""
    b, t = tokens.shape
    w = (min(cache.max_len, attn_window) if attn_window
         else cache.max_len)
    x = _embed(cfg, params, tokens)
    cos, sin = _rope(cfg, positions)
    mask = _causal_mask(w, positions)
    start = torch.clamp(positions[:, 0], 0, cache.max_len - t)
    rows = torch.arange(b, device=tokens.device)[:, None]
    at = (start[:, None] + torch.arange(t, device=tokens.device)).long()

    for li, layer in enumerate(params["layers"]):
        def attend(hx):
            q_nope, q_pe = _project_q(cfg, layer, hx, cos, sin)
            c, k_pe = _project_latent(cfg, layer, hx, cos, sin)
            _write_latents(cache, li, c, k_pe, cfg.kv_bits, rows, at)
            w_k, w_v = _split_kv_b(cfg, layer)
            return _absorbed_attention(cfg, cache, li, q_nope, q_pe, w_k, w_v,
                                       w, mask)

        x = _block(cfg, layer, x, attend)

    logits = _lm_head(cfg, params, x)
    cache.length.copy_(torch.maximum(cache.length,
                                     positions[None, :, -1] + 1))
    return logits, cache


def generate(cfg: MLAConfig, params: Dict, prompts: torch.Tensor,
             max_new_tokens: int = 32,
             generator: Optional[torch.Generator] = None,
             temperature: float = 0.0, *, width: Optional[int] = None,
             max_len: Optional[int] = None) -> torch.Tensor:
    """Batch generation through the absorbed decode path: the prompts
    [B, T] (no padding) fill the latent cache, then greedy decode steps
    (or temperature sampling from `generator`).  `width` right-pads the
    prompts with zeros to it for the prefill, and `max_len` sizes the
    cache, as the engine admits a request (the logits are read at T - 1).
    Returns the tokens [B, max_new_tokens] int32."""
    b, t = prompts.shape
    dev = prompts.device
    toks = prompts.to(torch.int32)
    if width is not None and width > t:
        toks = torch.cat([toks, toks.new_zeros((b, width - t))], dim=1)
    cache = init_latent_cache(cfg, b, max_len or t + max_new_tokens,
                              device=dev)
    logits, cache = prefill(cfg, params, toks, cache,
                            last_positions=torch.full(
                                (b,), t - 1, dtype=torch.int32, device=dev))
    out = []
    pos = torch.full((b,), t, dtype=torch.int32, device=dev)
    for i in range(max_new_tokens):
        if temperature > 0:
            probs = torch.softmax(logits.float() / temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:
            tok = logits.argmax(dim=-1)
        out.append(tok.to(torch.int32))
        if i + 1 < max_new_tokens:
            logits, cache = decode_step(cfg, params, out[-1], pos, cache)
            pos = pos + 1
    return torch.stack(out, dim=1)


# ---------------------------------------------------------------------------
# the HF loader (DeepseekV2ForCausalLM / DeepseekV3ForCausalLM)
# ---------------------------------------------------------------------------

def config_from_hf(hf_config: Any, dtype: torch.dtype = torch.bfloat16
                   ) -> MLAConfig:
    """A transformers DeepseekV2 / V3 config, or the dict parsed from its
    config.json -> MLAConfig (the reference's mapping, field for field):
    YaRN from rope_scaling, V3's noaux_tc router."""
    if isinstance(hf_config, dict):
        hf_config = _Fields(hf_config)
    n_experts = getattr(hf_config, "n_routed_experts", None) or 0
    yarn = None
    rs = getattr(hf_config, "rope_scaling", None)
    if rs:
        rtype = rs.get("rope_type", rs.get("type"))
        if rtype != "yarn":
            raise ValueError(f"unsupported rope scaling {rtype!r} (yarn only)")
        yarn = YarnParams(
            factor=rs["factor"],
            original_max_position_embeddings=rs.get(
                "original_max_position_embeddings",
                hf_config.max_position_embeddings),
            beta_fast=rs.get("beta_fast") or 32.0,
            beta_slow=rs.get("beta_slow") or 1.0,
            mscale=rs.get("mscale") or 1.0,
            mscale_all_dim=rs.get("mscale_all_dim") or 0.0)
    if getattr(hf_config, "model_type", "") == "deepseek_v3":
        topk_method = "noaux_tc"     # V3's router has no topk_method field
    else:
        topk_method = getattr(hf_config, "topk_method", "greedy") or "greedy"
    if n_experts and topk_method not in ("greedy", "group_limited_greedy",
                                         "noaux_tc"):
        raise ValueError(f"unsupported topk_method {topk_method!r}")
    return MLAConfig(
        vocab_size=hf_config.vocab_size,
        d_model=hf_config.hidden_size,
        n_layers=hf_config.num_hidden_layers,
        n_heads=hf_config.num_attention_heads,
        d_ff=hf_config.intermediate_size,
        kv_lora_rank=hf_config.kv_lora_rank,
        q_lora_rank=getattr(hf_config, "q_lora_rank", None),
        qk_nope_head_dim=hf_config.qk_nope_head_dim,
        qk_rope_head_dim=hf_config.qk_rope_head_dim,
        v_head_dim=hf_config.v_head_dim,
        rope_theta=getattr(hf_config, "rope_theta", 10_000.0),
        rms_eps=getattr(hf_config, "rms_norm_eps", 1e-6),
        max_seq_len=getattr(hf_config, "max_position_embeddings", 4096),
        dtype=dtype,
        n_experts=n_experts,
        moe_top_k=getattr(hf_config, "num_experts_per_tok", None) or 6,
        moe_d_ff=getattr(hf_config, "moe_intermediate_size", 0) or 0,
        n_shared_experts=getattr(hf_config, "n_shared_experts", None) or 0,
        first_k_dense=getattr(hf_config, "first_k_dense_replace", 0) or 0,
        routed_scaling=getattr(hf_config, "routed_scaling_factor", 1.0),
        norm_topk_prob=bool(getattr(hf_config, "norm_topk_prob", False)),
        topk_method=topk_method,
        n_group=getattr(hf_config, "n_group", None) or 1,
        topk_group=getattr(hf_config, "topk_group", None) or 1,
        yarn=yarn)


def params_from_hf(model, dtype: torch.dtype = torch.bfloat16, *,
                   device: DeviceLike = None) -> Tuple[MLAConfig, Dict]:
    """Any object with `.config` (a transformers config or a config.json
    dict) and `.state_dict()` in DeepseekV2ForCausalLM's names -> (cfg,
    params) on the device, float in `dtype`: linear weights transposed to
    [in, out], expert weights stacked [E, in, out].  No rope column
    permutation (this family's rope is interleaved)."""
    dev = resolve_device(device)
    cfg = config_from_hf(model.config, dtype)
    sd = model.state_dict()

    def get(name, dt=dtype):
        t = sd[name].detach().to(dev)
        if t.dtype not in (torch.float32, torch.float64):
            t = t.float()
        return t.to(dt)

    def lin(name):
        return get(name).t().contiguous()

    params: Dict[str, Any] = {
        "embed": get("model.embed_tokens.weight"),
        "final_norm": get("model.norm.weight"),
        "lm_head": lin("lm_head.weight" if "lm_head.weight" in sd
                       else "model.embed_tokens.weight"),
        "layers": [],
    }
    for i in range(cfg.n_layers):
        pre = f"model.layers.{i}."
        at = pre + "self_attn."
        layer = {
            "attn_norm": get(pre + "input_layernorm.weight"),
            "mlp_norm": get(pre + "post_attention_layernorm.weight"),
            "kv_a": lin(at + "kv_a_proj_with_mqa.weight"),
            "kv_a_norm": get(at + "kv_a_layernorm.weight"),
            "kv_b": lin(at + "kv_b_proj.weight"),
            "wo": lin(at + "o_proj.weight"),
        }
        if cfg.moe_layer(i):
            layer["router"] = lin(pre + "mlp.gate.weight")
            bias = pre + "mlp.gate.e_score_correction_bias"
            if bias in sd:
                layer["router_bias"] = get(bias, torch.float32)
            elif cfg.topk_method == "noaux_tc":
                layer["router_bias"] = torch.zeros(
                    cfg.n_experts, dtype=torch.float32, device=dev)
            for ours, theirs in (("moe_w1", "gate_proj"),
                                 ("moe_w3", "up_proj"),
                                 ("moe_w2", "down_proj")):
                layer[ours] = torch.stack(
                    [lin(pre + f"mlp.experts.{e}.{theirs}.weight")
                     for e in range(cfg.n_experts)])
            if cfg.n_shared_experts:
                for ours, theirs in (("shared_w1", "gate_proj"),
                                     ("shared_w3", "up_proj"),
                                     ("shared_w2", "down_proj")):
                    layer[ours] = lin(pre + f"mlp.shared_experts.{theirs}"
                                      ".weight")
        else:
            layer["w1"] = lin(pre + "mlp.gate_proj.weight")
            layer["w3"] = lin(pre + "mlp.up_proj.weight")
            layer["w2"] = lin(pre + "mlp.down_proj.weight")
        if cfg.q_lora_rank is None:
            layer["wq"] = lin(at + "q_proj.weight")
        else:
            layer["wq_a"] = lin(at + "q_a_proj.weight")
            layer["q_a_norm"] = get(at + "q_a_layernorm.weight")
            layer["wq_b"] = lin(at + "q_b_proj.weight")
        params["layers"].append(layer)
    return cfg, params
