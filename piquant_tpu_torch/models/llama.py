"""Llama-3 dense model, weight-only quantized: the serving subset of
piquant_tpu/models/llama.py.

Params are a plain dict of tensors / QuantizedLinear (the reference
pytree's layout), and the functions take an explicit config.  Decode uses
the deferred-append path (the current token's K/V join the softmax from
registers; all layers' cache writes happen in one scatter after the layer
loop) with the flash-decode kernel over the stacked cache; prefill
attends over the in-layer K/V with the flash-prefill kernel while filling
the cache; chunked prefill (T > 1 against the cache), a caller's mask and
PIQUANT_DEFER_APPEND=0 append first and attend over the cache, and under
PIQUANT_TPU_PALLAS_ATTN=1 a non-deferred decode step takes the reference's
first flash-decode kernel (ops/cuda/attention.py).  The reference's cast
points are kept: rms_norm casts before the weight multiply, SiLU runs in
f32 then casts, and the attention context is cast to the model dtype
before `wo`.

`fuse_layer_projections` concatenates wq / wk / wv into `wqkv` and w1 / w3
into `w13` (the reference's recommended serving layout, at tp = 1); a fused
dense MLP at decode M takes the fused MLP kernel under PIQUANT_MLP_FUSE=1.
The three switches are the reference's, read at call time.

Projections may be INT2 / INT4 / INT8 or NF4, channelwise or grouped, per
weight (`quantize_params` overrides, `random_quantized_params`' mixed
recipe), and affine ones take int8 per-token activations under
`act_quant_prefill` (M >= 256) or `act_quant_decode` (every M) as the
reference's seven projections do; the lm_head never does.  The KV cache is
kv8 or the pair-packed kv4 (`kv_bits`).  `requantize_params` re-quantizes
every quantized projection at another format: the draft model of
two-model speculation (models/speculative.py).

Model-family flags of Mistral, Qwen2, Qwen3 and Phi-3: `sliding_window`
(every layer attends to its last w positions: flash prefill and decode
attention take the window, the materialized paths the window mask),
`qkv_bias` (bf16 biases after the q/k/v projections), `qk_norm` (a per-head
RMSNorm on q and k before rope) and `rotary_dim_override` (rope on the
first rotary_dim dims of each head, the rest passed through).  Of Gemma-1,
-2 and -3 and Granite: `norm_plus_one` (RMSNorm scales by 1 + w), `mlp_act`
"gelu" (GeGLU, tanh form), `scale_embed` / `embed_multiplier`,
`sandwich_norms` (norms on the block outputs), `residual_multiplier`,
`attn_softcap` (flash prefill takes it; decode then takes the materialized
path, as the reference does) / `final_softcap` / `logits_scaling`,
`attn_scale_override`, `sliding_pattern` (sliding and full layers
alternate) and `rope_theta_local` / `rope_linear_factor` (a rope table of
its own for local and for global layers).

Of GPT-OSS: `attn_sinks` (a logit for each query head joins the softmax
denominator alone), `o_bias`, `yarn` (YaRN rope with its attention factor
on cos and sin), and in the MoE `router_bias`, `moe_bias` and
`moe_clamp_swiglu`.  Of Llama-4: `nope_pattern` (no rope on every p-th
layer, with `attn_temp_tuning` scaling q there by position), `qk_l2norm`
(a weightless L2 norm on q and k after rope, on rope layers only),
`chunk_window` (the rope layers attend within their position chunk),
`moe_input_scaled` (a sigmoid over the top-k router logits scales the
expert input) and a shared expert, ungated or gated (Qwen2-MoE:
`shared_expert_d_ff`, `shared_expert_gated`).

Mixtral-style MoE layers (`n_experts` > 1) route each token to its top-k
experts (softmax over all experts, then top-k, then renormalised) and run
them either ragged (tokens sorted by expert, the ragged expert GEMMs of
ops/cuda/ragged.py; prefill-sized calls) or dense-masked (every expert on
every token, weighted by its gate; decode), gate for gate as the
reference; NF4 expert stacks, and the input-scaled, biased and clamped
experts of Llama-4 and GPT-OSS, always take the dense-masked route, as
there.  Expert parallelism is not ported yet;
see piquant_tpu_torch.convert.config_from_jax for the flags that raise.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from piquant_tpu_torch._device import DeviceLike, resolve_device
from piquant_tpu_torch.ops.cuda.attention import decode_attention
from piquant_tpu_torch.ops.cuda.decode_attn2 import decode_attention_state
from piquant_tpu_torch.ops.cuda.flash import flash_prefill_masked
from piquant_tpu_torch.quant.kv_cache import (
    KVCache,
    _quantize_sym,
    kv_cache_append_stacked,
    kv_cache_append_stacked_batch,
    kv_cache_init,
    merge_scale_pairs,
    unpack4,
    unpack4_pairs,
)
from piquant_tpu_torch.ops.cuda import ragged as _ragged
from piquant_tpu_torch.ops.cuda.qmatmul import mlp_fused_matmul
from piquant_tpu_torch.quant import moe as _moe
from piquant_tpu_torch.quant.linear import (
    ACT_QUANT_MIN_M,
    QuantizedExpertStack,
    QuantizedLinear,
    _grouped_cache,
    _quantize_act,
    dot_f32,
    quantize_linear_weight,
    quantized_matmul,
    with_grouped_cache,
)


@dataclasses.dataclass(frozen=True)
class YarnRope:
    """YaRN rope scaling (transformers _compute_yarn_parameters)."""

    factor: float = 32.0
    original_max_position_embeddings: int = 4096
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    attention_factor: Optional[float] = None  # None: 0.1 ln(factor) + 1
    truncate: bool = True


@dataclasses.dataclass(frozen=True)
class Llama3Rope:
    """Llama-3.1 rope scaling (transformers _compute_llama3_parameters)."""

    factor: float = 8.0
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_position_embeddings: int = 8192


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128_256
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    d_ff: int = 14_336
    rope_theta: float = 500_000.0
    rms_eps: float = 1e-5
    max_seq_len: int = 8192
    head_dim_override: Optional[int] = None
    qkv_bias: bool = False            # Qwen2: biases on the q/k/v projections
    sliding_window: Optional[int] = None  # Mistral: attend to the last w
                                          # positions (kp > qp - w)
    rotary_dim_override: Optional[int] = None  # partial rotary: rope on
                                               # the first rotary_dim dims
    qk_norm: bool = False             # Qwen3: per-head RMSNorm on q/k
                                      # before rope
    norm_plus_one: bool = False       # Gemma: RMSNorm scales by (1 + w)
    mlp_act: str = "silu"             # "silu" (Llama) or "gelu" (GeGLU)
    scale_embed: bool = False         # Gemma: embeddings * sqrt(d_model),
                                      # the constant rounded to the dtype
    embed_multiplier: Optional[float] = None  # Granite: embedding scale
    residual_multiplier: float = 1.0  # Granite: block outputs scaled
                                      # before the residual add
    logits_scaling: float = 1.0       # Granite: logits divided by this
    sandwich_norms: bool = False      # Gemma-2/3: RMSNorm on the attention
                                      # and MLP outputs too
    attn_softcap: Optional[float] = None   # Gemma-2: cap*tanh(s/cap) on
                                           # the scores, before the mask
    final_softcap: Optional[float] = None  # the same cap on the logits
    attn_scale_override: Optional[float] = None  # score scale in place of
                                                 # head_dim ** -0.5
    sliding_pattern: Optional[int] = None  # layer li is full attention iff
                                           # (li + 1) % pattern == 0,
                                           # sliding otherwise
    rope_theta_local: Optional[float] = None   # Gemma-3: local layers'
                                               # rope base, unscaled
    rope_linear_factor: Optional[float] = None  # global layers: inv / factor
    llama3_rope: Optional[Llama3Rope] = None
    yarn: Optional[YarnRope] = None
    attn_sinks: bool = False          # GPT-OSS: a sink logit per query head
                                      # in the softmax denominator
    o_bias: bool = False              # GPT-OSS: bias after wo
    qk_l2norm: bool = False           # Llama-4: weightless L2 norm on q/k
                                      # after rope (rope layers only)
    nope_pattern: Optional[int] = None  # Llama-4: no rope on layers with
                                        # (li + 1) % pattern == 0
    attn_temp_tuning: bool = False    # nope layers: q scaled by log1p(
                                      # floor((pos + 1) / floor_scale))
                                      # * temp_attn_scale + 1
    floor_scale: float = 8192.0
    temp_attn_scale: float = 0.1
    chunk_window: Optional[int] = None  # Llama-4: rope layers attend only
                                        # within their chunk (kp // C ==
                                        # qp // C)
    rope_interleaved: bool = False    # a checkpoint loader's flag: carried,
                                      # no effect on the model
    kv_bits: int = 8
    act_quant_prefill: bool = False   # int8 per-token activations at M >= 256
    act_quant_decode: bool = False    # int8 per-token activations at every M
    n_experts: int = 0                # Mixtral-style MoE MLP when > 1
    moe_top_k: int = 2                # experts per token
    moe_d_ff: Optional[int] = None    # expert hidden dim (default d_ff)
    moe_renormalize: bool = True      # renormalise the top-k probabilities
    moe_every: Optional[int] = None   # MoE on layers (li + 1) % step == 0
    router_bias: bool = False         # GPT-OSS: bias on the router logits
    moe_bias: bool = False            # GPT-OSS: expert biases (f32)
    moe_clamp_swiglu: bool = False    # GPT-OSS: (clip(up, +-7) + 1) * g *
                                      # sigmoid(1.702 g), g = min(gate, 7)
    moe_input_scaled: bool = False    # Llama-4: sigmoid(top-k logits)
                                      # scales the expert input
    shared_expert_d_ff: Optional[int] = None  # always-on shared expert
    shared_expert_gated: bool = True  # Qwen2-MoE: sigmoid-gated; Llama-4:
                                      # ungated
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        if self.kv_bits not in (4, 8):
            raise ValueError("kv_bits must be 4 or 8")

    @property
    def head_dim(self) -> int:
        return self.head_dim_override or self.d_model // self.n_heads

    @property
    def rotary_dim(self) -> int:
        return self.rotary_dim_override or self.head_dim

    def layer_uses_rope(self, li: int) -> bool:
        return not (self.nope_pattern and (li + 1) % self.nope_pattern == 0)

    def layer_is_local(self, li: int) -> bool:
        """True for the sliding or chunked layers of an alternating
        layout."""
        p = self.sliding_pattern or (self.nope_pattern if self.chunk_window
                                     else None)
        return bool(p) and (li + 1) % p != 0

    def layer_window(self, li: int) -> Tuple[Optional[int], Optional[int]]:
        """(sliding window, chunk) of layer li, (None, None) for full causal
        attention: every layer takes the sliding window (Mistral), or the
        local layers of an alternating layout (Gemma-2, Gemma-3, GPT-OSS);
        Llama-4's rope layers take the chunk.  The one place that decides a
        layer's mask, for the kernels and the masks alike."""
        if self.sliding_pattern:
            return ((self.sliding_window if self.layer_is_local(li)
                     else None), None)
        if self.chunk_window:
            return None, (self.chunk_window
                          if not self.nope_pattern or self.layer_is_local(li)
                          else None)
        return self.sliding_window, None

    def moe_layer(self, li: int) -> bool:
        if self.n_experts <= 1:
            return False
        return self.moe_every is None or (li + 1) % self.moe_every == 0

    @staticmethod
    def llama3_8b() -> "LlamaConfig":
        return LlamaConfig()

    @staticmethod
    def mistral_7b() -> "LlamaConfig":
        return LlamaConfig(
            vocab_size=32_000, d_model=4096, n_layers=32, n_heads=32,
            n_kv_heads=8, d_ff=14_336, rope_theta=10_000.0, max_seq_len=8192,
            sliding_window=4096)

    @staticmethod
    def qwen2_7b() -> "LlamaConfig":
        return LlamaConfig(
            vocab_size=152_064, d_model=3584, n_layers=28, n_heads=28,
            n_kv_heads=4, d_ff=18_944, rope_theta=1_000_000.0,
            max_seq_len=32_768, qkv_bias=True)

    @staticmethod
    def phi3_mini() -> "LlamaConfig":
        return LlamaConfig(
            vocab_size=32_064, d_model=3072, n_layers=32, n_heads=32,
            n_kv_heads=32, d_ff=8192, rope_theta=10_000.0, max_seq_len=4096)

    @staticmethod
    def qwen3_8b() -> "LlamaConfig":
        return LlamaConfig(
            vocab_size=151_936, d_model=4096, n_layers=36, n_heads=32,
            n_kv_heads=8, d_ff=12_288, rope_theta=1_000_000.0,
            max_seq_len=32_768, head_dim_override=128, qk_norm=True)

    @staticmethod
    def gemma_2b() -> "LlamaConfig":
        return LlamaConfig(
            vocab_size=256_000, d_model=2048, n_layers=18, n_heads=8,
            n_kv_heads=1, d_ff=16_384, rope_theta=10_000.0, max_seq_len=8192,
            head_dim_override=256, norm_plus_one=True, mlp_act="gelu",
            scale_embed=True)

    @staticmethod
    def gemma_7b() -> "LlamaConfig":
        return LlamaConfig(
            vocab_size=256_000, d_model=3072, n_layers=28, n_heads=16,
            n_kv_heads=16, d_ff=24_576, rope_theta=10_000.0, max_seq_len=8192,
            head_dim_override=256, norm_plus_one=True, mlp_act="gelu",
            scale_embed=True)

    @staticmethod
    def gemma2_9b() -> "LlamaConfig":
        """Gemma-2-9B: sandwich norms, logit softcaps, alternating
        sliding (4096) and full layers, query_pre_attn_scalar 256."""
        return LlamaConfig(
            vocab_size=256_000, d_model=3584, n_layers=42, n_heads=16,
            n_kv_heads=8, d_ff=14_336, rope_theta=10_000.0, max_seq_len=8192,
            head_dim_override=256, norm_plus_one=True, mlp_act="gelu",
            scale_embed=True, sandwich_norms=True, attn_softcap=50.0,
            final_softcap=30.0, attn_scale_override=256.0 ** -0.5,
            sliding_window=4096, sliding_pattern=2)

    @staticmethod
    def gemma3_12b() -> "LlamaConfig":
        """Gemma-3-12B: five sliding (1024) layers to one full, a rope
        base each (local 10k; global 1M, linear-scaled x8), qk-norm,
        sandwich norms."""
        return LlamaConfig(
            vocab_size=262_208, d_model=3840, n_layers=48, n_heads=16,
            n_kv_heads=8, d_ff=15_360, rope_theta=1_000_000.0,
            max_seq_len=131_072, head_dim_override=256, norm_plus_one=True,
            mlp_act="gelu", scale_embed=True, sandwich_norms=True,
            qk_norm=True, attn_scale_override=256.0 ** -0.5,
            sliding_window=1024, sliding_pattern=6,
            rope_theta_local=10_000.0, rope_linear_factor=8.0)

    @staticmethod
    def mixtral_8x7b() -> "LlamaConfig":
        return LlamaConfig(
            vocab_size=32_000, d_model=4096, n_layers=32, n_heads=32,
            n_kv_heads=8, d_ff=14_336, rope_theta=1_000_000.0,
            max_seq_len=32_768, n_experts=8, moe_top_k=2)

    @staticmethod
    def qwen3_moe_a3b() -> "LlamaConfig":
        """Qwen3-30B-A3B: qk-norm attention and a 128-expert top-8 MoE on
        every layer (top-k renormalised)."""
        return LlamaConfig(
            vocab_size=151_936, d_model=2048, n_layers=48, n_heads=32,
            n_kv_heads=4, d_ff=6144, rope_theta=1_000_000.0,
            max_seq_len=32_768, head_dim_override=128, qk_norm=True,
            n_experts=128, moe_top_k=8, moe_d_ff=768, moe_renormalize=True)

    @staticmethod
    def llama4_scout() -> "LlamaConfig":
        """Llama-4-Scout-17B-16E: MoE on every layer (16 experts, top 1,
        input-scaled sigmoid routing, an ungated shared expert), no rope on
        every 4th layer with temperature tuning, chunked (8192) attention on
        the rope layers, L2 qk-norm, Llama-3.1 rope scaling."""
        return LlamaConfig(
            vocab_size=202_048, d_model=5120, n_layers=48, n_heads=40,
            n_kv_heads=8, d_ff=16_384, rope_theta=500_000.0,
            max_seq_len=131_072, head_dim_override=128,
            n_experts=16, moe_top_k=1, moe_d_ff=8192,
            shared_expert_d_ff=8192, shared_expert_gated=False,
            moe_every=1, moe_input_scaled=True,
            qk_l2norm=True, nope_pattern=4, attn_temp_tuning=True,
            chunk_window=8192, rope_interleaved=True,
            llama3_rope=Llama3Rope(factor=8.0))

    @staticmethod
    def gpt_oss_20b() -> "LlamaConfig":
        """GPT-OSS-20B: attention sinks, alternating sliding (128) and full
        layers, YaRN (x32), a 32-expert top-4 MoE with clamped SwiGLU and
        biases on every projection."""
        return LlamaConfig(
            vocab_size=201_088, d_model=2880, n_layers=24, n_heads=64,
            n_kv_heads=8, d_ff=2880, rope_theta=150_000.0,
            max_seq_len=131_072, head_dim_override=64,
            qkv_bias=True, o_bias=True, attn_sinks=True,
            sliding_window=128, sliding_pattern=2,
            n_experts=32, moe_top_k=4, moe_d_ff=2880,
            moe_renormalize=True, router_bias=True, moe_bias=True,
            moe_clamp_swiglu=True,
            yarn=YarnRope(factor=32.0, original_max_position_embeddings=4096,
                          truncate=False))

    @staticmethod
    def tiny(vocab: int = 256, **kw) -> "LlamaConfig":
        """Small config for tests."""
        return LlamaConfig(vocab_size=vocab, d_model=256, n_layers=2,
                           n_heads=8, n_kv_heads=4, d_ff=512,
                           max_seq_len=256, **kw)


# ---------------------------------------------------------------------------
# init / quantize
# ---------------------------------------------------------------------------

_QUANT_KEYS = ("wq", "wk", "wv", "wo", "w1", "w2", "w3")
# the shared expert's projections, quantized as the others (the
# reference's _QUANT_KEYS holds all ten)
_SHARED_QUANT_KEYS = ("shared_w1", "shared_w2", "shared_w3")
_MOE_QUANT_KEYS = ("moe_w1", "moe_w2", "moe_w3")


def _family_leaves(cfg: LlamaConfig, li: int, dev) -> Dict:
    """Layer li's float family leaves, as the reference initialises them:
    zero q/k/v biases under qkv_bias, unit q/k norms of head_dim under
    qk_norm, unit post-attention and post-MLP norms under sandwich_norms,
    zero f32 sinks [n_heads] under attn_sinks, a zero output bias under
    o_bias, and on an MoE layer zero f32 router and expert biases under
    router_bias and moe_bias."""
    dt, hd = cfg.dtype, cfg.head_dim
    f32 = torch.float32
    out = {}
    if cfg.o_bias:
        out["bo"] = torch.zeros(cfg.d_model, dtype=dt, device=dev)
    if cfg.attn_sinks:
        out["sinks"] = torch.zeros(cfg.n_heads, dtype=f32, device=dev)
    if cfg.moe_layer(li):
        e, f = cfg.n_experts, cfg.moe_d_ff or cfg.d_ff
        if cfg.router_bias:
            out["router_b"] = torch.zeros(e, dtype=f32, device=dev)
        if cfg.moe_bias:
            for name, n in (("moe_b1", f), ("moe_b3", f),
                            ("moe_b2", cfg.d_model)):
                out[name] = torch.zeros((e, n), dtype=f32, device=dev)
    if cfg.sandwich_norms:
        out["post_attn_norm"] = torch.ones(cfg.d_model, dtype=dt, device=dev)
        out["post_mlp_norm"] = torch.ones(cfg.d_model, dtype=dt, device=dev)
    if cfg.qkv_bias:
        for name, n in (("bq", cfg.n_heads), ("bk", cfg.n_kv_heads),
                        ("bv", cfg.n_kv_heads)):
            out[name] = torch.zeros(n * hd, dtype=dt, device=dev)
    if cfg.qk_norm:
        out["q_norm"] = torch.ones(hd, dtype=dt, device=dev)
        out["k_norm"] = torch.ones(hd, dtype=dt, device=dev)
    return out


def _shapes(cfg: LlamaConfig, li: int):
    """(K, N) of layer li's projections: w1/w3/w2 on a dense layer, the
    experts' moe_w1/moe_w3/moe_w2 on an MoE layer, with shared_w1/w3/w2
    under shared_expert_d_ff."""
    hd = cfg.head_dim
    d = cfg.d_model
    out = {"wq": (d, cfg.n_heads * hd), "wk": (d, cfg.n_kv_heads * hd),
           "wv": (d, cfg.n_kv_heads * hd), "wo": (cfg.n_heads * hd, d)}
    if cfg.moe_layer(li):
        f = cfg.moe_d_ff or cfg.d_ff
        out.update(moe_w1=(d, f), moe_w3=(d, f), moe_w2=(f, d))
        sf = cfg.shared_expert_d_ff
        if sf:
            out.update(shared_w1=(d, sf), shared_w3=(d, sf),
                       shared_w2=(sf, d))
    else:
        f = cfg.d_ff
        out.update(w1=(d, f), w3=(d, f), w2=(f, d))
    return out


def init_params(cfg: LlamaConfig, seed: int = 0, *,
                device: DeviceLike = None) -> Dict:
    """Random float init (std 0.02, ones for the norms), from a seed."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = cfg.dtype

    def dense(din, dout):
        return (torch.randn((din, dout), generator=gen, device=dev)
                * 0.02).to(dt)

    params = {
        "embed": dense(cfg.vocab_size, cfg.d_model),
        "final_norm": torch.ones(cfg.d_model, dtype=dt, device=dev),
        "lm_head": dense(cfg.d_model, cfg.vocab_size),
        "layers": [],
    }
    for li in range(cfg.n_layers):
        layer = {"attn_norm": torch.ones(cfg.d_model, dtype=dt, device=dev),
                 "mlp_norm": torch.ones(cfg.d_model, dtype=dt, device=dev)}
        if cfg.moe_layer(li):
            layer["router"] = dense(cfg.d_model, cfg.n_experts)
            if cfg.shared_expert_d_ff and cfg.shared_expert_gated:
                layer["shared_gate"] = dense(cfg.d_model, 1)
        for name, (din, dout) in _shapes(cfg, li).items():
            layer[name] = (torch.stack([dense(din, dout)
                                        for _ in range(cfg.n_experts)])
                           if name in _MOE_QUANT_KEYS else dense(din, dout))
        layer.update(_family_leaves(cfg, li, dev))
        params["layers"].append(layer)
    return params


def random_quantized_params(cfg: LlamaConfig, seed: int = 0, bits: int = 4,
                            lm_head_bits: Optional[int] = None,
                            group_size: Optional[int] = None,
                            mlp_bits: Optional[int] = None,
                            mlp_group_size: Optional[int] = None, *,
                            device: DeviceLike = None) -> Dict:
    """Quantized params built directly from random codes (never a float
    weight), so a full-width model fits for speed measurements; the scale
    and zero point are the reference's (`random_quantized_params`): for
    bits "nf4" an absmax scale of 1/sqrt(K) and a zero zero point.
    `lm_head_bits` quantizes the lm_head too (channelwise unless it equals
    `bits`), `group_size` applies to the weights at `bits` (channelwise
    where it does not divide K), and `mlp_bits` / `mlp_group_size` build
    the mixed recipe: attention at `bits`, w1/w3/w2 at `mlp_bits`.  MoE
    layers get a bf16 router and expert stacks at `bits` / `group_size`
    (the mixed recipe touches dense MLP layers only), built directly as
    [E, rows, N]."""
    for b in (bits, lm_head_bits, mlp_bits):
        if b is not None and b not in (2, 4, 8, "nf4"):
            raise NotImplementedError(f"random {b}-bit weights: the port "
                                      "builds INT2, INT4, INT8 and NF4")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = cfg.dtype

    def qlin(din, dout, b=None, gs_req=None, experts=0):
        b = b if b is not None else bits
        gs = gs_req if gs_req is not None else (
            group_size if b == bits and group_size else None)
        if gs and din % gs:
            gs = None
        codebook = "nf4" if b == "nf4" else None
        nb = 4 if codebook else b
        rows = {2: din // 4, 4: din // 2}.get(nb, din)
        g = din // gs if gs else 1
        lead = (experts,) if experts else ()
        data = torch.randint(0, 256, lead + (rows, dout), generator=gen,
                             device=dev, dtype=torch.uint8)
        s0, z0 = ((1.0 / din ** 0.5, 0) if codebook else
                  (2.0 / ((1 << b) - 1) / din ** 0.5, 1 << (b - 1)))
        scale = torch.full(lead + (g, dout), s0, dtype=torch.float32,
                           device=dev)
        zp = torch.full(lead + (g, dout), z0, dtype=torch.int32, device=dev)
        if not experts:
            return with_grouped_cache(QuantizedLinear(
                data=data, scale=scale, zero_point=zp, bits=nb, k=din,
                group_size=gs, codebook=codebook))
        s_chunk, z_chunk = (_grouped_cache(scale, zp, din, gs, nb)
                            if gs and not codebook else (None, None))
        return QuantizedExpertStack(data=data, scale=scale, zero_point=zp,
                                    bits=nb, k=din, group_size=gs,
                                    s_chunk=s_chunk, z_chunk=z_chunk,
                                    codebook=codebook)

    def dense(din, dout):
        return (torch.randn((din, dout), generator=gen, device=dev)
                * 0.02).to(dt)

    params = {
        "embed": dense(cfg.vocab_size, cfg.d_model),
        "final_norm": torch.ones(cfg.d_model, dtype=dt, device=dev),
        "lm_head": (dense(cfg.d_model, cfg.vocab_size) if lm_head_bits is None
                    else qlin(cfg.d_model, cfg.vocab_size, lm_head_bits)),
        "layers": [],
    }
    for li in range(cfg.n_layers):
        layer = {"attn_norm": torch.ones(cfg.d_model, dtype=dt, device=dev),
                 "mlp_norm": torch.ones(cfg.d_model, dtype=dt, device=dev)}
        if cfg.moe_layer(li):
            layer["router"] = dense(cfg.d_model, cfg.n_experts)
            if cfg.shared_expert_d_ff and cfg.shared_expert_gated:
                layer["shared_gate"] = dense(cfg.d_model, 1)
        for name, (din, dout) in _shapes(cfg, li).items():
            if name in _MOE_QUANT_KEYS:
                layer[name] = qlin(din, dout, experts=cfg.n_experts)
                continue
            mlp = name in ("w1", "w2", "w3")
            layer[name] = qlin(din, dout, mlp_bits if mlp else None,
                               mlp_group_size if mlp else None)
        layer.update(_family_leaves(cfg, li, dev))
        params["layers"].append(layer)
    return params


def quantize_params(params: Dict, bits: int = 4, *, channelwise: bool = True,
                    group_size: Optional[int] = None,
                    quantize_lm_head: bool = False,
                    overrides: Optional[Dict] = None) -> Dict:
    """Weight-only quantization of every projection; norms, embeddings and
    routers stay float (and the lm_head too unless `quantize_lm_head`:
    INT8).  MoE expert stacks are quantized per expert and restacked.

    `overrides` maps weight names to `(bits, group_size)` (or bare bits) for
    mixed-precision recipes, e.g. the MLP at INT2-g32 with attention at
    INT4: {"w1": (2, 32), "w3": (2, 32), "w2": (2, 32)}.  Per-layer keys
    "{layer_idx}.{name}" take precedence over bare names."""
    overrides = overrides or {}

    def cfg_for(li, name):
        o = overrides.get(f"{li}.{name}", overrides.get(name))
        if o is None:
            return bits, group_size
        return o if isinstance(o, tuple) else (o, group_size)

    out = dict(params)
    out["layers"] = []
    for li, layer in enumerate(params["layers"]):
        ql = dict(layer)
        for k in _QUANT_KEYS + _SHARED_QUANT_KEYS:
            if k in layer:
                b, gs = cfg_for(li, k)
                ql[k] = quantize_linear_weight(layer[k], b,
                                               channelwise=channelwise,
                                               group_size=gs)
        for k in _MOE_QUANT_KEYS:
            if k in layer:
                b, gs = cfg_for(li, k)
                ql[k] = QuantizedExpertStack.stack([
                    quantize_linear_weight(w, b, channelwise=channelwise,
                                           group_size=gs)
                    for w in layer[k]])
        out["layers"].append(ql)
    if quantize_lm_head:
        out["lm_head"] = quantize_linear_weight(params["lm_head"], 8,
                                                channelwise=channelwise)
    return out


def requantize_params(params: Dict, bits=4, *,
                      group_size: Optional[int] = None) -> Dict:
    """Re-quantize every already-quantized linear at another format
    (dequantize to f32, then quantize_linear_weight at `bits` -- 2, 4, 8 or
    "nf4" -- and `group_size`): each QuantizedLinear, each expert of a
    QuantizedExpertStack, and a quantized lm_head.  Float leaves (and the
    fused layers' `fused_tp`) pass through as the same objects.  The usual
    DRAFT model of two-model speculation: a harder-quantized copy of the
    target agrees with it on most tokens."""
    def conv(v):
        if isinstance(v, QuantizedLinear):
            return quantize_linear_weight(v.dequantize(torch.float32), bits,
                                          group_size=group_size)
        if isinstance(v, QuantizedExpertStack):
            return QuantizedExpertStack.stack([
                quantize_linear_weight(
                    v.expert(e).dequantize(torch.float32), bits,
                    group_size=group_size)
                for e in range(v.n_experts)])
        return v

    out = dict(params)
    out["layers"] = [{k: conv(v) for k, v in layer.items()}
                     for layer in params["layers"]]
    if isinstance(params.get("lm_head"), QuantizedLinear):
        out["lm_head"] = conv(params["lm_head"])
    return out


# ---------------------------------------------------------------------------
# fused projections
# ---------------------------------------------------------------------------

def _concat_qlinear(qls):
    """Concatenate QuantizedLinear weights along N (same K, bits, group
    size and codebook); grouped side streams are rebuilt for the whole."""
    first = qls[0]
    for q in qls[1:]:
        if (q.bits, q.k, q.group_size, q.codebook) != (
                first.bits, first.k, first.group_size, first.codebook):
            raise ValueError("cannot fuse mismatched quantized linears")
    return with_grouped_cache(QuantizedLinear(
        data=torch.cat([q.data for q in qls], dim=1),
        scale=torch.cat([q.scale for q in qls], dim=1),
        zero_point=torch.cat([q.zero_point for q in qls], dim=1),
        bits=first.bits, k=first.k, group_size=first.group_size,
        codebook=first.codebook))


def _tp_not_ported(tp: int) -> None:
    if tp != 1:
        raise NotImplementedError(
            f"fused projections at tp={tp}: tensor parallelism is not ported "
            "yet (ROADMAP.md queue 1 item 16b)")


def _interleave_cols(ws, tp: int):
    """The column concat of `ws` (quantized or float [K, N] weights); the
    reference interleaves tp shard blocks, which needs tensor parallelism
    (tp > 1 raises)."""
    _tp_not_ported(tp)
    if isinstance(ws[0], QuantizedLinear):
        return _concat_qlinear(ws)
    return torch.cat(ws, dim=1)


def _split_interleaved(y: torch.Tensor, sizes, tp: int):
    """Inverse of _interleave_cols on the matmul output: y[..., sum(sizes)]
    -> the per-projection slices."""
    _tp_not_ported(tp)
    return list(torch.split(y, list(sizes), dim=-1))


def fuse_layer_projections(params: Dict, cfg: LlamaConfig,
                           tp: int = 1) -> Dict:
    """wq / wk / wv -> wqkv and w1 / w3 -> w13 in every layer (column
    concat), with `fused_tp` (an int) recorded: 7 -> 4 projections a dense
    layer.  qkv_bias models keep their params unfused; MoE layers fuse only
    the attention projections.  tp > 1 raises (ROADMAP.md queue 1 item
    16b)."""
    if cfg.qkv_bias:
        return params
    _tp_not_ported(tp)
    out = dict(params)
    out["layers"] = []
    for layer in params["layers"]:
        nl = {k: v for k, v in layer.items()
              if k not in ("wq", "wk", "wv", "w1", "w3")}
        nl["wqkv"] = _interleave_cols([layer["wq"], layer["wk"],
                                       layer["wv"]], tp)
        if "w1" in layer:
            nl["w13"] = _interleave_cols([layer["w1"], layer["w3"]], tp)
        nl["fused_tp"] = tp
        out["layers"].append(nl)
    return out


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

def _mm(x: torch.Tensor, w, out_dtype, act_quant=False) -> torch.Tensor:
    if isinstance(w, QuantizedLinear):
        return quantized_matmul(x, w, out_dtype, act_quant=act_quant)
    # the reference casts both operands to out_dtype; bf16 operands are
    # exact in f32, so an f32 output (the lm_head) keeps them bf16: the
    # same products, without an f32 copy of the weight every step
    op = (torch.bfloat16 if out_dtype == torch.float32
          and x.dtype == w.dtype == torch.bfloat16 else out_dtype)
    return dot_f32(x.to(op), w.to(op)).to(out_dtype)


def _act_quant(cfg: LlamaConfig):
    """The projections' act_quant argument: "all" (every M) under
    act_quant_decode, else act_quant_prefill (M >= 256)."""
    return "all" if cfg.act_quant_decode else cfg.act_quant_prefill


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float,
             plus_one: bool = False) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    normed = (xf * torch.rsqrt(var + eps)).to(x.dtype)
    return normed * (w + 1.0) if plus_one else normed * w


def _glu_act(cfg: LlamaConfig, g: torch.Tensor) -> torch.Tensor:
    """The gate's activation in f32: SiLU, or GELU in its tanh form for
    GeGLU (the reference's jax.nn.gelu(approximate=True); torch's default
    GELU is the erf form)."""
    gf = g.float()
    if cfg.mlp_act == "gelu":
        return F.gelu(gf, approximate="tanh")
    return F.silu(gf)


def _dtype_const(v: float, x: torch.Tensor) -> torch.Tensor:
    """A scalar rounded to x's dtype first (Gemma's sqrt(d_model): 59.866
    becomes 59.75 in bf16), as the reference's jnp.asarray(v, dt)."""
    return torch.tensor(v, dtype=x.dtype)


def _llama3_inv_freq(cfg: LlamaConfig, inv: torch.Tensor) -> torch.Tensor:
    """transformers _compute_llama3_parameters, re-derived."""
    r = cfg.llama3_rope
    old_len = r.original_max_position_embeddings
    low_wl = old_len / r.low_freq_factor
    high_wl = old_len / r.high_freq_factor
    wavelen = 2 * math.pi / inv
    scaled = torch.where(wavelen > low_wl, inv / r.factor, inv)
    smooth = ((old_len / wavelen - r.low_freq_factor)
              / (r.high_freq_factor - r.low_freq_factor))
    smoothed = (1 - smooth) / r.factor * inv + smooth * inv
    medium = (wavelen >= high_wl) & (wavelen <= low_wl)
    return torch.where(medium, smoothed, scaled)


def _yarn_inv_freq(cfg: LlamaConfig, dev) -> Tuple[torch.Tensor, float]:
    """YaRN (transformers _compute_yarn_parameters, re-derived): the
    interpolated and extrapolated inverse frequencies blended by a linear
    ramp over the correction range, and the attention factor that scales
    cos and sin."""
    y = cfg.yarn
    rd, base = cfg.rotary_dim, cfg.rope_theta
    orig = y.original_max_position_embeddings
    af = y.attention_factor
    if af is None:
        af = 0.1 * math.log(y.factor) + 1.0 if y.factor > 1 else 1.0

    def corr_dim(n_rot):
        return (rd * math.log(orig / (n_rot * 2 * math.pi))
                / (2 * math.log(base)))

    low, high = corr_dim(y.beta_fast), corr_dim(y.beta_slow)
    if y.truncate:
        low, high = math.floor(low), math.ceil(high)
    low, high = max(low, 0), min(high, rd - 1)
    if low == high:
        high += 0.001
    pos_freqs = base ** (torch.arange(0, rd, 2, dtype=torch.float32,
                                      device=dev) / rd)
    extrap = 1.0 / pos_freqs
    interp = 1.0 / (y.factor * pos_freqs)
    ramp = torch.clamp((torch.arange(rd // 2, dtype=torch.float32,
                                     device=dev) - low) / (high - low), 0, 1)
    extrap_w = 1.0 - ramp
    return interp * (1 - extrap_w) + extrap * extrap_w, af


def _rope_freqs(cfg: LlamaConfig, positions: torch.Tensor,
                local: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos / sin of a layer's rope: a local layer with rope_theta_local
    takes that base unscaled (Gemma-3); otherwise rope_theta, with YaRN
    (cos and sin times its attention factor), the Llama-3.1 scaling or
    inv / rope_linear_factor."""
    rd = cfg.rotary_dim
    own_base = local and cfg.rope_theta_local
    theta = cfg.rope_theta_local if own_base else cfg.rope_theta
    inv = 1.0 / (theta ** (
        torch.arange(0, rd, 2, dtype=torch.float32, device=positions.device)
        / rd))
    scale = 1.0
    if not own_base and cfg.yarn is not None:
        inv, scale = _yarn_inv_freq(cfg, positions.device)
    elif not own_base and cfg.llama3_rope is not None:
        inv = _llama3_inv_freq(cfg, inv)
    elif not own_base and cfg.rope_linear_factor:
        inv = inv / cfg.rope_linear_factor
    ang = positions[..., None].float() * inv          # [..., T, rd/2]
    return torch.cos(ang) * scale, torch.sin(ang) * scale


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: [B, H, T, D]; cos/sin: [B, T, R/2] -> rotate pairs (even, odd)
    of the first R dims; dims R..D pass through (partial rotary when
    R < D)."""
    rd = 2 * cos.shape[-1]
    xf = x[..., :rd].float()
    x1, x2 = xf[..., 0::2], xf[..., 1::2]
    c, s = cos[:, None], sin[:, None]
    r1 = x1 * c - x2 * s
    r2 = x2 * c + x1 * s
    out = torch.stack([r1, r2], dim=-1).reshape(xf.shape).to(x.dtype)
    if rd == x.shape[-1]:
        return out
    return torch.cat([out, x[..., rd:]], dim=-1)


def _l2_norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    """Llama-4's weightless qk norm: x / sqrt(mean(x^2) + eps) in f32, cast
    back to x's dtype."""
    xf = x.float()
    return (xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
            ).to(x.dtype)


def _softmax_with_sinks(scores: torch.Tensor,
                        snk: Optional[torch.Tensor]) -> torch.Tensor:
    """softmax over the last axis; with sinks, exp(sink) joins the
    denominator only, against max(row max, sink) (the reference's
    materialized form)."""
    if snk is None:
        return torch.softmax(scores, dim=-1)
    m = torch.maximum(scores.amax(dim=-1, keepdim=True), snk)
    e = torch.exp(scores - m)
    return e / (e.sum(dim=-1, keepdim=True) + torch.exp(snk - m))


def _dot_bf16(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum with bf16-rounded operands and f32 accumulation."""
    return torch.einsum(eq, a.to(torch.bfloat16).float(),
                        b.to(torch.bfloat16).float())


def _attention(cfg: LlamaConfig, layer: Dict, x: torch.Tensor,
               positions: torch.Tensor, rope: Tuple[torch.Tensor, torch.Tensor],
               cache: KVCache, layer_idx: int, mask: torch.Tensor,
               attend_in_layer: bool, kv_write_start: Optional[int],
               pending: Optional[list], flash_ok: bool,
               attn_window: Optional[int] = None) -> torch.Tensor:
    b, t, _ = x.shape
    hd = cfg.head_dim
    dt = cfg.dtype
    ascale = cfg.attn_scale_override or hd ** -0.5
    cap = cfg.attn_softcap or None
    rep = cfg.n_heads // cfg.n_kv_heads
    aq = _act_quant(cfg)

    if "wqkv" in layer:
        nq, nkv = cfg.n_heads * hd, cfg.n_kv_heads * hd
        q, k, v = _split_interleaved(_mm(x, layer["wqkv"], dt, aq),
                                     (nq, nkv, nkv), layer["fused_tp"])
    else:
        q = _mm(x, layer["wq"], dt, aq)
        k = _mm(x, layer["wk"], dt, aq)
        v = _mm(x, layer["wv"], dt, aq)
        if cfg.qkv_bias:
            q = q + layer["bq"]
            k = k + layer["bk"]
            v = v + layer["bv"]
    q = q.reshape(b, t, cfg.n_heads, hd).transpose(1, 2)
    k = k.reshape(b, t, cfg.n_kv_heads, hd).transpose(1, 2)
    v = v.reshape(b, t, cfg.n_kv_heads, hd).transpose(1, 2)
    if cfg.qk_norm:     # per-head RMSNorm before rope
        q = rms_norm(q, layer["q_norm"], cfg.rms_eps, cfg.norm_plus_one)
        k = rms_norm(k, layer["k_norm"], cfg.rms_eps, cfg.norm_plus_one)
    if cfg.layer_uses_rope(layer_idx):
        q = apply_rope(q, *rope)
        k = apply_rope(k, *rope)
        if cfg.qk_l2norm:   # Llama-4: after rope, rope layers only
            q = _l2_norm(q, cfg.rms_eps)
            k = _l2_norm(k, cfg.rms_eps)
    elif cfg.attn_temp_tuning:
        # Llama-4's nope layers: q scaled by its position's temperature
        sc = (torch.log1p(torch.floor((positions.float() + 1.0)
                                      / cfg.floor_scale))
              * cfg.temp_attn_scale + 1.0)                  # [B, T]
        q = (q.float() * sc[:, None, :, None]).to(q.dtype)
    qg = q.reshape(b, cfg.n_kv_heads, rep, t, hd)       # grouped heads
    window, chunk = cfg.layer_window(layer_idx)
    # GPT-OSS: a sink logit per query head h = kv * rep + r
    sinks = (layer["sinks"].float().reshape(cfg.n_kv_heads, rep)
             if cfg.attn_sinks else None)
    snk = None if sinks is None else sinks[None, :, :, None, None]

    if cache is not None and pending is None:
        kv_cache_append_stacked(cache, layer_idx, k, v, positions,
                                contiguous_start=kv_write_start)
    elif pending is not None:
        # [B,Hkv,1,D] codes (kv4: [B,Hkv,1,D/2] pack4) / [B,Hkv,1,1] scales
        kc_s, ks_s = _quantize_sym(k, cfg.kv_bits)
        vc_s, vs_s = _quantize_sym(v, cfg.kv_bits)
        pending.append((kc_s, ks_s, vc_s, vs_s))

    if (cache is not None and not attend_in_layer and t == 1
            and pending is None and cfg.attn_softcap is None and snk is None
            and cfg.sliding_window is None and cfg.chunk_window is None
            and cfg.kv_bits == 8
            and os.environ.get("PIQUANT_TPU_PALLAS_ATTN", "0") == "1"):
        # the reference's first flash-decode kernel over this layer's cache
        # (the current token is in it): only on the non-deferred path and
        # only under its switch
        ctx1 = decode_attention(
            qg[:, :, :, 0], cache.k_codes[layer_idx], cache.k_scale[layer_idx],
            cache.v_codes[layer_idx], cache.v_scale[layer_idx],
            positions[:, 0], ascale)
        if ctx1 is not None:
            ctx = ctx1[:, :, :, None].to(dt).reshape(b, cfg.n_heads, t, hd)
            # as the reference's route: wo without act-quant, no bo
            return _mm(ctx.transpose(1, 2).reshape(b, t, cfg.n_heads * hd),
                       layer["wo"], dt)

    if cache is not None and not attend_in_layer:
        st = None
        if pending is not None:
            kq, ksq, vq, vsq = pending[-1]
            if cfg.kv_bits == 4:
                kq, vq = unpack4(kq), unpack4(vq)
            pos_b = positions[:, 0]
            # a sliding window attends to cache positions p > pos - w, a
            # chunk to the positions of pos's chunk
            if window is not None:
                starts = torch.clamp(pos_b - (window - 1), min=0)
            elif chunk is not None:
                starts = pos_b // chunk * chunk
            else:
                starts = None
            # under a softcap the reference's decode leaves the kernel
            st = None if cap else decode_attention_state(
                qg[:, :, :, 0], cache.k_codes, cache.k_scale, cache.v_codes,
                cache.v_scale, pos_b, ascale, layer=layer_idx, starts=starts)
        if st is not None:
            # fold the current token (not in the cache yet) into the
            # kernel's unnormalized state: a two-part logsumexp
            acc, m_c, l_c = st                  # [B,Hkv,rep,D], [..,1] x2
            s_self = _dot_bf16("bhrtd,bhsd->bhrts", qg, kq)
            s_self = (s_self * ksq[:, :, None] * ascale)[:, :, :, 0, :]
            m2 = torch.maximum(m_c, s_self)     # [B, Hkv, rep, 1]
            if snk is not None:
                m2 = torch.maximum(m2, snk[..., 0])
            ec = torch.exp(m_c - m2)
            es = torch.exp(s_self - m2)
            denom = l_c * ec + es
            if snk is not None:
                denom = denom + torch.exp(snk[..., 0] - m2)
            v_self = vq.float() * vsq           # [B, Hkv, 1, D]
            ctx = ((acc * ec + es * v_self) / denom)[:, :, :, None]
        else:
            # materialized attention over the cache's first w positions
            # (the softcap, geometries the kernel gate refuses, the
            # non-deferred path, T > 1 against the cache)
            w = attn_window or cache.max_len
            if cfg.kv_bits == 4:                # pair-packed rows
                wr = (w + 1) // 2
                kc = unpack4_pairs(cache.k_codes[layer_idx, :, :, :wr])
                vc = unpack4_pairs(cache.v_codes[layer_idx, :, :, :wr])
                ks = merge_scale_pairs(cache.k_scale[layer_idx][..., :wr])
                vs = merge_scale_pairs(cache.v_scale[layer_idx][..., :wr])
                kc, vc, ks, vs = (a[:, :, :w] for a in (kc, vc, ks, vs))
            else:                               # [B, Hkv, W, D] int8
                kc = cache.k_codes[layer_idx, :, :, :w]
                vc = cache.v_codes[layer_idx, :, :, :w]
                ks = cache.k_scale[layer_idx, :, :, :w]   # [B, Hkv, W, 1]
                vs = cache.v_scale[layer_idx, :, :, :w]
            ks = ks[:, :, None, None, :, 0]
            vs = vs[..., 0]                     # [B, Hkv, W]
            scores = _dot_bf16("bhrtd,bhsd->bhrts", qg, kc) * ks * ascale
            if cap:                             # before the mask
                scores = cap * torch.tanh(scores / cap)
            scores = scores + mask[:, None]
        if st is None and pending is None:
            # the cache holds every attended position: one softmax
            probs = _softmax_with_sinks(scores, snk)
            pscaled = (probs * vs[:, :, None, None, :]).to(torch.bfloat16)
            ctx = _dot_bf16("bhrts,bhsd->bhrtd", pscaled, vc)
        elif st is None:
            # deferred: the current token joins from registers
            s_self = _dot_bf16("bhrtd,bhsd->bhrts", qg, kq) * ksq[:, :, None]
            s_self = s_self * ascale
            if cap:
                s_self = cap * torch.tanh(s_self / cap)
            m = torch.maximum(scores.amax(dim=-1, keepdim=True), s_self)
            if snk is not None:
                m = torch.maximum(m, snk)
            ec = torch.exp(scores - m)
            es = torch.exp(s_self - m)
            denom = ec.sum(dim=-1, keepdim=True) + es
            if snk is not None:
                denom = denom + torch.exp(snk - m)
            pscaled = (ec / denom * vs[:, :, None, None, :]).to(torch.bfloat16)
            ctx = _dot_bf16("bhrts,bhsd->bhrtd", pscaled, vc)
            ps_self = (es / denom * vsq[:, :, None]).to(torch.bfloat16)
            ctx = ctx + ps_self.float() * vq.float()[:, :, None]
    else:
        # in-layer attention (fresh prefill) over the float k/v
        ctx = None
        if flash_ok:
            ctx = flash_prefill_masked(qg, k, v, ascale, pos0=positions[:, 0],
                                       window=window, chunk=chunk,
                                       softcap=cap, sinks=sinks)
        if ctx is None:
            scores = _dot_bf16("bhrtd,bhsd->bhrts", qg, k) * ascale
            if cap:                             # before the mask
                scores = cap * torch.tanh(scores / cap)
            scores = scores + mask[:, None]
            probs = _softmax_with_sinks(scores, snk)
            ctx = _dot_bf16("bhrts,bhsd->bhrtd", probs, v)

    ctx = ctx.to(dt).reshape(b, cfg.n_heads, t, hd).transpose(1, 2)
    out = _mm(ctx.reshape(b, t, cfg.n_heads * hd), layer["wo"], dt, aq)
    return out + layer["bo"] if cfg.o_bias else out


def _mlp(cfg: LlamaConfig, layer: Dict, x: torch.Tensor) -> torch.Tensor:
    if "router" in layer:
        return _mlp_moe(cfg, layer, x)
    dt = cfg.dtype
    aq = _act_quant(cfg)
    if "w13" in layer:
        if (not aq and layer["fused_tp"] == 1
                and cfg.mlp_act in ("silu", "gelu")
                and isinstance(layer["w13"], QuantizedLinear)
                and isinstance(layer["w2"], QuantizedLinear)):
            # the fused MLP kernel at decode M, under PIQUANT_MLP_FUSE=1
            yf = mlp_fused_matmul(x, layer["w13"], layer["w2"], cfg.mlp_act,
                                  dt)
            if yf is not None:
                return yf
        g, u = _split_interleaved(_mm(x, layer["w13"], dt, aq),
                                  (cfg.d_ff, cfg.d_ff), layer["fused_tp"])
    else:
        g = _mm(x, layer["w1"], dt, aq)
        u = _mm(x, layer["w3"], dt, aq)
    h = (_glu_act(cfg, g) * u.float()).to(dt)
    return _mm(h, layer["w2"], dt, aq)


RAGGED_MIN_TOKENS = 32   # fewer tokens (decode) take the dense-masked MoE


def _expert_weight(stack, i: int):
    """Expert i of a stacked MoE weight (QuantizedExpertStack or float
    [E, K, N] tensor) as a 2-D linear for `_mm`."""
    if isinstance(stack, QuantizedExpertStack):
        return stack.expert(i)
    return stack[i]


def _mlp_moe(cfg: LlamaConfig, layer: Dict, x: torch.Tensor) -> torch.Tensor:
    """Mixtral-style sparse MoE MLP: f32 router logits (plus the router
    bias), softmax over all experts, top-k of those probabilities,
    renormalised over the selected (`moe_renormalize`; top-k of the logits
    would give other probabilities) -- or under moe_input_scaled
    (Llama-4) a sigmoid over the top-k logits; then the ragged route where
    its gates take the call, else the dense-masked one; then the shared
    expert, sigmoid-gated (Qwen2-MoE) or not (Llama-4), added to the
    routed sum."""
    dt, aq = cfg.dtype, _act_quant(cfg)
    logits = x.float() @ layer["router"].float()
    if cfg.router_bias:
        logits = logits + layer["router_b"].float()
    if cfg.moe_input_scaled:
        probs, topi = torch.topk(logits, cfg.moe_top_k, dim=-1)
        probs = torch.sigmoid(probs)
    else:
        full = torch.softmax(logits, dim=-1)
        probs, topi = torch.topk(full, cfg.moe_top_k, dim=-1)
        if cfg.moe_renormalize:
            probs = probs / probs.sum(dim=-1, keepdim=True)
    y = _moe_ragged_try(cfg, layer, x, probs, topi)
    if y is None:
        y = _moe_dense(cfg, layer, x, probs, topi, aq)
    if "shared_w1" in layer:
        g = _mm(x, layer["shared_w1"], dt, aq)
        u = _mm(x, layer["shared_w3"], dt, aq)
        h = (_glu_act(cfg, g) * u.float()).to(dt)
        sh = _mm(h, layer["shared_w2"], dt, aq).float()
        if cfg.shared_expert_gated:
            sh = torch.sigmoid(x.float() @ layer["shared_gate"].float()) * sh
        y = y + sh
    return y.to(dt)


def _moe_ragged_try(cfg: LlamaConfig, layer: Dict, x: torch.Tensor,
                    probs: torch.Tensor, topi: torch.Tensor
                    ) -> Optional[torch.Tensor]:
    """Grouped (megablocks-style) MoE: the assignments sorted by expert in
    128-row blocks (quant/moe.py), the ragged expert GEMMs
    (ops/cuda/ragged.py), the gate-weighted combine in f32 -> [B, T, D]
    f32.  None where the reference's gates send the call to the
    dense-masked route: fewer than RAGGED_MIN_TOKENS tokens, a float or
    NF4 stack or one of other than 2/4/8 bits, act-quant off its ragged
    route (int8 activations ride it only for channelwise INT2/INT4 stacks,
    at every M under act_quant_decode and at >= ACT_QUANT_MIN_M tokens
    under act_quant_prefill), input-scaled, biased or clamped experts
    (Llama-4, GPT-OSS), or a geometry the ragged dispatch declines.  The
    reference's backend check and its PIQUANT_MOE_RAGGED knob are dropped:
    the port takes this route on every device (plain versions on the
    CPU)."""
    w1s = layer["moe_w1"]
    b, t, d = x.shape
    ntok = b * t
    want_aq = bool(cfg.act_quant_decode
                   or (cfg.act_quant_prefill and ntok >= ACT_QUANT_MIN_M))
    if (not isinstance(w1s, QuantizedExpertStack)
            or w1s.bits not in (2, 4, 8) or w1s.codebook is not None
            or ntok < RAGGED_MIN_TOKENS
            or cfg.moe_input_scaled or cfg.moe_bias or cfg.moe_clamp_swiglu
            or ((cfg.act_quant_decode or cfg.act_quant_prefill) and not (
                want_aq and w1s.bits in (2, 4) and w1s.group_size is None))):
        return None
    r = _moe.build_ragged_routing(topi, probs, w1s.n_experts,
                                  _ragged.ROW_BLOCK)
    xs = _moe.scatter_tokens(x.reshape(ntok, d).to(cfg.dtype), r)

    def mm(v, stack):
        if want_aq:
            vq, vs = _quantize_act(v)
            return _ragged.wq_ragged_matmul_a8(vq, vs, stack, r.block_expert,
                                               cfg.dtype, r.live_blocks)
        return _ragged.wq_ragged_matmul(v, stack, r.block_expert, cfg.dtype,
                                        r.live_blocks)

    g = mm(xs, w1s)
    u = mm(xs, layer["moe_w3"])
    if g is None or u is None:
        return None
    h = (_glu_act(cfg, g) * u.float()).to(cfg.dtype)
    o = mm(h, layer["moe_w2"])
    if o is None:
        return None
    return _moe.combine_tokens(o, r, ntok).reshape(b, t, d)


def _moe_dense(cfg: LlamaConfig, layer: Dict, x: torch.Tensor,
               probs: torch.Tensor, topi: torch.Tensor, aq) -> torch.Tensor:
    """Every expert on every token, weighted by its gate (zero where the
    token did not pick it) -> [B, T, D] f32: a loop over the experts in
    index order adding o * gate to an f32 sum one expert at a time, as the
    reference's lax.scan body does.  Under moe_input_scaled (Llama-4) the
    gate scales the expert's input instead and the output is a plain
    masked sum; under moe_bias (GPT-OSS) f32 biases follow each
    projection, and moe_clamp_swiglu takes (clip(up, -7, 7) + 1) * g *
    sigmoid(1.702 g) with g = min(gate, 7).  At decode M the projections
    take the GEMV (or int8-x) kernels through `_mm`."""
    dt = cfg.dtype
    w1s, w3s, w2s = layer["moe_w1"], layer["moe_w3"], layer["moe_w2"]
    n_e = (w1s.n_experts if isinstance(w1s, QuantizedExpertStack)
           else w1s.shape[0])
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for e in range(n_e):
        gate = torch.where(topi == e, probs, 0.0).sum(dim=-1, keepdim=True)
        xin = x
        if cfg.moe_input_scaled:
            xin = (x.float() * gate).to(dt)
            gate = torch.where(gate > 0, 1.0, 0.0)
        gf = _mm(xin, _expert_weight(w1s, e), dt, aq).float()
        uf = _mm(xin, _expert_weight(w3s, e), dt, aq).float()
        if cfg.moe_bias:
            gf = gf + layer["moe_b1"][e].float()
            uf = uf + layer["moe_b3"][e].float()
        if cfg.moe_clamp_swiglu:
            gf = torch.clamp(gf, max=7.0)
            uf = torch.clamp(uf, -7.0, 7.0)
            h = ((uf + 1.0) * (gf * torch.sigmoid(1.702 * gf))).to(dt)
        else:
            h = (_glu_act(cfg, gf) * uf).to(dt)
        o = _mm(h, _expert_weight(w2s, e), dt, aq).float()
        if cfg.moe_bias:
            o = o + layer["moe_b2"][e].float()
        y = y + o * gate
    return y


# ---------------------------------------------------------------------------
# forward / prefill / decode
# ---------------------------------------------------------------------------

def forward(cfg: LlamaConfig, params: Dict, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None,
            cache: Optional[KVCache] = None,
            mask: Optional[torch.Tensor] = None,
            attend_in_layer: bool = False,
            logit_positions: Optional[torch.Tensor] = None,
            kv_write_start: Optional[int] = None,
            attn_window: Optional[int] = None,
            ) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """(logits [B, T, V] f32 — or [B, 1, V] with logit_positions — and the
    cache, updated in place).

    With a cache and T == 1 the step takes the deferred-append decode path
    (the current token joins the softmax from registers; every layer's
    cache write happens after the layer loop), unless the caller passes a
    mask or PIQUANT_DEFER_APPEND=0 (read at call time): then each layer
    appends first and attends to positions <= its own.  With
    attend_in_layer it is a fresh prefill that attends over its own K/V
    while filling the cache; T > 1 against the cache (chunked prefill)
    appends at `kv_write_start` (or at `positions`, scattered) and attends
    over the cache.  `mask` [B, 1, T, S] is additive and replaces the
    default causal / window / chunk masks (and flash).  `attn_window`
    attends only to the cache's first positions (every position must lie
    below it): S = min(max_len, attn_window)."""
    b, t = tokens.shape
    dt = cfg.dtype
    if positions is None:
        positions = torch.arange(t, dtype=torch.int32,
                                 device=tokens.device).expand(b, t)

    x = params["embed"][tokens.long()].to(dt)
    if cfg.scale_embed:
        x = x * _dtype_const(cfg.d_model ** 0.5, x)
    if cfg.embed_multiplier is not None:
        x = x * _dtype_const(cfg.embed_multiplier, x)
    s_len = cache.max_len if cache is not None else t
    if attn_window is not None:
        s_len = min(s_len, attn_window)
    defer = (t == 1 and cache is not None and not attend_in_layer
             and mask is None
             and os.environ.get("PIQUANT_DEFER_APPEND", "1") == "1")
    pending: Optional[list] = [] if defer else None
    flash_ok = mask is None and t > 1

    masks = {}                           # one per distinct (window, chunk)
    if mask is None:
        qp = positions[:, None, :, None]
        if attend_in_layer or cache is None:
            kp = positions[:, None, None, :]
            ok = kp <= qp
        else:
            # against the cache: positions <= the query's, STRICT < when
            # deferred (the current token is not in the cache yet; it
            # joins the softmax from registers)
            kp = torch.arange(s_len, device=tokens.device)[None, None, None]
            ok = kp < qp if defer else kp <= qp
        for w, c in {cfg.layer_window(i)
                     for i in range(len(params["layers"]))}:
            okw = ok
            if w is not None:
                okw = okw & (kp > qp - w)
            if c is not None:                # Llama-4: kp // C == qp // C
                okw = okw & (kp // c == qp // c)
            masks[w, c] = torch.where(okw, 0.0, -1e9).float()
    # one rope table, or a local and a global one (rope_theta_local)
    local_rope = [bool(cfg.rope_theta_local) and cfg.layer_is_local(i)
                  for i in range(len(params["layers"]))]
    ropes = {lr: _rope_freqs(cfg, positions, lr) for lr in set(local_rope)}

    def block_out(h, layer, name):
        """A block's output before the residual add: its sandwich norm,
        then the residual multiplier."""
        if cfg.sandwich_norms:
            h = rms_norm(h, layer[name], cfg.rms_eps, cfg.norm_plus_one)
        if cfg.residual_multiplier != 1.0:
            h = h * _dtype_const(cfg.residual_multiplier, h)
        return h

    p1 = cfg.norm_plus_one
    for i, layer in enumerate(params["layers"]):
        h = _attention(cfg, layer,
                       rms_norm(x, layer["attn_norm"], cfg.rms_eps, p1),
                       positions, ropes[local_rope[i]], cache, i,
                       masks[cfg.layer_window(i)] if mask is None else mask,
                       attend_in_layer, kv_write_start, pending, flash_ok,
                       attn_window)
        x = x + block_out(h, layer, "post_attn_norm")
        h = _mlp(cfg, layer, rms_norm(x, layer["mlp_norm"], cfg.rms_eps, p1))
        x = x + block_out(h, layer, "post_mlp_norm")

    if pending:
        kv_cache_append_stacked_batch(
            cache,
            torch.stack([p[0] for p in pending]),   # [L, B, Hkv, 1, D] int8
            torch.stack([p[1] for p in pending]),   # [L, B, Hkv, 1, 1] f32
            torch.stack([p[2] for p in pending]),
            torch.stack([p[3] for p in pending]),
            positions)

    x = rms_norm(x, params["final_norm"], cfg.rms_eps, p1)
    if logit_positions is not None:
        x = x[torch.arange(b, device=x.device), logit_positions.long()][:, None]
    logits = _mm(x, params["lm_head"], torch.float32)
    if cfg.logits_scaling != 1.0:
        logits = logits / cfg.logits_scaling
    if cfg.final_softcap:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits, cache


def init_kv_cache(cfg: LlamaConfig, batch: int,
                  max_len: Optional[int] = None, *,
                  device: DeviceLike = None) -> KVCache:
    """Stacked per-layer cache (kv8, or kv4 at cfg.kv_bits 4): leaves have
    a leading n_layers axis."""
    one = kv_cache_init(batch, cfg.n_kv_heads, max_len or cfg.max_seq_len,
                        cfg.head_dim, cfg.kv_bits, device=device)
    return KVCache(*(torch.stack([t] * cfg.n_layers) for t in one.tensors()))


def prefill(cfg: LlamaConfig, params: Dict, tokens: torch.Tensor,
            cache: KVCache, last_positions: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, KVCache]:
    """Run the prompt through the model, filling the cache.  Returns logits
    at `last_positions` (default: the final position) [B, V] and the
    cache."""
    b, t = tokens.shape
    if last_positions is None:
        last_positions = torch.full((b,), t - 1, dtype=torch.int32,
                                    device=tokens.device)
    logits, cache = forward(cfg, params, tokens, cache=cache,
                            attend_in_layer=True,
                            logit_positions=last_positions, kv_write_start=0)
    return logits[:, 0], cache


def decode_step(cfg: LlamaConfig, params: Dict, token: torch.Tensor,
                position: torch.Tensor, cache: KVCache,
                attn_window: Optional[int] = None
                ) -> Tuple[torch.Tensor, KVCache]:
    """One autoregressive step: token [B] int32, position [B] int32."""
    logits, cache = forward(cfg, params, token[:, None],
                            positions=position[:, None], cache=cache,
                            attn_window=attn_window)
    return logits[:, 0], cache
