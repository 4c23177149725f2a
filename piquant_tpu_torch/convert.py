"""Carry parameters, caches and configs across from the JAX package.

Nothing here imports JAX or piquant_tpu: leaves are read with `np.asarray`
(which JAX arrays support) and structured leaves by duck typing, so the
same numbers reach both packages in the tests.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from piquant_tpu_torch._device import DeviceLike, resolve_device
from piquant_tpu_torch.api import QuantizedTensor
from piquant_tpu_torch.dtypes import dtype_of
from piquant_tpu_torch.models.llama import Llama3Rope, LlamaConfig, YarnRope
from piquant_tpu_torch.quant.kv_cache import KVCache
from piquant_tpu_torch.quant.linear import (QuantizedExpertStack,
                                            QuantizedLinear)

_CONFIG_FIELDS = ("vocab_size", "d_model", "n_layers", "n_heads",
                  "n_kv_heads", "d_ff", "rope_theta", "rms_eps",
                  "max_seq_len", "head_dim_override", "qkv_bias",
                  "sliding_window", "rotary_dim_override", "qk_norm",
                  "norm_plus_one", "mlp_act", "scale_embed",
                  "embed_multiplier", "residual_multiplier",
                  "logits_scaling", "sandwich_norms", "attn_softcap",
                  "final_softcap", "attn_scale_override", "sliding_pattern",
                  "rope_theta_local", "rope_linear_factor", "kv_bits",
                  "act_quant_prefill", "act_quant_decode", "n_experts",
                  "moe_top_k", "moe_d_ff", "moe_renormalize", "moe_every",
                  "attn_sinks", "o_bias", "qk_l2norm", "nope_pattern",
                  "attn_temp_tuning", "floor_scale", "temp_attn_scale",
                  "chunk_window", "rope_interleaved", "router_bias",
                  "moe_bias", "moe_clamp_swiglu", "moe_input_scaled",
                  "shared_expert_d_ff", "shared_expert_gated")


def tensor_from_numpy(a, device: torch.device) -> torch.Tensor:
    """Any array-like (numpy, JAX, ml_dtypes bfloat16) -> torch tensor."""
    a = np.array(a, order="C")   # a writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _is_quantized_linear(leaf) -> bool:
    return all(hasattr(leaf, a) for a in
               ("data", "scale", "zero_point", "bits", "k", "group_size"))


def _is_expert_stack(leaf) -> bool:
    """A QuantizedExpertStack: checked before `_is_quantized_linear`, whose
    fields it also has (its data is [E, rows, N])."""
    return _is_quantized_linear(leaf) and (
        hasattr(leaf, "n_experts") or np.ndim(leaf.data) == 3)


def _fields(leaf, device: torch.device) -> dict:
    """The fields of an INT2/INT4/INT8 or NF4 weight or expert stack, byte
    for byte, grouped side streams (bf16 s_chunk, int8 z_chunk) and the
    codebook name included."""
    codebook = getattr(leaf, "codebook", None)
    if codebook not in (None, "nf4") or leaf.bits not in (2, 4, 8) or (
            codebook and leaf.bits != 4):
        raise ValueError(f"unknown weight format: bits={leaf.bits}, "
                         f"codebook={codebook}")

    def side(name, dtype):
        a = getattr(leaf, name, None)
        return None if a is None else tensor_from_numpy(a, device).to(dtype)

    return dict(
        data=tensor_from_numpy(leaf.data, device).to(torch.uint8),
        scale=tensor_from_numpy(leaf.scale, device).to(torch.float32),
        zero_point=tensor_from_numpy(leaf.zero_point, device).to(torch.int32),
        bits=int(leaf.bits), k=int(leaf.k),
        group_size=(None if leaf.group_size is None else int(leaf.group_size)),
        s_chunk=side("s_chunk", torch.bfloat16),
        z_chunk=side("z_chunk", torch.int8), codebook=codebook)


def params_from_jax(tree, *, device: DeviceLike = None):
    """The JAX package's parameter pytree (dicts and lists of arrays,
    quantized linears and expert stacks) -> the port's, leaf for leaf."""
    dev = resolve_device(device)

    def conv(leaf):
        if isinstance(leaf, dict):
            return {k: conv(v) for k, v in leaf.items()}
        if isinstance(leaf, (list, tuple)):
            return [conv(v) for v in leaf]
        if _is_expert_stack(leaf):
            return QuantizedExpertStack(**_fields(leaf, dev))
        if _is_quantized_linear(leaf):
            return QuantizedLinear(**_fields(leaf, dev))
        return tensor_from_numpy(leaf, dev)

    return conv(tree)


def quantized_tensor_from_jax(qt, *, device: DeviceLike = None
                              ) -> QuantizedTensor:
    """A JAX QuantizedTensor -> the port's, byte for byte: the packed data
    in the registry's storage dtype, f32 scale, int32 zero point."""
    dev = resolve_device(device)
    dt = dtype_of(qt.qdtype)
    data = np.ascontiguousarray(np.asarray(qt.data).reshape(-1))
    return QuantizedTensor(
        data=tensor_from_numpy(data, dev).view(dt.storage),
        scale=tensor_from_numpy(np.asarray(qt.scale, np.float32), dev),
        zero_point=tensor_from_numpy(np.asarray(qt.zero_point, np.int32), dev),
        qdtype=dt.name, shape=tuple(int(s) for s in qt.shape))


def kv_cache_from_jax(cache, *, device: DeviceLike = None) -> KVCache:
    """A JAX KVCache (kv8 or the pair-packed kv4, stacked or not) -> the
    port's, byte for byte."""
    dev = resolve_device(device)
    return KVCache(*(tensor_from_numpy(getattr(cache, f), dev) for f in
                     ("k_codes", "v_codes", "k_scale", "v_scale", "length")))


def config_from_jax(jcfg) -> LlamaConfig:
    """The JAX package's LlamaConfig -> the port's.  The Mistral / Qwen /
    Phi-3 flags (qkv_bias, sliding_window, rotary_dim_override, qk_norm),
    the Gemma / Granite ones (norm_plus_one, mlp_act, scale_embed,
    embed_multiplier, residual_multiplier, logits_scaling, sandwich_norms,
    the two softcaps, attn_scale_override, sliding_pattern and the local /
    global rope), the GPT-OSS ones (attn_sinks, o_bias, YaRN, router_bias,
    moe_bias, moe_clamp_swiglu) and the Llama-4 ones (nope layers and
    temperature tuning, qk_l2norm, chunk_window, rope_interleaved,
    moe_input_scaled, the shared expert) carry across; expert parallelism
    (ep_axis, moe_a2a and its capacity and wire settings), which the port
    does not have yet, raises NotImplementedError when set off its
    default."""
    kw = {f: getattr(jcfg, f) for f in _CONFIG_FIELDS}
    handled = set(_CONFIG_FIELDS) | {"llama3_rope", "yarn", "dtype"}
    unsupported = [f.name for f in dataclasses.fields(jcfg)
                   if f.name not in handled
                   and getattr(jcfg, f.name) != f.default]
    if unsupported:
        raise NotImplementedError(
            f"LlamaConfig flags not ported yet: {unsupported} (expert "
            "parallelism: ROADMAP.md queue 1 item 16)")
    if jcfg.llama3_rope is not None:
        r = jcfg.llama3_rope
        kw["llama3_rope"] = Llama3Rope(
            r.factor, r.low_freq_factor, r.high_freq_factor,
            r.original_max_position_embeddings)
    if jcfg.yarn is not None:
        y = jcfg.yarn
        kw["yarn"] = YarnRope(y.factor, y.original_max_position_embeddings,
                              y.beta_fast, y.beta_slow, y.attention_factor,
                              y.truncate)
    name = np.dtype(jcfg.dtype).name
    kw["dtype"] = {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]
    return LlamaConfig(**kw)
