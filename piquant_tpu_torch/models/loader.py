"""HF checkpoint loader -> the port's param pytree (counterpart of
piquant_tpu/models/loader.py).

`config_from_hf` maps a transformers config (or the dict of a checkpoint's
config.json) onto `LlamaConfig`, field for field as the reference does,
for every family the port has: Llama / Llama-3.1 (llama3 rope scaling),
Mistral, Qwen2 / Qwen3, Qwen2-MoE / Qwen3-MoE, Mixtral, Phi-3, Gemma-1/2/3,
Granite, SmolLM3, GPT-OSS (YaRN) and Llama-4.  `params_from_state_dict`
maps a state dict onto the model's layout: nn.Linear's [out, in] weights
transposed to [in, out], Phi-3's fused qkv / gate_up split, the experts
stacked, and the rotate-half rope convention of HF folded into the q/k
columns (their biases and qk-norm weights too) as the interleaved pairs
models/llama.py rotates: the values are the reference's bit for bit, and
every transpose, permutation and stack is a torch op on the device the
caller names.  `load_from_hf` takes a transformers model instance or a
local checkpoint directory (config.json and safetensors shards, read by
utils/safetensors_io.py: neither transformers nor safetensors is needed),
with round-to-nearest quantization (`quantize_params`) and fused
projections on request.

The loader raises on a missing tensor, on a tensor whose shape does not
match the config and on a dtype it does not read; the calibrated
quantizers (awq, gptq, smooth, rotate) raise NotImplementedError naming
their ROADMAP.md item.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import torch

from piquant_tpu_torch._device import DeviceLike, resolve_device
from piquant_tpu_torch.models.llama import (Llama3Rope, LlamaConfig,
                                            YarnRope, _tp_not_ported,
                                            fuse_layer_projections,
                                            quantize_params)

METHODS = ("rtn", "rotate", "awq", "gptq", "smooth")


class _Fields:
    """A config.json dict read as a transformers config is: attributes,
    with getattr defaults for the keys it lacks."""

    def __init__(self, d: Dict[str, Any]):
        self.__dict__.update(d)

    def __getattr__(self, name):
        raise AttributeError(f"config.json has no {name!r}")


def config_from_hf(hf_config: Any, dtype: torch.dtype = torch.bfloat16
                   ) -> LlamaConfig:
    """A transformers config object, or the dict parsed from config.json
    -> LlamaConfig (the reference's mapping, field for field)."""
    if isinstance(hf_config, dict):
        hf_config = _Fields(hf_config)
    mtype = getattr(hf_config, "model_type", "")
    is_gemma3 = mtype in ("gemma3", "gemma3_text")
    is_gemma = mtype in ("gemma", "gemma2") or is_gemma3
    is_gemma2 = mtype == "gemma2" or is_gemma3  # sandwich-norm generation
    is_gpt_oss = mtype == "gpt_oss"
    is_llama4 = mtype in ("llama4_text", "llama4")
    is_granite = mtype == "granite"
    # SmolLM3: llama + NoPE every `no_rope_layer_interval`-th layer
    # (no_rope_layers[i] == 0 => layer i skips rope, at (i+1) % p == 0)
    smollm3_nope = None
    if mtype == "smollm3":
        nrl = list(getattr(hf_config, "no_rope_layers", []) or [])
        p0 = int(getattr(hf_config, "no_rope_layer_interval", 0) or 0)
        if nrl:
            zeros = [i for i, v in enumerate(nrl) if not v]
            if zeros:
                p0 = zeros[0] + 1
                if any((i + 1) % p0 != 0 for i in zeros) or (
                        len(zeros) != len(nrl) // p0):
                    raise ValueError(
                        f"irregular smollm3 no_rope_layers: {nrl}")
        smollm3_nope = p0 or None
    default_hd = hf_config.hidden_size // hf_config.num_attention_heads
    hd = getattr(hf_config, "head_dim", default_hd) or default_hd
    qpas = getattr(hf_config, "query_pre_attn_scalar", None)
    rs = getattr(hf_config, "rope_scaling", None)
    rtype = rs.get("rope_type", rs.get("type")) if rs else None
    llama3_rope = yarn = None
    if rtype == "llama3":
        llama3_rope = Llama3Rope(
            factor=rs["factor"],
            low_freq_factor=rs.get("low_freq_factor", 1.0),
            high_freq_factor=rs.get("high_freq_factor", 4.0),
            original_max_position_embeddings=rs.get(
                "original_max_position_embeddings", 8192))
    if rtype == "yarn":
        yarn = YarnRope(
            factor=rs["factor"],
            original_max_position_embeddings=rs.get(
                "original_max_position_embeddings",
                hf_config.max_position_embeddings),
            beta_fast=rs.get("beta_fast") or 32.0,
            beta_slow=rs.get("beta_slow") or 1.0,
            attention_factor=rs.get("attention_factor"),
            truncate=bool(rs.get("truncate", True)))
    # alternating sliding/full layout (Gemma-2, GPT-OSS): period of the
    # layer_types list when it alternates, else None
    if is_gemma3:
        sliding_pattern = getattr(hf_config, "sliding_window_pattern",
                                  None) or 6
    elif is_gemma2:
        sliding_pattern = 2
    else:
        sliding_pattern = None
    lt = getattr(hf_config, "layer_types", None)
    if lt and "sliding_attention" in lt and "full_attention" in lt:
        # full-attention layers at (li+1) % p == 0 for some period p
        fulls = [i for i, t in enumerate(lt) if t == "full_attention"]
        p0 = fulls[0] + 1
        if all((i + 1) % p0 == 0 for i in fulls) and len(fulls) == len(lt) // p0:
            sliding_pattern = p0
    return LlamaConfig(
        vocab_size=hf_config.vocab_size,
        d_model=hf_config.hidden_size,
        n_layers=hf_config.num_hidden_layers,
        n_heads=hf_config.num_attention_heads,
        n_kv_heads=getattr(hf_config, "num_key_value_heads",
                           hf_config.num_attention_heads),
        d_ff=(getattr(hf_config, "intermediate_size_mlp", None)
              if is_llama4 else None) or hf_config.intermediate_size,
        rope_theta=getattr(hf_config, "rope_theta", 10_000.0),
        rms_eps=getattr(hf_config, "rms_norm_eps", 1e-5),
        max_seq_len=getattr(hf_config, "max_position_embeddings", 8192),
        qkv_bias=bool(getattr(hf_config, "attention_bias", False)
                      or mtype in ("qwen2", "qwen2_moe", "gpt_oss")),
        head_dim_override=hd if hd != default_hd else None,
        # Qwen2 configs carry sliding_window with use_sliding_window=False
        sliding_window=(getattr(hf_config, "sliding_window", None)
                        if getattr(hf_config, "use_sliding_window", True)
                        else None),
        norm_plus_one=is_gemma,
        mlp_act="gelu" if is_gemma else "silu",
        scale_embed=is_gemma,
        sandwich_norms=is_gemma2,
        attn_softcap=getattr(hf_config, "attn_logit_softcapping", None)
        if is_gemma2 else None,
        final_softcap=getattr(hf_config, "final_logit_softcapping", None)
        if is_gemma2 else None,
        attn_scale_override=(qpas ** -0.5 if is_gemma2 and qpas
                             else float(hf_config.attention_multiplier)
                             if is_granite else None),
        rope_theta_local=(getattr(hf_config, "rope_local_base_freq", None)
                          if is_gemma3 else None),
        rope_linear_factor=(rs["factor"] if is_gemma3 and rtype == "linear"
                            else None),
        sliding_pattern=sliding_pattern,
        attn_sinks=is_gpt_oss,
        o_bias=is_gpt_oss,
        router_bias=is_gpt_oss,
        moe_bias=is_gpt_oss,
        moe_clamp_swiglu=is_gpt_oss,
        yarn=yarn,
        llama3_rope=llama3_rope,
        rope_interleaved=is_llama4,
        qk_l2norm=bool(is_llama4 and getattr(hf_config, "use_qk_norm", False)),
        nope_pattern=(_llama4_nope_pattern(hf_config) if is_llama4
                      else smollm3_nope),
        embed_multiplier=(float(hf_config.embedding_multiplier)
                          if is_granite else None),
        residual_multiplier=(float(hf_config.residual_multiplier)
                             if is_granite else 1.0),
        logits_scaling=(float(hf_config.logits_scaling)
                        if is_granite else 1.0),
        attn_temp_tuning=bool(
            is_llama4 and getattr(hf_config, "attn_temperature_tuning", False)),
        floor_scale=float(getattr(hf_config, "floor_scale", 8192.0)),
        temp_attn_scale=float(getattr(hf_config, "attn_scale", 0.1)),
        chunk_window=(getattr(hf_config, "attention_chunk_size", None)
                      if is_llama4 else None),
        moe_every=(getattr(hf_config, "interleave_moe_layer_step", None)
                   if is_llama4 else None),
        moe_input_scaled=is_llama4,
        shared_expert_gated=not is_llama4,
        # Phi family: rotate only partial_rotary_factor of the head dim
        rotary_dim_override=(
            int(hf_config.partial_rotary_factor * hd)
            if getattr(hf_config, "partial_rotary_factor", 1.0) != 1.0
            else None),
        # Mixtral / Qwen2-MoE / Qwen3-MoE
        n_experts=(getattr(hf_config, "num_local_experts", 0)
                   or getattr(hf_config, "num_experts", 0) or 0),
        moe_top_k=getattr(hf_config, "num_experts_per_tok", 2) or 2,
        moe_d_ff=(getattr(hf_config, "moe_intermediate_size", None)
                  or (hf_config.intermediate_size
                      if is_gpt_oss or is_llama4 else None)),
        shared_expert_d_ff=(hf_config.intermediate_size if is_llama4 else
                            getattr(hf_config,
                                    "shared_expert_intermediate_size", None)),
        moe_renormalize=bool(getattr(hf_config, "norm_topk_prob", True)),
        # per-head RMSNorm on q/k before rope
        qk_norm=mtype in ("qwen3", "qwen3_moe") or is_gemma3,
        dtype=dtype,
    )


def _llama4_nope_pattern(hf_config) -> Optional[int]:
    """The nope period from no_rope_layers (1 = rope, 0 = nope); raises
    for a layout the periodic nope_pattern cannot represent."""
    nrl = getattr(hf_config, "no_rope_layers", None)
    if not nrl:
        return int(getattr(hf_config, "no_rope_layer_interval", None) or 4)
    nope = [i for i, use_rope in enumerate(nrl) if not use_rope]
    if not nope:
        return None  # all layers rope
    period = nope[0] + 1
    expect = [i for i in range(len(nrl)) if (i + 1) % period == 0]
    if nope != expect:
        raise ValueError(f"no_rope_layers {nrl} is not periodic; "
                         "unsupported Llama-4 rope layout")
    return period


def _half_to_interleaved_perm(head_dim: int, dev) -> torch.Tensor:
    """Permutation p with interleaved[j] = half[p[j]]: (2i) <- i,
    (2i+1) <- i + head_dim // 2."""
    h = head_dim // 2
    p = torch.empty(head_dim, dtype=torch.long, device=dev)
    p[0::2] = torch.arange(h, device=dev)
    p[1::2] = torch.arange(h, device=dev) + h
    return p


def _head_perm(head_dim: int, rotary_dim: Optional[int], dev) -> torch.Tensor:
    """A head's column permutation: the first rotary_dim columns from
    half-rotation to interleaved order, the rest in place (partial
    rotary)."""
    rd = rotary_dim or head_dim
    p = torch.arange(head_dim, dtype=torch.long, device=dev)
    p[:rd] = _half_to_interleaved_perm(rd, dev)
    return p


def _permute_rope_cols(w: torch.Tensor, n_heads: int, head_dim: int,
                       rotary_dim: Optional[int] = None) -> torch.Tensor:
    """w [rows, n_heads * head_dim] (already transposed): each head's
    columns permuted by `_head_perm`."""
    p = _head_perm(head_dim, rotary_dim, w.device)
    rows = w.shape[0]
    return w.reshape(rows, n_heads, head_dim)[:, :, p].reshape(
        rows, n_heads * head_dim)


def params_from_state_dict(state_dict: Dict[str, Any], cfg: LlamaConfig, *,
                           device: DeviceLike = None) -> Dict:
    """A transformers state dict (torch tensors or numpy arrays, on any
    device) -> the port's param pytree on `device` (default CUDA), leaf
    for leaf the reference's `params_from_state_dict`."""
    dev = resolve_device(device)
    dt = cfg.dtype
    hd = cfg.head_dim
    d = cfg.d_model
    nq, nkv = cfg.n_heads * hd, cfg.n_kv_heads * hd

    def get(name, shape):
        """The tensor `name` on dev, float, of `shape`."""
        if name not in state_dict:
            raise KeyError(f"checkpoint has no tensor {name!r}")
        t = torch.as_tensor(state_dict[name])
        if not t.is_floating_point():
            raise TypeError(f"{name}: dtype {t.dtype}, not a float the "
                            "loader reads")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, the config "
                             f"asks for {tuple(shape)}")
        return t.detach().to(dev)

    def vec(name, n, out_dtype=None):
        return get(name, (n,)).to(out_dtype or dt)

    def lin(name, n_out, n_in):
        # nn.Linear stores [out, in]; the model's matmul takes [in, out]
        return get(name, (n_out, n_in)).to(dt).t().contiguous()

    def raw(name, shape, out_dtype=None):
        return get(name, shape).to(out_dtype or dt).contiguous()

    embed = get("model.embed_tokens.weight", (cfg.vocab_size, d))
    params: Dict[str, Any] = {
        "embed": embed.to(dt).contiguous(),
        "final_norm": vec("model.norm.weight", d),
        "layers": [],
    }
    if "lm_head.weight" in state_dict:
        params["lm_head"] = lin("lm_head.weight", cfg.vocab_size, d)
    else:  # tied embeddings
        params["lm_head"] = embed.to(dt).t().contiguous()
    del embed

    rd = cfg.rotary_dim
    for i in range(cfg.n_layers):
        pre = f"model.layers.{i}."
        if pre + "self_attn.qkv_proj.weight" in state_dict:
            # Phi-3: fused [q; k; v] rows -> split along the output dim
            qkv = lin(pre + "self_attn.qkv_proj.weight", nq + 2 * nkv, d)
            wq_raw, wk_raw = qkv[:, :nq], qkv[:, nq:nq + nkv]
            wv = qkv[:, nq + nkv:].contiguous()
        else:
            wq_raw = lin(pre + "self_attn.q_proj.weight", nq, d)
            wk_raw = lin(pre + "self_attn.k_proj.weight", nkv, d)
            wv = lin(pre + "self_attn.v_proj.weight", nkv, d)
        if cfg.rope_interleaved:  # Llama-4: checkpoint already interleaved
            wq, wk = wq_raw.contiguous(), wk_raw.contiguous()
        else:
            wq = _permute_rope_cols(wq_raw, cfg.n_heads, hd, rd)
            wk = _permute_rope_cols(wk_raw, cfg.n_kv_heads, hd, rd)
        del wq_raw, wk_raw
        if pre + "pre_feedforward_layernorm.weight" in state_dict:
            # Gemma-2 sandwich norms: post_attention_layernorm norms the
            # attention OUTPUT (not the MLP input as in Llama)
            pre_mlp = pre + "pre_feedforward_layernorm.weight"
        else:
            pre_mlp = pre + "post_attention_layernorm.weight"
        layer: Dict[str, Any] = {
            "attn_norm": vec(pre + "input_layernorm.weight", d),
            "mlp_norm": vec(pre_mlp, d),
            "wq": wq, "wk": wk, "wv": wv,
            "wo": lin(pre + "self_attn.o_proj.weight", d, nq),
        }
        if cfg.sandwich_norms:
            layer["post_attn_norm"] = vec(
                pre + "post_attention_layernorm.weight", d)
            layer["post_mlp_norm"] = vec(
                pre + "post_feedforward_layernorm.weight", d)
        if cfg.o_bias and pre + "self_attn.o_proj.bias" in state_dict:
            layer["bo"] = vec(pre + "self_attn.o_proj.bias", d)
        if cfg.attn_sinks:
            layer["sinks"] = vec(pre + "self_attn.sinks", cfg.n_heads,
                                 torch.float32)
        ne, f = cfg.n_experts, cfg.moe_d_ff or cfg.d_ff
        sf = cfg.shared_expert_d_ff
        if pre + "mlp.router.weight" in state_dict:
            # GPT-OSS: router with bias; experts store fused [E, D, 2F]
            # gate_up with INTERLEAVED gate/up columns + per-expert biases;
            # weights are already [din, dout] (not nn.Linear)
            layer["router"] = lin(pre + "mlp.router.weight", ne, d)
            layer["router_b"] = vec(pre + "mlp.router.bias", ne,
                                    torch.float32)
            gu = raw(pre + "mlp.experts.gate_up_proj", (ne, d, 2 * f))
            gub = raw(pre + "mlp.experts.gate_up_proj_bias", (ne, 2 * f),
                      torch.float32)
            layer["moe_w1"] = gu[:, :, 0::2].contiguous()
            layer["moe_w3"] = gu[:, :, 1::2].contiguous()
            layer["moe_b1"] = gub[:, 0::2].contiguous()
            layer["moe_b3"] = gub[:, 1::2].contiguous()
            del gu, gub
            layer["moe_w2"] = raw(pre + "mlp.experts.down_proj", (ne, f, d))
            layer["moe_b2"] = raw(pre + "mlp.experts.down_proj_bias",
                                  (ne, d), torch.float32)
        elif pre + "feed_forward.router.weight" in state_dict:
            # Llama-4: fused [E, D, 2F] gate_up with CONTIGUOUS halves
            # (torch .chunk(2, dim=-1)); ungated shared expert
            layer["router"] = lin(pre + "feed_forward.router.weight", ne, d)
            gu = raw(pre + "feed_forward.experts.gate_up_proj",
                     (ne, d, 2 * f))
            layer["moe_w1"] = gu[:, :, :f].contiguous()
            layer["moe_w3"] = gu[:, :, f:].contiguous()
            del gu
            layer["moe_w2"] = raw(pre + "feed_forward.experts.down_proj",
                                  (ne, f, d))
            sh = pre + "feed_forward.shared_expert."
            layer["shared_w1"] = lin(sh + "gate_proj.weight", sf, d)
            layer["shared_w3"] = lin(sh + "up_proj.weight", sf, d)
            layer["shared_w2"] = lin(sh + "down_proj.weight", d, sf)
        elif pre + "feed_forward.gate_proj.weight" in state_dict:
            # Llama-4 dense (non-MoE interleave) layer
            ff = pre + "feed_forward."
            layer["w1"] = lin(ff + "gate_proj.weight", cfg.d_ff, d)
            layer["w3"] = lin(ff + "up_proj.weight", cfg.d_ff, d)
            layer["w2"] = lin(ff + "down_proj.weight", d, cfg.d_ff)
        elif pre + "mlp.gate.weight" in state_dict:
            # Qwen2-MoE / Qwen3-MoE: router + experts under mlp., Qwen2-MoE
            # with a sigmoid-gated shared expert as well
            layer["router"] = lin(pre + "mlp.gate.weight", ne, d)
            ep = pre + "mlp.experts."
            for key, proj, shape in (("moe_w1", "gate_proj", (f, d)),
                                     ("moe_w3", "up_proj", (f, d)),
                                     ("moe_w2", "down_proj", (d, f))):
                layer[key] = torch.stack([
                    lin(f"{ep}{e}.{proj}.weight", *shape) for e in range(ne)])
            sh = pre + "mlp.shared_expert."
            if sh + "gate_proj.weight" in state_dict:
                layer["shared_w1"] = lin(sh + "gate_proj.weight", sf, d)
                layer["shared_w3"] = lin(sh + "up_proj.weight", sf, d)
                layer["shared_w2"] = lin(sh + "down_proj.weight", d, sf)
                layer["shared_gate"] = lin(
                    pre + "mlp.shared_expert_gate.weight", 1, d)
        elif pre + "block_sparse_moe.gate.weight" in state_dict:
            # Mixtral: router + per-expert w1 (gate), w3 (up), w2 (down)
            layer["router"] = lin(pre + "block_sparse_moe.gate.weight", ne, d)
            ep = pre + "block_sparse_moe.experts."
            for key, proj, shape in (("moe_w1", "w1", (f, d)),
                                     ("moe_w3", "w3", (f, d)),
                                     ("moe_w2", "w2", (d, f))):
                layer[key] = torch.stack([
                    lin(f"{ep}{e}.{proj}.weight", *shape) for e in range(ne)])
        else:
            if pre + "mlp.gate_up_proj.weight" in state_dict:
                # Phi-3: fused [gate; up]
                gu = lin(pre + "mlp.gate_up_proj.weight", 2 * cfg.d_ff, d)
                w1 = gu[:, :cfg.d_ff].contiguous()
                w3 = gu[:, cfg.d_ff:].contiguous()
                del gu
            else:
                w1 = lin(pre + "mlp.gate_proj.weight", cfg.d_ff, d)
                w3 = lin(pre + "mlp.up_proj.weight", cfg.d_ff, d)
            layer["w1"], layer["w3"] = w1, w3
            layer["w2"] = lin(pre + "mlp.down_proj.weight", d, cfg.d_ff)
        if cfg.qk_norm:
            # the per-head norm weights follow the permutation folded into
            # wq / wk (rms over the head dim is permutation-invariant)
            pn = _head_perm(hd, rd, dev)
            layer["q_norm"] = vec(pre + "self_attn.q_norm.weight", hd)[pn]
            layer["k_norm"] = vec(pre + "self_attn.k_norm.weight", hd)[pn]
        if cfg.qkv_bias:
            # the biases take their projections' permutation (over the
            # whole head, as the reference permutes them)
            layer["bq"] = _permute_rope_cols(
                vec(pre + "self_attn.q_proj.bias", nq)[None], cfg.n_heads,
                hd)[0]
            layer["bk"] = _permute_rope_cols(
                vec(pre + "self_attn.k_proj.bias", nkv)[None], cfg.n_kv_heads,
                hd)[0]
            layer["bv"] = vec(pre + "self_attn.v_proj.bias", nkv)
        params["layers"].append(layer)
    return params


def read_config(directory) -> Dict[str, Any]:
    """The dict of a checkpoint directory's config.json."""
    with open(os.path.join(directory, "config.json")) as f:
        return json.load(f)


def _check_method(method: str) -> None:
    """The reference's method grammar; every quantizer but "rtn" raises
    NotImplementedError (queue 1 item 13)."""
    steps = method.split("+")
    if (not steps or len(set(steps)) != len(steps)
            or any(s not in METHODS for s in steps)
            or ("rtn" in steps and len(steps) > 1 + ("rotate" in steps))):
        raise ValueError(f"unknown quantization method {method!r}")
    if steps != ["rtn"]:
        raise NotImplementedError(
            f"quantization method {method!r}: the calibrated quantizers "
            "(awq, gptq, smooth, rotate) are not ported yet (ROADMAP.md "
            "queue 1 item 13)")


def load_from_hf(model_or_path, dtype: torch.dtype = torch.bfloat16,
                 quantize_bits: Optional[int] = None, *,
                 group_size: Optional[int] = None, method: str = "rtn",
                 fuse: bool = False, tp: int = 1,
                 device: DeviceLike = None) -> Tuple[LlamaConfig, Dict]:
    """(cfg, params) from a transformers model instance or a local
    checkpoint directory (config.json and model.safetensors or shards with
    model.safetensors.index.json), on `device` (default CUDA).
    `quantize_bits` quantizes every projection by round to nearest
    (`quantize_params`, with `group_size`); `fuse` fuses wq/wk/wv -> wqkv
    and w1/w3 -> w13 after it (tp > 1 raises: queue 1 item 16b)."""
    dev = resolve_device(device)
    if quantize_bits is not None:
        _check_method(method)
    if fuse:
        _tp_not_ported(tp)
    if isinstance(model_or_path, (str, os.PathLike)):
        from piquant_tpu_torch.utils.safetensors_io import load_checkpoint

        cfg = config_from_hf(read_config(model_or_path), dtype)
        state = load_checkpoint(model_or_path, dev)
    else:
        cfg = config_from_hf(model_or_path.config, dtype)
        state = model_or_path.state_dict()
    params = params_from_state_dict(state, cfg, device=dev)
    del state
    if quantize_bits is not None:
        params = quantize_params(params, bits=quantize_bits,
                                 group_size=group_size)
    if fuse:
        params = fuse_layer_projections(params, cfg, tp=tp)
    return cfg, params
