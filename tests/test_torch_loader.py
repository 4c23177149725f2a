"""The port's HF loader, weight cache and safetensors files against the JAX
package's on the CPU.

One tiny random-init transformers model a family (2 layers, hidden 64,
fixed seeds, as tests/test_loader.py builds them), saved with
save_pretrained(safe_serialization=True): the port loads the directory
(config.json and the safetensors file, read without transformers), the
JAX package the model instance.  Every leaf equal, INT4 codes and scales
bit for bit; the port's logits against JAX's (eager) and transformers'.
Then the weight cache and the safetensors export crossing between the two
packages both ways, and the container against the `safetensors`
package."""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import safetensors
import safetensors.torch
import torch
import transformers

from piquant_tpu.models import llama as JM
from piquant_tpu.models.loader import load_from_hf as j_load
from piquant_tpu.utils import safetensors_io as JST
from piquant_tpu.utils import weight_cache as JWC
from piquant_tpu_torch import convert
from piquant_tpu_torch.models import llama as TM
from piquant_tpu_torch.models import loader as TL
from piquant_tpu_torch.utils import safetensors_io as TST
from piquant_tpu_torch.utils import weight_cache as TWC
from _torch_threads import one_thread  # noqa: F401

SEED = 0x10AD
CPU = torch.device("cpu")

_BASE = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=64,
             rope_theta=10_000.0, rms_norm_eps=1e-5,
             attn_implementation="eager")

# family -> (config class, model class, config overrides, atol = rtol of
# the logits against transformers: tests/test_loader.py's for that family,
# else 2e-3; Gemma-2 3e-3 as its other Gemma models, since on this model
# the JAX package's own logits lie 2.26e-3 from transformers')
FAMILIES = {
    "llama": ("LlamaConfig", "LlamaForCausalLM", {}, 2e-3),
    "llama31": ("LlamaConfig", "LlamaForCausalLM", dict(
        max_position_embeddings=128, tie_word_embeddings=False,
        rope_scaling={"rope_type": "llama3", "factor": 8.0,
                      "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                      "original_max_position_embeddings": 32}), 2e-3),
    "mistral": ("MistralConfig", "MistralForCausalLM",
                dict(sliding_window=4), 3e-3),
    "qwen2": ("Qwen2Config", "Qwen2ForCausalLM", {}, 3e-3),
    "qwen3": ("Qwen3Config", "Qwen3ForCausalLM",
              dict(head_dim=16, tie_word_embeddings=False), 2e-3),
    "qwen2_moe": ("Qwen2MoeConfig", "Qwen2MoeForCausalLM", dict(
        num_experts=4, num_experts_per_tok=2, moe_intermediate_size=32,
        shared_expert_intermediate_size=48, decoder_sparse_step=1,
        tie_word_embeddings=False), 2e-3),
    "qwen3_moe": ("Qwen3MoeConfig", "Qwen3MoeForCausalLM", dict(
        head_dim=16, num_experts=4, num_experts_per_tok=2,
        moe_intermediate_size=32, norm_topk_prob=True,
        tie_word_embeddings=False), 2e-3),
    "mixtral": ("MixtralConfig", "MixtralForCausalLM", dict(
        num_local_experts=4, num_experts_per_tok=2), 2e-3),
    "phi3": ("Phi3Config", "Phi3ForCausalLM", dict(
        partial_rotary_factor=0.5, pad_token_id=0, bos_token_id=1,
        eos_token_id=2), 2e-3),
    "gemma": ("GemmaConfig", "GemmaForCausalLM", dict(
        num_key_value_heads=1, head_dim=32), 3e-3),
    "gemma2": ("Gemma2Config", "Gemma2ForCausalLM", dict(
        head_dim=16, query_pre_attn_scalar=24, attn_logit_softcapping=50.0,
        final_logit_softcapping=30.0, sliding_window=6, pad_token_id=0,
        tie_word_embeddings=False), 3e-3),
    "gemma3": ("Gemma3TextConfig", "Gemma3ForCausalLM", dict(
        head_dim=16, query_pre_attn_scalar=24, sliding_window=6,
        layer_types=["sliding_attention", "full_attention"],
        rope_theta=1_000_000.0, rope_local_base_freq=10_000.0,
        rope_scaling={"rope_type": "linear", "factor": 8.0},
        pad_token_id=0, tie_word_embeddings=False), 3e-3),
    "granite": ("GraniteConfig", "GraniteForCausalLM", dict(
        embedding_multiplier=12.0, residual_multiplier=0.22,
        attention_multiplier=0.03, logits_scaling=8.0,
        tie_word_embeddings=True), 2e-3),
    "smollm3": ("SmolLM3Config", "SmolLM3ForCausalLM", dict(
        no_rope_layers=[1, 0], no_rope_layer_interval=2,
        use_sliding_window=False, pad_token_id=0,
        tie_word_embeddings=False), 2e-3),
    "gpt_oss": ("GptOssConfig", "GptOssForCausalLM", dict(
        intermediate_size=48, head_dim=16, num_local_experts=4,
        num_experts_per_tok=2, sliding_window=6, pad_token_id=0,
        tie_word_embeddings=False), 3e-3),
    "llama4": ("Llama4TextConfig", "Llama4ForCausalLM", dict(
        intermediate_size=48, intermediate_size_mlp=80, head_dim=16,
        num_local_experts=4, num_experts_per_tok=2,
        interleave_moe_layer_step=2, attention_chunk_size=8,
        no_rope_layer_interval=2, rope_scaling=None, pad_token_id=0,
        tie_word_embeddings=False), 3e-3),
}


def _hf_model(family, seed=SEED):
    conf_cls, model_cls, over, _ = FAMILIES[family]
    torch.manual_seed(seed + sorted(FAMILIES).index(family))
    conf = getattr(transformers, conf_cls)(**{**_BASE, **over})
    return getattr(transformers, model_cls)(conf).eval()


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """family -> (model, checkpoint directory), built once a module."""
    cache = {}

    def get(family):
        if family not in cache:
            model = _hf_model(family)
            path = tmp_path_factory.mktemp(family)
            model.save_pretrained(path, safe_serialization=True)
            cache[family] = (model, str(path))
        return cache[family]

    return get


def assert_trees_equal(mine, theirs, path=""):
    """The port's tree leaf for leaf equal to `theirs` (a port tree, or the
    JAX package's carried across by convert.params_from_jax): same keys,
    dtypes, shapes and bits; quantized leaves field for field."""
    if isinstance(mine, dict):
        assert set(mine) == set(theirs), (path, set(mine) ^ set(theirs))
        for k in mine:
            assert_trees_equal(mine[k], theirs[k], f"{path}/{k}")
    elif isinstance(mine, list):
        assert len(mine) == len(theirs), path
        for i, (a, b) in enumerate(zip(mine, theirs)):
            assert_trees_equal(a, b, f"{path}/{i}")
    elif isinstance(mine, torch.Tensor):
        assert mine.dtype == theirs.dtype, (path, mine.dtype, theirs.dtype)
        assert torch.equal(mine, theirs), path
    elif isinstance(mine, int):
        assert mine == theirs, path
    else:
        assert type(mine) is type(theirs), path
        assert (mine.bits, mine.k, mine.group_size, mine.codebook) == (
            theirs.bits, theirs.k, theirs.group_size, theirs.codebook), path
        for f in ("data", "scale", "zero_point", "s_chunk", "z_chunk"):
            a, b = getattr(mine, f), getattr(theirs, f)
            assert (a is None) == (b is None), (path, f)
            if a is not None:
                assert a.dtype == b.dtype and torch.equal(a, b), (path, f)


# ---------------------------------------------------------------------------
# every family against the JAX package's loader and transformers
# ---------------------------------------------------------------------------

# The port reads the saved directory, the JAX package the model instance:
# the config field for field, every float leaf equal in f32 and in bf16,
# and at INT4 every code, scale and zero point.
@pytest.mark.parametrize("family", list(FAMILIES))
def test_load_matches_jax(saved, family):
    model, path = saved(family)
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        jcfg, jparams = j_load(model, dtype=jdt)
        cfg, params = TL.load_from_hf(path, dtype=dt, device="cpu")
        assert cfg == convert.config_from_jax(jcfg)
        assert_trees_equal(params, convert.params_from_jax(jparams,
                                                           device=CPU))
    _, jq = j_load(model, quantize_bits=4)
    _, q = TL.load_from_hf(path, quantize_bits=4, device="cpu")
    assert isinstance(q["layers"][0]["wq"], TM.QuantizedLinear)
    assert_trees_equal(q, convert.params_from_jax(jq, device=CPU))


# Logits of a 10-token prompt (f32 weights): the port's forward against
# the JAX package's, run eagerly, within 2e-3, and against transformers'
# within the JAX package's own tolerance for the family
# (tests/test_loader.py: 2e-3, or 3e-3 where it states so).
@pytest.mark.parametrize("family", list(FAMILIES))
def test_logits_match_jax_and_transformers(saved, family):
    model, path = saved(family)
    tol = FAMILIES[family][3]
    jcfg, jparams = j_load(model, dtype=jnp.float32)
    cfg, params = TL.load_from_hf(path, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(SEED + 1)
    tokens = rng.integers(0, cfg.vocab_size, (2, 10))
    with torch.no_grad():
        want = model(torch.tensor(tokens)).logits.numpy()
    with jax.disable_jit():
        jgot = np.asarray(JM.forward(jcfg, jparams,
                                     jnp.asarray(tokens, jnp.int32))[0])
    got = TM.forward(cfg, params, torch.from_numpy(tokens).to(torch.int32))[0]
    got = got.numpy()
    np.testing.assert_allclose(got, jgot, atol=2e-3, rtol=2e-3)
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


# fuse=True (wqkv / w13 after INT4 quantization) against the unfused load:
# the same function within 2e-5 (tests/test_loader.py's bound).
@pytest.mark.parametrize("family", ["llama", "qwen3_moe"])
def test_load_fused_matches_unfused(saved, family):
    _, path = saved(family)
    cfg, pu = TL.load_from_hf(path, dtype=torch.float32, quantize_bits=4,
                              device="cpu")
    cfg2, pf = TL.load_from_hf(path, dtype=torch.float32, quantize_bits=4,
                               fuse=True, device="cpu")
    assert "wqkv" in pf["layers"][0] and "wq" not in pf["layers"][0]
    rng = np.random.default_rng(SEED + 4)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 9))).to(
        torch.int32)
    yu = TM.forward(cfg, pu, tokens)[0]
    yf = TM.forward(cfg2, pf, tokens)[0]
    np.testing.assert_allclose(yf.numpy(), yu.numpy(), atol=2e-5, rtol=2e-5)


def test_load_refuses(saved, tmp_path):
    """The calibrated quantizers and tensor-parallel fusion raise naming
    their items; the reference's method grammar stays; a missing tensor, a
    shape off the config and an integer weight raise."""
    model, path = saved("llama")
    for method in ("gptq", "awq", "smooth+gptq", "rotate", "rotate+rtn"):
        with pytest.raises(NotImplementedError, match=r"queue 1 item 13\b"):
            TL.load_from_hf(path, quantize_bits=4, method=method,
                            device="cpu")
    with pytest.raises(ValueError, match="unknown"):
        TL.load_from_hf(path, quantize_bits=4, method="hqq", device="cpu")
    with pytest.raises(NotImplementedError, match=r"queue 1 item 16b\b"):
        TL.load_from_hf(path, quantize_bits=4, fuse=True, tp=2, device="cpu")
    cfg = TL.config_from_hf(TL.read_config(path))
    sd = dict(model.state_dict())
    del sd["model.layers.1.mlp.down_proj.weight"]
    with pytest.raises(KeyError, match="down_proj"):
        TL.params_from_state_dict(sd, cfg, device="cpu")
    sd = dict(model.state_dict())
    sd["model.layers.0.self_attn.k_proj.weight"] = torch.zeros(64, 64)
    with pytest.raises(ValueError, match="k_proj"):
        TL.params_from_state_dict(sd, cfg, device="cpu")
    sd["model.layers.0.self_attn.k_proj.weight"] = torch.zeros(
        32, 64, dtype=torch.int8)
    with pytest.raises(TypeError, match="k_proj"):
        TL.params_from_state_dict(sd, cfg, device="cpu")
    # a dtype the container does not read (F8_E4M3)
    bad = tmp_path / "model.safetensors"
    hdr = json.dumps({"w": {"dtype": "F8_E4M3", "shape": [2],
                            "data_offsets": [0, 2]}}).encode()
    bad.write_bytes(len(hdr).to_bytes(8, "little") + hdr + b"\0\0")
    with pytest.raises(TypeError, match="F8_E4M3"):
        TST.load_file(str(bad), device="cpu")


def test_config_dict_matches_object():
    """config_from_hf on a config.json dict gives what it gives on the
    transformers object, for every family."""
    for family in FAMILIES:
        conf = _hf_model(family).config
        d = json.loads(conf.to_json_string())
        assert TL.config_from_hf(d) == TL.config_from_hf(conf), family


# A checkpoint written by the port in 3 shards with its index: transformers
# reads it back to the same weights, and the port's loader to the same
# params as from the single file.
def test_sharded_checkpoint_round_trip(saved, tmp_path):
    model, path = saved("qwen2")
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    files = TST.save_checkpoint(sd, str(tmp_path), shards=3)
    assert len(files) == 3
    with open(os.path.join(path, "config.json")) as f:
        (tmp_path / "config.json").write_text(f.read())
    index = json.loads((tmp_path / TST.INDEX).read_text())
    assert set(index["weight_map"]) == set(sd)
    back = transformers.Qwen2ForCausalLM.from_pretrained(str(tmp_path))
    for k, v in back.state_dict().items():
        assert torch.equal(v, sd[k]), k
    _, a = TL.load_from_hf(str(tmp_path), device="cpu")
    _, b = TL.load_from_hf(path, device="cpu")
    assert_trees_equal(a, b)


# ---------------------------------------------------------------------------
# the weight cache and the safetensors export, both ways
# ---------------------------------------------------------------------------

def _jax_tree(fmt):
    """A JAX param tree of each leaf kind: channelwise INT4, grouped INT2
    and INT4 (side streams), NF4, an MoE expert stack, bf16 floats."""
    jcfg = (JM.LlamaConfig.tiny(n_experts=4, moe_top_k=2) if fmt == "moe"
            else JM.LlamaConfig.tiny())
    fl = JM.init_params(jcfg, jax.random.key(SEED))
    kw = {"int4": dict(bits=4), "int2_g8": dict(bits=2, group_size=8),
          "int4_g16": dict(bits=4, group_size=16), "nf4": dict(bits="nf4"),
          "moe": dict(bits=4, group_size=16), "bf16": None}[fmt]
    return fl if kw is None else JM.quantize_params(fl, quantize_lm_head=True,
                                                    **kw)


# the group sizes put a chunk factor in the tiny model's K of 256, so
# the grouped leaves carry side streams
FORMATS = ["int4", "int2_g8", "int4_g16", "nf4", "moe", "bf16"]


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("via", ["weight_cache", "safetensors"])
def test_files_cross_packages(tmp_path, fmt, via):
    """A JAX tree written by the JAX package and read by the port, and the
    same tree (carried across) written by the port and read by the JAX
    package: leaf for leaf, the grouped side streams rebuilt by each."""
    jt = _jax_tree(fmt)
    mine = convert.params_from_jax(jt, device=CPU)
    if fmt != "bf16":
        layer = mine["layers"][0]
        q = layer["moe_w1"] if fmt == "moe" else layer["wq"]
        assert q.bits in (2, 4) and (q.s_chunk is not None) == (
            fmt in ("int2_g8", "int4_g16", "moe"))
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    if via == "weight_cache":
        JWC.save_quantized(a, jt)
        TWC.save_quantized(b, mine)
        got = TWC.load_quantized(a, device="cpu")
        back = JWC.load_quantized(b)
        with open(os.path.join(a, "manifest.json")) as fa, open(
                os.path.join(b, "manifest.json")) as fb:
            assert json.load(fa) == json.load(fb)
    else:
        a, b = a + ".safetensors", b + ".safetensors"
        JST.save_safetensors(a, jt)
        TST.save_safetensors(b, mine)
        got = TST.load_safetensors(a, device="cpu")
        back = JST.load_safetensors(b)
        ha, hb = TST.read_header(a), TST.read_header(b)
        assert ha["__metadata__"] == hb["__metadata__"]
        assert {k: v["dtype"] for k, v in ha.items() if k[0] == "t"} == {
            k: v["dtype"] for k, v in hb.items() if k[0] == "t"}
    assert_trees_equal(got, mine)
    assert_trees_equal(convert.params_from_jax(back, device=CPU), mine)


def test_weight_cache_fused_round_trip(tmp_path, saved):
    """A fused INT4 load through the port's cache: `fused_tp` comes back an
    int, every leaf equal."""
    _, path = saved("llama")
    _, p = TL.load_from_hf(path, quantize_bits=4, fuse=True, device="cpu")
    TWC.save_quantized(str(tmp_path), p)
    assert_trees_equal(TWC.load_quantized(str(tmp_path), device="cpu"), p)
    with open(tmp_path / "manifest.json") as f:
        m = json.load(f)
    m["format_version"] = 1
    with open(tmp_path / "manifest.json", "w") as f:
        json.dump(m, f)
    with pytest.raises(ValueError, match="format 1"):
        TWC.load_quantized(str(tmp_path), device="cpu")


# The container against the safetensors package on one file each way:
# every dtype the reader takes, a 0-d and an empty tensor, the metadata.
def test_container_matches_safetensors_package(tmp_path):
    g = torch.Generator().manual_seed(SEED)
    ts = {"f32": torch.randn(3, 5, generator=g),
          "f64": torch.randn(4, generator=g, dtype=torch.float64),
          "f16": torch.randn(2, 3, generator=g).half(),
          "bf16": torch.randn(7, 2, generator=g).bfloat16(),
          "i8": torch.randint(-128, 128, (9,), generator=g, dtype=torch.int8),
          "u8": torch.randint(0, 256, (3, 3), generator=g, dtype=torch.uint8),
          "i16": torch.randint(-999, 999, (5,), generator=g,
                               dtype=torch.int16),
          "u16": torch.randint(0, 60000, (5,), generator=g,
                               dtype=torch.int32).to(torch.uint16),
          "i32": torch.randint(-9, 9, (2, 2, 2), generator=g,
                               dtype=torch.int32),
          "i64": torch.randint(-9, 9, (3,), generator=g, dtype=torch.int64),
          "bool": torch.rand(6, generator=g) > 0.5,
          "scalar": torch.tensor(3.5), "empty": torch.zeros(0, 4)}
    md = {"format": "pt", "note": "x"}
    theirs, mine = str(tmp_path / "theirs.st"), str(tmp_path / "mine.st")
    safetensors.torch.save_file(ts, theirs, metadata=md)
    TST.save_file(ts, mine, metadata=md)
    got = TST.load_file(theirs, device="cpu")
    assert TST.read_header(theirs)["__metadata__"] == md
    with safetensors.safe_open(mine, framework="pt") as f:
        assert f.metadata() == md
        back = {k: f.get_tensor(k) for k in f.keys()}
    for name, t in ts.items():
        for other in (got[name], back[name]):
            assert other.dtype == t.dtype and other.shape == t.shape, name
            assert torch.equal(other.view(-1).view(torch.uint8) if
                               t.dtype == torch.uint16 else other,
                               t.view(-1).view(torch.uint8) if
                               t.dtype == torch.uint16 else t), name


def test_port_needs_no_safetensors_or_transformers():
    """The port imports `safetensors` nowhere and `transformers` only inside
    the CLI's tokenizer (text prompts): the card's machine has neither."""
    import ast
    from pathlib import Path

    root = Path(TL.__file__).resolve().parents[1]
    seen = []
    for path in sorted(root.rglob("*.py")):
        tree = ast.parse(path.read_text())
        owner = {}                 # node -> the function it lies in
        for fn in ast.walk(tree):
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for node in ast.walk(fn):
                    owner.setdefault(node, fn.name)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                if top in ("safetensors", "transformers"):
                    seen.append((path.name, owner.get(node), top))
    assert set(seen) == {("__main__.py", "tokenizer", "transformers")}, seen
