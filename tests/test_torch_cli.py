"""The port's model in the new weight formats (grouped INT4, an INT2-g32
MLP, INT2 channelwise; each with an INT8 lm_head) against the JAX
package's on the CPU, its random-weight constructor against the
reference's rules, and the serving CLI (`python -m
piquant_tpu_torch.serving`) driven in process."""

import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from piquant_tpu.models import llama as JM
from piquant_tpu_torch import convert
from piquant_tpu_torch.models import llama as TM
from piquant_tpu_torch.serving import __main__ as S
from test_torch_model import _check_logits, _run_jax, _run_port

SEED = 0xC11
CPU = torch.device("cpu")
MLP2 = {k: (2, 32) for k in ("w1", "w3", "w2")}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the tiny model's thousands of small ops stall
    on a thread pool whose cores the other test workers hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# weight format -> quantize_params keywords (every one with the INT8 lm_head)
FORMATS = {
    "int4_g32": dict(bits=4, group_size=32),
    "int4_attn_int2_g32_mlp": dict(bits=4, overrides=MLP2),
    "int2": dict(bits=2),
    "per_layer_overrides": dict(bits=4, group_size=64,
                                overrides={"w2": (8, None), "1.wq": (2, 32)}),
}


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_formats_match_jax(fmt):
    """Each format quantized by both packages from the same float init:
    every quantized leaf byte-equal; then the JAX weights carried across,
    prefill + 3 decode steps within LOGIT_TOL (tests/test_torch_model.py),
    argmax equal where there is no near tie."""
    jcfg = JM.LlamaConfig.tiny()
    jfloat = JM.init_params(jcfg, jax.random.key(SEED))
    kw = FORMATS[fmt]
    jparams = JM.quantize_params(jfloat, quantize_lm_head=True, **kw)
    cfg = convert.config_from_jax(jcfg)
    params = convert.params_from_jax(jparams, device=CPU)
    mine = TM.quantize_params(convert.params_from_jax(jfloat, device=CPU),
                              quantize_lm_head=True, **kw)
    leaves = [(jparams["lm_head"], mine["lm_head"], params["lm_head"])] + [
        (jl[k], ml[k], pl[k])
        for jl, ml, pl in zip(jparams["layers"], mine["layers"],
                              params["layers"])
        for k in TM._QUANT_KEYS]
    for j, m, p in leaves:
        assert (m.bits, m.group_size) == (j.bits, j.group_size)
        for f in ("data", "scale", "zero_point", "s_chunk", "z_chunk"):
            a, b = getattr(m, f), getattr(p, f)
            assert (a is None) == (getattr(j, f) is None), f
            if a is not None:
                assert torch.equal(a, b), f
    rng = np.random.default_rng(SEED)
    toks = jnp.asarray(rng.integers(1, cfg.vocab_size, (2, 128 + 3)),
                       jnp.int32)
    _check_logits(_run_port(cfg, params, toks, 3),
                  _run_jax(jcfg, jparams, toks, 3, jit=True))


def test_random_quantized_params_follow_the_reference():
    """random_quantized_params' rules against JAX's: per weight the same
    bits, group size, shapes and (constant) scales, zero points and side
    streams; only the random codes differ."""
    jcfg = JM.LlamaConfig(vocab_size=256, d_model=256, n_layers=2,
                          n_heads=2, n_kv_heads=1, d_ff=768, max_seq_len=256)
    cfg = convert.config_from_jax(jcfg)
    for kw in (dict(bits=4, lm_head_bits=8, group_size=128),
               dict(bits=4, lm_head_bits=8, mlp_bits=2, mlp_group_size=32),
               dict(bits=2, lm_head_bits=8), dict(bits=4, group_size=512)):
        j = JM.random_quantized_params(jcfg, jax.random.key(1), **kw)
        t = TM.random_quantized_params(cfg, 1, device="cpu", **kw)
        if kw.get("lm_head_bits") is None:
            assert t["lm_head"].dtype == torch.bfloat16
            pairs = []
        else:
            pairs = [(j["lm_head"], t["lm_head"])]
        pairs += [(jl[k], tl[k]) for jl, tl in zip(j["layers"], t["layers"])
                  for k in TM._QUANT_KEYS]
        for a, b in pairs:
            assert (b.bits, b.k, b.group_size) == (a.bits, a.k, a.group_size)
            assert tuple(b.data.shape) == a.data.shape
            assert b.data.dtype == torch.uint8
            for f in ("scale", "zero_point", "s_chunk", "z_chunk"):
                x, y = getattr(a, f), getattr(b, f)
                assert (x is None) == (y is None), f
                if x is not None:
                    np.testing.assert_array_equal(
                        y.float().numpy(), np.asarray(x, np.float32))
    # d_ff 768 does not split into groups of 512: channelwise, as there
    t = TM.random_quantized_params(cfg, 1, group_size=512, device="cpu")
    assert t["layers"][0]["w2"].group_size is None
    assert t["layers"][0]["wq"].group_size is None       # 256 rows
    with pytest.raises(NotImplementedError):
        TM.random_quantized_params(cfg, 1, bits=3, device="cpu")


def _cli(capsys, *argv):
    assert S.main(list(argv)) == 0
    return capsys.readouterr().out.strip().splitlines()


@pytest.mark.parametrize("flags", [(), ("--group-size", "32"),
                                   ("--mlp-bits", "2", "--mlp-group-size", "32"),
                                   ("--group-size", "64"), ("--bits", "2"),
                                   ("--bits", "8")])
def test_cli_benchmark(capsys, tmp_path, flags):
    out = tmp_path / "metrics.jsonl"
    lines = _cli(capsys, "--random", "tiny", "--device", "cpu",
                 "--benchmark", "4", "--max-new", "6", "--max-seq-len", "256",
                 "--metrics-out", str(out), *flags)
    m = json.loads(lines[-1])
    assert m["completed"] == 4 and m["requests"] == 4
    assert m["decode_tokens"] == 4 * 5 and m["wall_s"] > 0
    assert m["wall_s"] == round(m["wall_s"], 2)
    assert m["prefix_hits"] == m["prefix_tokens_saved"] == 0
    emitted = [json.loads(line) for line in out.read_text().splitlines()]
    assert len(emitted) == 1 and emitted[0]["decode_tokens"] == 20


def test_cli_prompts(capsys):
    lines = _cli(capsys, "--random", "tiny", "--device", "cpu",
                 "--max-new", "3", "--group-size", "32", "1,2,3", "7,8")
    assert [line.split("]")[0] for line in lines] == ["[0", "[1"]
    toks = [json.loads(line.split("| ")[1]) for line in lines]
    assert all(len(t) == 3 and all(0 <= v < 256 for v in t) for t in toks)


# Activation quantization on the tiny model: its 256-wide projections are
# off the a8 kernels' K % 512 gate and take the weight-only route, except
# the INT2-g32 w2 (K 512), which takes the chunk kernel with int8 x at
# decode M.
@pytest.mark.parametrize("flags,int8_chunk", [
    (("--act-quant-prefill",), False),
    (("--bits", "2", "--act-quant-decode"), False),
    (("--mlp-bits", "2", "--mlp-group-size", "32", "--act-quant-decode"),
     True)])
def test_cli_act_quant(monkeypatch, flags, int8_chunk):
    from piquant_tpu_torch.ops.cuda import qmatmul as TQ

    int8_calls = []
    plain = TQ.wg_chunk_plain

    def counted(x, *a, **k):
        int8_calls.append(x.dtype == torch.int8)
        return plain(x, *a, **k)

    monkeypatch.setattr(TQ, "wg_chunk_plain", counted)
    args = S.build_parser().parse_args(
        ["--random", "tiny", "--device", "cpu", "--benchmark", "2",
         "--max-new", "4", "--max-seq-len", "256", *flags])
    cfg, _, eng, sp = S.build(args)
    assert (cfg.act_quant_prefill, cfg.act_quant_decode) == (
        "--act-quant-prefill" in flags, "--act-quant-decode" in flags)
    m, done = S.benchmark(args, cfg, eng, sp)
    assert m["completed"] == 2 and m["decode_tokens"] == 2 * 3
    for r in done:
        assert len(r.tokens) == 4 and all(0 <= t < 256 for t in r.tokens)
        assert all(np.isfinite(lp) and lp <= 0 for lp in r.logprobs)
    assert any(int8_calls) == int8_chunk


# Each refusal names its item in ROADMAP.md's queue 1 (--random
# gpt_oss_20b and llama4_scout serve since item 5 was ported:
# tests/test_torch_llama4_gpt_oss.py::test_cli_presets; --prefill-chunk and
# --attn-windows since item 8: test_cli_serves_item8_flags; --speculate and
# --draft-* since item 10: test_cli_serves_item10_flags; --model since item
# 9: test_cli_serves_model; the cases keep the ids they had beside it).
@pytest.mark.parametrize("argv,item", [
    pytest.param(["--random", "mla_v2_lite"], 11, id="argv1-11"),
    pytest.param(["--random", "mla_v2_moe"], 11, id="argv2-11"),
    pytest.param(["--random", "mla_tiny"], 11, id="argv3-11"),
    pytest.param(["--serve", "8123"], 12, id="argv4-12")])
def test_cli_refuses_unported_flags(argv, item):
    with pytest.raises(NotImplementedError, match=rf"queue 1 item {item}\b"):
        S.main(["--random", "tiny", "--device", "cpu", "--benchmark", "1",
                *argv])


# The three flags of item 10 reach the engine as the reference CLI passes
# them: --speculate as EngineConfig.speculate, --draft-bits (with
# --draft-group-size) as a draft model re-quantized from the params on
# their device; the tiny model serves its benchmark with each, every
# request complete.
@pytest.mark.parametrize("flags,draft", [
    (("--speculate", "4"), None),
    (("--draft-bits", "2", "--speculate", "2"), (2, None)),
    (("--draft-group-size", "32", "--draft-bits", "2", "--speculate", "2"),
     (2, 32))])
def test_cli_serves_item10_flags(flags, draft):
    args = S.build_parser().parse_args(
        ["--random", "tiny", "--device", "cpu", "--benchmark", "2",
         "--max-new", "6", "--max-seq-len", "256", *flags])
    cfg, params, eng, sp = S.build(args)
    assert eng.ec.speculate == args.speculate
    if draft is None:
        assert eng._draft is None
    else:
        dcfg, dparams = eng._draft
        w = dparams["layers"][0]["wq"]
        assert dcfg is cfg and (w.bits, w.group_size) == draft
        assert w.data.device == params["embed"].device
    m, done = S.benchmark(args, cfg, eng, sp)
    assert m["completed"] == 2 and m["decode_tokens"] == 2 * 5
    for r in done:
        assert len(r.tokens) == 6 and all(0 <= t < 256 for t in r.tokens)
        assert all(np.isfinite(lp) and lp <= 0 for lp in r.logprobs)


def test_cli_draft_bits_needs_speculate():
    with pytest.raises(SystemExit, match="--speculate > 0"):
        S.main(["--random", "tiny", "--device", "cpu", "--benchmark", "1",
                "--draft-bits", "2"])


# --repetition-penalty serves since item 7 was ported: it turns on the
# engine's token history and reaches every request, as the reference CLI
# passes it, and the benchmark completes.
@pytest.mark.parametrize("penalty", ["1.1", "1.3"])
def test_cli_repetition_penalty_serves(penalty):
    args = S.build_parser().parse_args(
        ["--random", "tiny", "--device", "cpu", "--benchmark", "2",
         "--max-new", "4", "--max-seq-len", "256", "--repetition-penalty",
         penalty])
    cfg, _, eng, sp = S.build(args)
    assert eng.ec.track_history and sp.repetition_penalty == float(penalty)
    m, done = S.benchmark(args, cfg, eng, sp)
    assert m["completed"] == 2 and m["decode_tokens"] == 2 * 3
    assert all(len(r.tokens) == 4 for r in done)


# The two flags of item 8 reach EngineConfig as the reference CLI passes
# them, and the tiny model serves its benchmark with them on the CPU: every
# request completes and the metrics line carries the reference's keys.
@pytest.mark.parametrize("argv,field,value", [
    (["--prefill-chunk", "64"], "prefill_chunk", 64),
    (["--attn-windows", "128,256"], "attn_windows", (128, 256))])
def test_cli_serves_item8_flags(argv, field, value, capsys):
    args = S.build_parser().parse_args(
        ["--random", "tiny", "--device", "cpu", "--benchmark", "2",
         "--max-new", "4", "--max-seq-len", "256", *argv])
    cfg, _, eng, sp = S.build(args)
    assert getattr(eng.ec, field) == value
    m, done = S.benchmark(args, cfg, eng, sp)
    assert m["completed"] == 2 and m["decode_tokens"] == 2 * 3
    assert m["prefill_tokens"] == sum(len(r.prompt) for r in done)
    for r in done:
        assert len(r.tokens) == 4 and all(0 <= t < 256 for t in r.tokens)
    assert S.main(["--random", "tiny", "--device", "cpu", "--benchmark", "1",
                   "--max-new", "2", "--max-seq-len", "256", *argv]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {"decode_tokens_per_s", "prefill_tokens_per_s", "p50_ttft_ms",
            "prefix_hits", "wall_s", "completed"} <= set(line)


# NF4 weights and the kv4 cache through the CLI on the CPU: 4 requests
# complete, the model holds NF4 weights or a pair-packed cache, and the NF4
# projections take the NF4 GEMV (its plain version here) at decode M.
@pytest.mark.parametrize("flags,nf4_per_layer", [
    (("--bits", "nf4"), 7),
    (("--mlp-bits", "nf4", "--mlp-group-size", "32"), 3),
    (("--kv-bits", "4"), 0)])
def test_cli_nf4_and_kv4(monkeypatch, flags, nf4_per_layer):
    from piquant_tpu_torch.ops.cuda import qmatmul as TQ

    calls = []
    plain = TQ.nf4_gemv_plain
    monkeypatch.setattr(TQ, "nf4_gemv_plain",
                        lambda x, *a: (calls.append(x.shape[0]), plain(x, *a))[1])
    args = S.build_parser().parse_args(
        ["--random", "tiny", "--device", "cpu", "--benchmark", "4",
         "--max-new", "5", "--max-seq-len", "256", *flags])
    cfg, params, eng, sp = S.build(args)
    layer = params["layers"][0]
    nf4 = [k for k in TM._QUANT_KEYS if layer[k].codebook == "nf4"]
    assert len(nf4) == nf4_per_layer
    if "--mlp-group-size" in flags:
        assert {layer[k].group_size for k in nf4} == {32}
    assert cfg.kv_bits == args.kv_bits
    assert eng.cache.k_codes.dtype == (torch.uint8 if args.kv_bits == 4
                                       else torch.int8)
    steps = []
    dispatch = eng._dispatch_block
    monkeypatch.setattr(eng, "_dispatch_block",
                        lambda: (steps.append(1), dispatch())[1])
    m, done = S.benchmark(args, cfg, eng, sp)
    assert m["completed"] == 4 and m["decode_tokens"] == 4 * 4
    for r in done:
        assert len(r.tokens) == 5 and all(0 <= t < 256 for t in r.tokens)
        assert all(np.isfinite(lp) and lp <= 0 for lp in r.logprobs)
    # decode steps at 8 slots; prefill calls of >= 64 rows take no GEMV
    n_steps = len(steps) * eng.ec.decode_block
    assert calls.count(8) == nf4_per_layer * cfg.n_layers * n_steps


# A recorded divergence (ROADMAP.md section 3): the port passes the
# weight-format flags to the random presets, where the reference CLI builds
# llama3_8b and mixtral_8x7b channelwise at --bits whatever they say.  The
# preset is patched to a small geometry here.
@pytest.mark.parametrize("flags,want", [
    (("--group-size", "128"), {"wq": (4, 128, None), "w2": (4, 128, None)}),
    (("--mlp-bits", "2", "--mlp-group-size", "32"),
     {"wq": (4, None, None), "w2": (2, 32, None)}),
    (("--bits", "nf4", "--group-size", "64"),
     {"wq": (4, 64, "nf4"), "w2": (4, 64, "nf4")})])
def test_cli_random_presets_take_format_flags(monkeypatch, flags, want):
    small = dict(vocab_size=256, d_model=256, n_layers=1, n_heads=2,
                 n_kv_heads=1, d_ff=512, max_seq_len=256)
    monkeypatch.setattr(TM.LlamaConfig, "llama3_8b",
                        staticmethod(lambda: TM.LlamaConfig(**small)))
    args = S.build_parser().parse_args(
        ["--random", "llama3_8b", "--device", "cpu", *flags])
    _, params, _, _ = S.build(args)
    layer = params["layers"][0]
    got = {k: (layer[k].bits, layer[k].group_size, layer[k].codebook)
           for k in want}
    assert got == want
    assert params["lm_head"].bits == 8 and params["lm_head"].codebook is None
    # what the reference CLI builds for the same flags: channelwise
    ref = JM.random_quantized_params(JM.LlamaConfig(**small),
                                     jax.random.key(0), bits=args.bits,
                                     lm_head_bits=8)
    assert all(ref["layers"][0][k].group_size is None for k in want)


# The metrics line: the reference's keys, in its order, with its rounding
# (rates and TTFTs to 2 places, the prefix-cache counters at 0), for
# to_dict and for the line `emit` appends.
@pytest.mark.parametrize("numbers", [
    dict(decode_tokens=6, decode_time_s=3.01234567, prefill_tokens=762,
         prefill_time_s=0.0471234, ttfts=[0.0153456, 0.0188781, 0.123456]),
    dict(decode_tokens=0, decode_time_s=0.0, prefill_tokens=0,
         prefill_time_s=0.0, ttfts=[])])
def test_metrics_line_matches_reference(tmp_path, numbers):
    from piquant_tpu.serving.engine import EngineMetrics as JMetrics
    from piquant_tpu_torch.serving.engine import EngineMetrics

    mine, ref = EngineMetrics(**numbers), JMetrics(**numbers)
    assert list(mine.to_dict().items()) == list(ref.to_dict().items())
    mine.emit(str(tmp_path / "port.jsonl"))
    ref.emit(str(tmp_path / "ref.jsonl"))
    lines = [json.loads((tmp_path / f).read_text())
             for f in ("port.jsonl", "ref.jsonl")]
    for line in lines:
        line.pop("ts")
    assert lines[0] == lines[1]


# Mixtral-8x7B through the CLI on the CPU, its preset patched to the tiny
# MoE geometry (4 experts, top 2): every prefill (>= 64 tokens) takes the
# ragged expert GEMMs, 3 a layer; the decode steps (2 slots) the
# dense-masked route.
@pytest.mark.parametrize("flags,kernel", [
    ((), "wq_ragged"), (("--group-size", "32"), "wq_ragged_grouped"),
    (("--bits", "2", "--act-quant-decode"), "wq_ragged_a8")])
def test_cli_mixtral(monkeypatch, flags, kernel):
    from piquant_tpu_torch.ops.cuda import ragged as TR

    monkeypatch.setattr(TM.LlamaConfig, "mixtral_8x7b", staticmethod(
        lambda: TM.LlamaConfig.tiny(n_experts=4, moe_top_k=2)))
    calls = []
    plain = getattr(TR, kernel + "_plain")

    def counted(x, *a, **k):
        calls.append(x.shape[0])
        return plain(x, *a, **k)

    monkeypatch.setattr(TR, kernel + "_plain", counted)
    args = S.build_parser().parse_args(
        ["--random", "mixtral_8x7b", "--device", "cpu", "--benchmark", "2",
         "--slots", "2", "--max-new", "4", "--max-seq-len", "256", *flags])
    cfg, params, eng, sp = S.build(args)
    assert cfg.n_experts == 4 and "router" in params["layers"][0]
    assert params["lm_head"].bits == 8
    stack = params["layers"][0]["moe_w1"]
    assert (stack.n_experts, stack.bits, stack.group_size) == (
        4, int(args.bits), args.group_size)
    prefills = []
    admit = eng._admit_one_shot
    monkeypatch.setattr(eng, "_admit_one_shot",
                        lambda batch: (prefills.append(batch), admit(batch)))
    m, done = S.benchmark(args, cfg, eng, sp)
    assert m["completed"] == 2 and m["decode_tokens"] == 2 * 3
    for r in done:
        assert len(r.tokens) == 4 and all(0 <= t < 256 for t in r.tokens)
    assert len(calls) == 3 * cfg.n_layers * len(prefills)


def test_cli_defaults_to_cuda(monkeypatch):
    """No --device: the CLI runs on the GPU, and without one it fails
    rather than move to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        S.main(["--random", "tiny", "--benchmark", "1"])


@pytest.fixture(scope="module")
def tiny_checkpoint(tmp_path_factory):
    """A tiny random-init Llama checkpoint (head_dim 128, rep 2) saved by
    transformers, and a word-level tokenizer of its 256 ids ("w0" ..
    "w255", eos "w1") saved beside it in a second directory."""
    import transformers
    from tokenizers import Tokenizer, models, pre_tokenizers

    torch.manual_seed(SEED)
    conf = transformers.LlamaConfig(
        vocab_size=256, hidden_size=256, intermediate_size=512,
        num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1,
        max_position_embeddings=512, tie_word_embeddings=False)
    model = transformers.LlamaForCausalLM(conf).eval()
    path = tmp_path_factory.mktemp("ckpt")
    model.save_pretrained(path, safe_serialization=True)
    with_tok = tmp_path_factory.mktemp("ckpt_tok")
    model.save_pretrained(with_tok, safe_serialization=True)
    tok = Tokenizer(models.WordLevel({f"w{i}": i for i in range(256)},
                                     unk_token="w0"))
    tok.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    transformers.PreTrainedTokenizerFast(
        tokenizer_object=tok, unk_token="w0",
        eos_token="w1").save_pretrained(with_tok)
    return model, str(path), str(with_tok)


# --model DIR as the reference CLI: the checkpoint loaded unquantized, then
# quantize_params with --bits, --group-size and the --mlp-* overrides (the
# lm_head left bf16): every leaf equal to the JAX package's load of the
# same model quantized alike; the benchmark serves every request.
@pytest.mark.parametrize("flags,kw", [
    ((), dict(bits=4)),
    (("--group-size", "64", "--mlp-bits", "2", "--mlp-group-size", "32"),
     dict(bits=4, group_size=64, overrides=MLP2))])
def test_cli_serves_model(tiny_checkpoint, capsys, flags, kw):
    from piquant_tpu.models.loader import load_from_hf as j_load
    from test_torch_loader import assert_trees_equal

    model, path, _ = tiny_checkpoint
    argv = ["--model", path, "--device", "cpu", "--benchmark", "2",
            "--slots", "2", "--max-new", "4", "--max-seq-len", "256", *flags]
    args = S.build_parser().parse_args(argv)
    cfg, params, eng, sp = S.build(args)
    assert isinstance(params["lm_head"], torch.Tensor)
    assert params["lm_head"].dtype == torch.bfloat16
    jcfg, jparams = j_load(model, quantize_bits=None)
    assert cfg == convert.config_from_jax(jcfg)
    assert_trees_equal(params, convert.params_from_jax(
        JM.quantize_params(jparams, **kw), device=CPU))
    assert S.main(argv) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["completed"] == 2


def test_cli_model_text_prompts(tiny_checkpoint, capsys, monkeypatch):
    """Text prompts under --model go through the checkpoint's tokenizer
    (encoded, decoded, its eos); without a tokenizer in the directory, or
    without transformers, they raise before the model loads; --benchmark
    needs no tokenizer."""
    import sys

    _, path, with_tok = tiny_checkpoint
    argv = ["--device", "cpu", "--max-new", "3", "--max-seq-len", "256"]
    assert S.main(["--model", with_tok, *argv, "w5 w6 w7", "w9"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert [o.split(" | ")[0].split()[0] for o in out] == ["[0]", "[1]"]
    for o in out:
        words = o.split(" | ")[1].split()
        assert 1 <= len(words) <= 3 and all(w[0] == "w" for w in words)
    with pytest.raises(FileNotFoundError, match="no tokenizer"):
        S.main(["--model", path, *argv, "w5 w6"])
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="transformers"):
        S.main(["--model", with_tok, *argv, "w5 w6"])
    assert S.main(["--model", path, *argv, "--benchmark", "1"]) == 0


def test_cli_model_eos(tiny_checkpoint, tmp_path):
    """Under --model the requests stop at the checkpoint's EOS id, read
    without transformers as the reference's tokenizer gives it
    (tokenizer_config's eos_token), else from generation_config.json or
    config.json; the benchmark's requests end at it."""
    import shutil

    import transformers

    _, path, with_tok = tiny_checkpoint
    assert S.checkpoint_eos(with_tok) == (
        transformers.AutoTokenizer.from_pretrained(with_tok).eos_token_id)
    assert S.checkpoint_eos(path) == transformers.AutoConfig.from_pretrained(
        path).eos_token_id
    ckpt = tmp_path / "ckpt"
    shutil.copytree(path, ckpt)
    (ckpt / "generation_config.json").unlink()
    conf = json.loads((ckpt / "config.json").read_text())

    def serve(eos):
        (ckpt / "config.json").write_text(json.dumps(
            dict(conf, eos_token_id=eos)))
        args = S.build_parser().parse_args(
            ["--model", str(ckpt), "--device", "cpu", "--benchmark", "2",
             "--slots", "2", "--max-new", "6", "--max-seq-len", "256"])
        cfg, params, eng, sp = S.build(args)
        assert sp.eos_token == (-1 if eos is None else eos[0])
        m, done = S.benchmark(args, cfg, eng, sp)
        assert m["completed"] == 2
        return {r.rid: r.tokens for r in done}

    free = serve(None)
    assert all(len(t) == 6 for t in free.values())
    eos = free[0][2]
    stop = free[0].index(eos) + 1
    assert serve([eos, 5])[0] == free[0][:stop]
