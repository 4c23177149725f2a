"""Serving CLI of the port:  python -m piquant_tpu_torch.serving [options]

The counterpart of `python -m piquant_tpu.serving`: loads an HF checkpoint
directory (`--model DIR`: config.json and safetensors shards, read without
transformers) or builds a random-weight preset, quantizes its weights, then
serves the prompts given on the command line (or stdin) or runs a
synthetic load benchmark through the continuous-batching engine.  Prompts
are text under `--model` (encoded and decoded by the checkpoint's
transformers tokenizer, imported only then) and comma-separated token ids
otherwise.  Runs on the GPU; `--device cpu` runs it on the CPU.

Examples:
  python -m piquant_tpu_torch.serving --model /path/to/llama --bits 4 "Hello"
  python -m piquant_tpu_torch.serving --model /path/to/llama --benchmark 8
  python -m piquant_tpu_torch.serving --random llama3_8b --benchmark 8
  python -m piquant_tpu_torch.serving --random llama3_8b --group-size 128 --benchmark 8
  python -m piquant_tpu_torch.serving --random llama3_8b --act-quant-prefill --benchmark 8
  python -m piquant_tpu_torch.serving --random mixtral_8x7b --benchmark 8
  python -m piquant_tpu_torch.serving --random mistral_7b --benchmark 8
  python -m piquant_tpu_torch.serving --random qwen3_moe_a3b --benchmark 4 --max-new 8
  python -m piquant_tpu_torch.serving --random gemma2_9b --benchmark 4 --max-new 8
  python -m piquant_tpu_torch.serving --random llama4_scout --benchmark 4 --max-new 8
  python -m piquant_tpu_torch.serving --random gpt_oss_20b --benchmark 4 --max-new 8
  python -m piquant_tpu_torch.serving --random llama3_8b --bits nf4 --kv-bits 4 --benchmark 8
  python -m piquant_tpu_torch.serving --random llama3_8b --prefill-chunk 256 --attn-windows 512,1024,2048 --benchmark 8
  python -m piquant_tpu_torch.serving --random llama3_8b --speculate 4 --draft-bits 2 --benchmark 4
  python -m piquant_tpu_torch.serving --random tiny --device cpu --bits 2 --act-quant-decode --benchmark 4
  python -m piquant_tpu_torch.serving --random tiny --device cpu --benchmark 4
  python -m piquant_tpu_torch.serving --random tiny --device cpu --speculate 2 --benchmark 2
  python -m piquant_tpu_torch.serving --random tiny --device cpu --bits nf4 --kv-bits 4 --benchmark 4
  python -m piquant_tpu_torch.serving --random tiny --device cpu 1,2,3 4,5

The reference's other flags parse as they do there and raise
NotImplementedError naming the ROADMAP.md item that ports them.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

PRESETS = ["tiny", "llama3_8b", "mistral_7b", "qwen2_7b", "gemma_2b",
           "gemma_7b", "phi3_mini", "mixtral_8x7b", "qwen3_8b",
           "qwen3_moe_a3b", "gemma2_9b", "gemma3_12b", "gpt_oss_20b",
           "llama4_scout", "mla_v2_lite", "mla_tiny", "mla_v2_moe"]


def _bits_arg(v: str):
    """--bits value: int width or a codebook name ('nf4')."""
    return v if v == "nf4" else int(v)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m piquant_tpu_torch.serving",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("prompts", nargs="*", help="prompts as comma-separated "
                                               "token ids")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    ap.add_argument("--model", help="HF checkpoint directory (config.json "
                                    "and safetensors shards)")
    ap.add_argument("--random", metavar="PRESET", choices=PRESETS,
                    help="random-weight model preset (tiny, llama3_8b, "
                         "mistral_7b, qwen2_7b, qwen3_8b, phi3_mini, "
                         "mixtral_8x7b, qwen3_moe_a3b, gemma_2b, gemma_7b, "
                         "gemma2_9b, gemma3_12b, llama4_scout, "
                         "gpt_oss_20b)")
    ap.add_argument("--bits", type=_bits_arg, default=4,
                    choices=[2, 4, 8, "nf4"],
                    help="weight quantization bits (default 4)")
    ap.add_argument("--kv-bits", type=int, default=8, choices=[4, 8],
                    help="KV-cache code width (8)")
    ap.add_argument("--mlp-bits", type=_bits_arg, default=None,
                    choices=[2, 4, 8, "nf4"],
                    help="mixed precision: quantize w1/w2/w3 at this width "
                         "(attention keeps --bits); dense MLP layers only, "
                         "MoE experts keep --bits")
    ap.add_argument("--mlp-group-size", type=int, default=None,
                    help="group size for the --mlp-bits weights (dense MLP "
                         "layers only)")
    ap.add_argument("--group-size", type=int, default=None,
                    help="group-wise quantization group size")
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--max-seq-len", type=int, default=2048)
    ap.add_argument("--max-new", type=int, default=64)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--min-p", type=float, default=0.0,
                    help="keep tokens with p >= min_p * p_max")
    ap.add_argument("--repetition-penalty", type=float, default=1.0)
    ap.add_argument("--prefill-chunk", type=int, default=None)
    ap.add_argument("--attn-windows", default=None)
    ap.add_argument("--act-quant-prefill", action="store_true",
                    help="int8 per-token activations for prefill-sized "
                         "matmuls (M >= 256)")
    ap.add_argument("--act-quant-decode", action="store_true",
                    help="int8 per-token activations at every M, decode "
                         "included")
    ap.add_argument("--speculate", type=int, default=0,
                    help="speculative decoding: drafts per verify step "
                         "(prompt lookup unless --draft-bits)")
    ap.add_argument("--draft-bits", type=_bits_arg, default=None,
                    choices=[2, 4, 8, "nf4"],
                    help="two-model speculation: the draft is this model "
                         "re-quantized at this width (requantize_params); "
                         "greedy verify, or rejection sampling at "
                         "temperature > 0.  Needs --speculate")
    ap.add_argument("--draft-group-size", type=int, default=None,
                    help="group size of the --draft-bits weights")
    ap.add_argument("--benchmark", type=int, metavar="N", default=None,
                    help="run a synthetic N-request load benchmark and print "
                         "engine metrics JSON")
    ap.add_argument("--metrics-out", help="append engine metrics JSON line here")
    ap.add_argument("--serve", type=int, metavar="PORT", default=None)
    return ap


# the random-code presets, built as the reference CLI builds them
# (random_quantized_params with an INT8 lm_head)
RANDOM_CODES = ("llama3_8b", "mistral_7b", "qwen2_7b", "gemma_7b",
                "phi3_mini", "mixtral_8x7b", "qwen3_8b", "qwen3_moe_a3b",
                "gemma2_9b", "gemma3_12b", "gpt_oss_20b", "llama4_scout")
# the presets quantized from a random float init, as the reference CLI
# builds them
FLOAT_INIT = ("tiny", "gemma_2b")


def _not_ported(args) -> None:
    """Raise for every flag of the reference CLI the port does not have
    yet, naming its ROADMAP.md item."""
    todo = []
    if args.random not in (None,) + FLOAT_INIT + RANDOM_CODES:
        todo.append(f"--random {args.random} (queue 1 item 11 (MLA))")
    if args.serve is not None:
        todo.append("--serve (HTTP server: queue 1 item 12)")
    if todo:
        raise NotImplementedError("not ported yet (ROADMAP.md): "
                                  + "; ".join(todo))


def _mlp_overrides(args):
    """--mlp-bits/--mlp-group-size -> quantize_params `overrides` for the
    MLP projections; None = uniform quantization."""
    if args.mlp_bits is None and args.mlp_group_size is None:
        return None
    bits = args.mlp_bits if args.mlp_bits is not None else args.bits
    return {k: (bits, args.mlp_group_size) for k in ("w1", "w3", "w2")}


def build(args):
    """The model, the engine and the sampling parameters the flags ask for:
    (cfg, params, engine, sampling).

    `--model` loads the checkpoint in bf16 (`load_from_hf`, unquantized)
    and quantizes it as the reference CLI does (`quantize_params` with
    --bits, --group-size and the --mlp-* overrides; the lm_head stays
    bf16), and its requests stop at the checkpoint's EOS id
    (`checkpoint_eos`).  The RANDOM_CODES presets are built from random codes with the
    reference CLI's INT8 lm_head; the port also passes them the
    weight-format flags (--group-size, --mlp-bits, --mlp-group-size), which
    the reference CLI applies only to the float-quantized presets; the MoE
    experts take --bits and --group-size.  The FLOAT_INIT presets quantize
    a random float init, as the reference CLI builds them.  --draft-bits
    gives the engine a draft model: the params re-quantized at that width
    (and --draft-group-size) where they lie."""
    _not_ported(args)
    from piquant_tpu_torch._device import resolve_device
    from piquant_tpu_torch.models import llama as M
    from piquant_tpu_torch.serving import (Engine, EngineConfig,
                                           SamplingParams)

    dev = resolve_device(args.device)
    preset = args.random or "tiny"
    mlp = _mlp_overrides(args)
    if args.model:
        from piquant_tpu_torch.models.loader import load_from_hf

        cfg, params = load_from_hf(args.model, quantize_bits=None, device=dev)
    else:
        cfg = getattr(M.LlamaConfig, preset)()
    cfg = dataclasses.replace(cfg, kv_bits=args.kv_bits,
                              act_quant_prefill=args.act_quant_prefill,
                              act_quant_decode=args.act_quant_decode)
    if args.model:
        params = M.quantize_params(params, bits=args.bits,
                                   group_size=args.group_size, overrides=mlp)
    elif preset in RANDOM_CODES:
        mlp_bits, mlp_gs = mlp["w1"] if mlp else (None, None)
        params = M.random_quantized_params(
            cfg, 0, bits=args.bits, lm_head_bits=8, group_size=args.group_size,
            mlp_bits=mlp_bits, mlp_group_size=mlp_gs, device=dev)
    else:
        params = M.quantize_params(M.init_params(cfg, 0, device=dev),
                                   bits=args.bits, group_size=args.group_size,
                                   overrides=mlp)
    windows = (tuple(int(w) for w in args.attn_windows.split(","))
               if args.attn_windows else ())
    ec = EngineConfig(batch_slots=args.slots, max_seq_len=args.max_seq_len,
                      prefill_chunk=args.prefill_chunk,
                      speculate=args.speculate, attn_windows=windows,
                      track_history=args.repetition_penalty != 1.0)
    draft = None
    if args.draft_bits is not None:
        if args.speculate <= 0:
            raise SystemExit("--draft-bits needs --speculate > 0")
        print(f"building {args.draft_bits}-bit draft model "
              "(requantize_params)...", file=sys.stderr, flush=True)
        draft = (cfg, M.requantize_params(params, args.draft_bits,
                                          group_size=args.draft_group_size))
    eng = Engine(cfg, params, ec, draft=draft, device=dev)
    eos = checkpoint_eos(args.model) if args.model else None
    sp = SamplingParams(temperature=args.temperature, top_k=args.top_k,
                        top_p=args.top_p, min_p=args.min_p,
                        repetition_penalty=args.repetition_penalty,
                        max_new_tokens=args.max_new,
                        eos_token=-1 if eos is None else eos)
    return cfg, params, eng, sp


def _read_json(path, name):
    full = os.path.join(path, name)
    if not os.path.exists(full):
        return {}
    with open(full) as f:
        return json.load(f)


def checkpoint_eos(path):
    """The checkpoint's EOS id, read from its files without transformers
    (the reference takes its tokenizer's eos_token_id): tokenizer_config's
    eos_token resolved through its added_tokens_decoder or tokenizer.json's
    added tokens and vocab; else generation_config.json's eos_token_id, else
    config.json's (the first of a list).  None if no file names one."""
    tc = _read_json(path, "tokenizer_config.json")
    name = tc.get("eos_token")
    if isinstance(name, dict):
        name = name.get("content")
    if name is not None:
        ids = {t["content"]: int(i)
               for i, t in tc.get("added_tokens_decoder", {}).items()}
        tj = _read_json(path, "tokenizer.json")
        ids.update({t["content"]: t["id"]
                    for t in tj.get("added_tokens", ())})
        vocab = tj.get("model", {}).get("vocab")
        if isinstance(vocab, dict):
            ids = {**vocab, **ids}
        if name in ids:
            return ids[name]
    for f in ("generation_config.json", "config.json"):
        eos = _read_json(path, f).get("eos_token_id")
        if isinstance(eos, list):
            eos = eos[0] if eos else None
        if eos is not None:
            return int(eos)
    return None


def benchmark(args, cfg, eng, sp):
    """The reference CLI's synthetic load: N requests with prompt lengths
    in [64, hi) from default_rng(7).  Returns (metrics dict with wall_s and
    completed, finished requests)."""
    import numpy as np
    import torch

    from piquant_tpu_torch.serving import Request

    rng = np.random.default_rng(7)
    t0 = time.perf_counter()
    hi = max(66, min(900, args.max_seq_len - args.max_new))
    for i in range(args.benchmark):
        plen = int(rng.integers(min(64, hi - 1), hi))
        eng.submit(Request(rid=i,
                           prompt=rng.integers(5, cfg.vocab_size - 5,
                                               plen).tolist(),
                           sampling=sp))
    done = eng.run()
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    m = eng.metrics.to_dict()
    m["wall_s"] = round(time.perf_counter() - t0, 2)
    m["completed"] = len(done)
    return m, done


TOKENIZER_FILES = ("tokenizer.json", "tokenizer_config.json",
                   "tokenizer.model")


def tokenizer(path):
    """The checkpoint's transformers tokenizer: the one import of
    transformers, made only where text is encoded or decoded (the reference
    CLI builds it first, unconditionally)."""
    if not any(os.path.exists(os.path.join(path, f))
               for f in TOKENIZER_FILES):
        raise FileNotFoundError(
            f"{path} holds no tokenizer ({', '.join(TOKENIZER_FILES)}): text "
            "prompts need one (--benchmark does not)")
    try:
        from transformers import AutoTokenizer
    except ImportError as e:
        raise ImportError("text prompts under --model need the "
                          "`transformers` package for the checkpoint's "
                          "tokenizer (--benchmark needs none)") from e
    return AutoTokenizer.from_pretrained(path)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from piquant_tpu_torch.serving import Request

    raw = []
    if not args.benchmark:
        raw = args.prompts or [l.strip() for l in sys.stdin if l.strip()]
        if not raw:
            print("no prompts (pass as args or stdin); see --help",
                  file=sys.stderr)
            return 2
    tok = tokenizer(args.model) if args.model and raw else None
    cfg, params, eng, sp = build(args)
    if tok is not None and tok.eos_token_id is not None:
        sp = dataclasses.replace(sp, eos_token=tok.eos_token_id)
    if args.benchmark:
        m, _ = benchmark(args, cfg, eng, sp)
        print(json.dumps(m), flush=True)
        if args.metrics_out:
            eng.metrics.emit(args.metrics_out)
        return 0

    for i, text in enumerate(raw):
        ids = (tok.encode(text) if tok
               else [int(t) for t in text.split(",")])
        eng.submit(Request(rid=i, prompt=ids, sampling=sp))
    for r in sorted(eng.run(), key=lambda r: r.rid):
        out = tok.decode(r.tokens) if tok else r.tokens
        print(f"[{r.rid}] ttft={r.ttft_s * 1e3:.0f}ms | {out}")
    if args.metrics_out:
        eng.metrics.emit(args.metrics_out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
