"""Serving CLI of the port:  python -m piquant_tpu_torch.serving [options]

The counterpart of `python -m piquant_tpu.serving` for random-weight
models: builds the model, then serves the token-id prompts given on the
command line (comma-separated ids, or stdin) or runs a synthetic load
benchmark through the continuous-batching engine.  Runs on the GPU;
`--device cpu` runs it on the CPU.

Examples:
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
  python -m piquant_tpu_torch.serving --random tiny --device cpu --bits 2 --act-quant-decode --benchmark 4
  python -m piquant_tpu_torch.serving --random tiny --device cpu --benchmark 4
  python -m piquant_tpu_torch.serving --random tiny --device cpu --bits nf4 --kv-bits 4 --benchmark 4
  python -m piquant_tpu_torch.serving --random tiny --device cpu 1,2,3 4,5

The reference's other flags parse as they do there and raise
NotImplementedError naming the ROADMAP.md item that ports them.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
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
    ap.add_argument("--model", help="HF checkpoint path (not ported)")
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
    ap.add_argument("--speculate", type=int, default=0)
    ap.add_argument("--draft-bits", type=_bits_arg, default=None,
                    choices=[2, 4, 8, "nf4"])
    ap.add_argument("--draft-group-size", type=int, default=None)
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
    if args.model:
        todo.append("--model (HF loader: queue 1 item 9)")
    if args.random not in (None,) + FLOAT_INIT + RANDOM_CODES:
        todo.append(f"--random {args.random} (queue 1 item 11 (MLA))")
    if args.speculate or args.draft_bits is not None or args.draft_group_size:
        todo.append("--speculate / --draft-* (queue 1 item 10)")
    if args.prefill_chunk is not None or args.attn_windows:
        todo.append("--prefill-chunk / --attn-windows (queue 1 item 8)")
    if args.repetition_penalty != 1.0:
        todo.append("--repetition-penalty (queue 1 item 7)")
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

    The RANDOM_CODES presets are built from random codes with the
    reference CLI's INT8 lm_head; the port also passes them the
    weight-format flags (--group-size, --mlp-bits, --mlp-group-size), which
    the reference CLI applies only to the float-quantized presets; the MoE
    experts take --bits and --group-size.  The FLOAT_INIT presets quantize
    a random float init, as the reference CLI builds them."""
    _not_ported(args)
    from piquant_tpu_torch._device import resolve_device
    from piquant_tpu_torch.models import llama as M
    from piquant_tpu_torch.serving import (Engine, EngineConfig,
                                           SamplingParams)

    dev = resolve_device(args.device)
    preset = args.random or "tiny"
    cfg = dataclasses.replace(getattr(M.LlamaConfig, preset)(),
                              kv_bits=args.kv_bits,
                              act_quant_prefill=args.act_quant_prefill,
                              act_quant_decode=args.act_quant_decode)
    mlp = _mlp_overrides(args)
    if preset in RANDOM_CODES:
        mlp_bits, mlp_gs = mlp["w1"] if mlp else (None, None)
        params = M.random_quantized_params(
            cfg, 0, bits=args.bits, lm_head_bits=8, group_size=args.group_size,
            mlp_bits=mlp_bits, mlp_group_size=mlp_gs, device=dev)
    else:
        params = M.quantize_params(M.init_params(cfg, 0, device=dev),
                                   bits=args.bits, group_size=args.group_size,
                                   overrides=mlp)
    ec = EngineConfig(batch_slots=args.slots, max_seq_len=args.max_seq_len)
    eng = Engine(cfg, params, ec, device=dev)
    sp = SamplingParams(temperature=args.temperature, top_k=args.top_k,
                        top_p=args.top_p, min_p=args.min_p,
                        max_new_tokens=args.max_new, eos_token=-1)
    return cfg, params, eng, sp


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


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from piquant_tpu_torch.serving import Request

    cfg, params, eng, sp = build(args)
    if args.benchmark:
        m, _ = benchmark(args, cfg, eng, sp)
        print(json.dumps(m), flush=True)
        if args.metrics_out:
            eng.metrics.emit(args.metrics_out)
        return 0

    raw = args.prompts or [l.strip() for l in sys.stdin if l.strip()]
    if not raw:
        print("no prompts (pass as args or stdin); see --help", file=sys.stderr)
        return 2
    for i, text in enumerate(raw):
        eng.submit(Request(rid=i, prompt=[int(t) for t in text.split(",")],
                           sampling=sp))
    for r in sorted(eng.run(), key=lambda r: r.rid):
        print(f"[{r.rid}] ttft={r.ttft_s * 1e3:.0f}ms | {r.tokens}")
    if args.metrics_out:
        eng.metrics.emit(args.metrics_out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
