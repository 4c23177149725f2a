"""Read what torch.profiler's host-op events cost a profiled decode step.

    python3 tools/profiler_cost.py [LAYERS]

On the card, one decode step at batch 8 of Qwen3-30B-A3B at its full width
and LAYERS layers (default 8; random INT4 codes, the INT8 lm_head) is
profiled twice each way, alternating: with CPU and CUDA activity (host ops
and kernels) and with CUDA activity alone (kernels and runtime calls).  For
each: the step's wall time under the profiler, the seconds the profiler
takes to stop and `key_averages()` takes to run, and the kernels and device
ms that `chip_smoke.py::profile_decode` reads from it.  Prints a line each,
with the card's name and power limit.
"""
import dataclasses
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import card_line  # noqa: E402
from piquant_tpu_torch.models import llama as M  # noqa: E402


def main() -> int:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    layers = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    dev = torch.device("cuda")
    cfg = dataclasses.replace(M.LlamaConfig.qwen3_moe_a3b(), n_layers=layers)
    params = M.random_quantized_params(cfg, seed=0, lm_head_bits=8,
                                       device=dev)
    cache = M.init_kv_cache(cfg, 8, max_len=2048, device=dev)
    tok = torch.ones(8, dtype=torch.int32, device=dev)
    pos = torch.arange(500, 516, 2, dtype=torch.int32, device=dev)
    M.decode_step(cfg, params, tok, pos, cache)
    torch.cuda.synchronize()
    both = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for acts in (both, [ProfilerActivity.CUDA]) * 2:
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            M.decode_step(cfg, params, tok, pos, cache)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
        t2 = time.perf_counter()
        rows = [(e.device_time_total / 1e3, e.count)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.device_time_total > 0]
        t3 = time.perf_counter()
        print(f"{'+'.join(a.name for a in acts)}: A3B at {layers} layers, "
              f"step wall {(t1 - t0) * 1e3:.1f} ms, profiler stop "
              f"{t2 - t1:.2f} s, key_averages {t3 - t2:.2f} s, "
              f"{sum(r[1] for r in rows)} kernels, "
              f"{sum(r[0] for r in rows):.2f} device ms [{card_line()}]",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
