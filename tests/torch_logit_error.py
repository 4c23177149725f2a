"""Measure the logit errors that set the kv4 and NF4 model-test tolerances
(tests/test_torch_kv4.py KV4_LOGIT_TOL, tests/test_torch_nf4.py).

    JAX_PLATFORMS=cpu python tests/torch_logit_error.py

Prints max |a - b| / max |b| over prefill + 3 decode steps (batch 2, 128
prompt tokens) for:
  * the JAX package's kv8 and kv4 decode against its own forward without
    a cache (float K/V), on the head_dim-128 test config and `tiny`;
  * the port against the JAX package at kv_bits=4, JAX forced onto its
    decode_attn2 kernel in interpret mode;
  * the port against the JAX package at NF4 weights, channelwise and g64.
Not a test: a few minutes on the CPU.
"""

import dataclasses
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path[:0] = [os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                os.path.dirname(os.path.abspath(__file__))]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from piquant_tpu.models import llama as JM  # noqa: E402
from piquant_tpu_torch import convert  # noqa: E402
from test_torch_model import KCFG, _run_jax, _run_port  # noqa: E402

CONFIGS = {"kernel_shapes": lambda: JM.LlamaConfig(**KCFG),
           "tiny": JM.LlamaConfig.tiny}
SEEDS = (0x4B34, 1, 2)


def rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


def tokens(seed):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.integers(1, 256, (2, 131)), jnp.int32)


def port_pair(jcfg, jparams):
    return (convert.config_from_jax(jcfg),
            convert.params_from_jax(jparams, device=torch.device("cpu")))


def main():
    for name, make in CONFIGS.items():
        for kv_bits in (8, 4):
            for seed in SEEDS:
                jcfg = dataclasses.replace(make(), kv_bits=kv_bits)
                jp = JM.quantize_params(
                    JM.init_params(jcfg, jax.random.key(seed)), bits=4)
                toks = tokens(seed)
                cached = _run_jax(jcfg, jp, toks, 3)[1:].transpose(1, 0, 2)
                full = np.asarray(JM.forward(jcfg, jp, toks)[0])[:, 128:131]
                print(f"jax kv{kv_bits} vs float-K/V forward, {name}, seed "
                      f"{seed}: {rel(cached, full):.4f}", flush=True)
    os.environ["PIQUANT_ATTN2"] = "force"
    for name, make in CONFIGS.items():
        for seed in SEEDS:
            jcfg = dataclasses.replace(make(), kv_bits=4)
            jp = JM.quantize_params(JM.init_params(jcfg, jax.random.key(seed)),
                                    bits=4)
            toks = tokens(seed)
            with jax.enable_x64(False):
                want = _run_jax(jcfg, jp, toks, 3, jit=True)
            got = _run_port(*port_pair(jcfg, jp), toks, 3)
            print(f"port vs jax, kv4, {name}, seed {seed}: "
                  f"{rel(got, want):.4f}", flush=True)
    del os.environ["PIQUANT_ATTN2"]
    for kw in (dict(bits="nf4"), dict(bits="nf4", group_size=64)):
        for seed in (0x4F4, 1):
            jcfg = JM.LlamaConfig(**KCFG)
            jp = JM.quantize_params(JM.init_params(jcfg, jax.random.key(seed)),
                                    **kw)
            toks = tokens(seed)
            want = _run_jax(jcfg, jp, toks, 3, jit=True)
            got = _run_port(*port_pair(jcfg, jp), toks, 3)
            print(f"port vs jax, {kw}, seed {seed}: {rel(got, want):.4f}",
                  flush=True)


if __name__ == "__main__":
    main()
