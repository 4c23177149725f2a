"""Quantized-weight disk cache (counterpart of
piquant_tpu/utils/weight_cache.py): serving restarts load the packed
weights instead of quantizing a checkpoint again.

Format version 2, the reference's: one `leaves.npz` of the flattened
leaves plus `manifest.json` (the tree's structure, each quantized leaf's
bits / k / group_size / codebook, each array's logical dtype), no pickle.
bf16 leaves are stored as their uint16 bits.  The grouped INT2 / INT4 side
streams (s_chunk / z_chunk) are not stored: they are rebuilt at load with
quant/linear.py's `_grouped_cache`.  The files cross between the two
packages both ways.

    save_quantized("cache_dir", qparams)
    qparams = load_quantized("cache_dir", device="cuda")
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Tuple

import numpy as np
import torch

from piquant_tpu_torch._device import DeviceLike, resolve_device
from piquant_tpu_torch.quant.linear import (QuantizedExpertStack,
                                            QuantizedLinear, _grouped_cache)

FORMAT_VERSION = 2

# logical dtype names as numpy (and the reference's manifest) spell them
_LOGICAL = {torch.float64: "float64", torch.float32: "float32",
            torch.float16: "float16", torch.bfloat16: "bfloat16",
            torch.int64: "int64", torch.int32: "int32", torch.int16: "int16",
            torch.uint16: "uint16", torch.int8: "int8", torch.uint8: "uint8",
            torch.bool: "bool"}
_TORCH = {v: k for k, v in _LOGICAL.items()}


def flatten(params) -> Tuple[Dict[str, torch.Tensor], list]:
    """(leaves by path, manifest nodes): the reference's walk
    (`_flatten_with_meta`), dicts in sorted key order, a quantized leaf as
    its .data / .scale / .zp tensors, a bf16 leaf as its uint16 bits with
    its logical dtype in the node; a Python int (a fused layer's
    `fused_tp`) as a 0-d int64 array."""
    leaves: Dict[str, torch.Tensor] = {}
    meta = []

    def visit(path, node):
        if isinstance(node, (QuantizedLinear, QuantizedExpertStack)):
            leaves[path + ".data"] = node.data
            leaves[path + ".scale"] = node.scale
            leaves[path + ".zp"] = node.zero_point
            kind = ("qexperts" if isinstance(node, QuantizedExpertStack)
                    else "qlinear")
            meta.append({"path": path, "kind": kind, "bits": node.bits,
                         "k": node.k, "group_size": node.group_size,
                         "codebook": node.codebook})
        elif isinstance(node, dict):
            meta.append({"path": path, "kind": "dict",
                         "keys": sorted(node.keys())})
            for k in sorted(node.keys()):
                visit(f"{path}/{k}", node[k])
        elif isinstance(node, (list, tuple)):
            meta.append({"path": path, "kind": "list", "n": len(node)})
            for i, v in enumerate(node):
                visit(f"{path}/{i}", v)
        else:
            t = torch.as_tensor(node)
            logical = _LOGICAL[t.dtype]
            if t.dtype == torch.bfloat16:
                t = t.view(torch.uint16)
            leaves[path] = t
            meta.append({"path": path, "kind": "array", "dtype": logical})

    visit("", params)
    return leaves, meta


def unflatten(meta: list, data: Dict[str, torch.Tensor]) -> Any:
    """Inverse of `flatten` over leaves already on their device: quantized
    leaves with the grouped side streams rebuilt, bf16 bits viewed back,
    a fused layer's `fused_tp` an int again."""
    nodes = {m["path"]: m for m in meta}

    def build(path):
        m = nodes[path]
        if m["kind"] in ("qlinear", "qexperts"):
            cls = (QuantizedExpertStack if m["kind"] == "qexperts"
                   else QuantizedLinear)
            scale, zp = data[path + ".scale"], data[path + ".zp"]
            gs, codebook = m.get("group_size"), m.get("codebook")
            s_chunk = z_chunk = None
            if m["bits"] in (2, 4) and gs is not None and codebook is None:
                s_chunk, z_chunk = _grouped_cache(scale, zp, m["k"], gs,
                                                  m["bits"])
            return cls(data=data[path + ".data"], scale=scale,
                       zero_point=zp, bits=m["bits"], k=m["k"],
                       group_size=gs, s_chunk=s_chunk, z_chunk=z_chunk,
                       codebook=codebook)
        if m["kind"] == "dict":
            return {k: build(f"{path}/{k}") for k in m["keys"]}
        if m["kind"] == "list":
            return [build(f"{path}/{i}") for i in range(m["n"])]
        t = data[path]
        logical = _TORCH[m.get("dtype", _LOGICAL[t.dtype])]
        if logical != t.dtype:
            t = t.view(logical)
        if path.endswith("/fused_tp") and t.ndim == 0:
            return int(t)
        return t

    return build("")


def save_quantized(path, params: Any) -> None:
    """Write params (a pytree with QuantizedLinear / QuantizedExpertStack
    leaves, on any device) to the directory `path`."""
    os.makedirs(path, exist_ok=True)
    leaves, meta = flatten(params)
    np.savez(os.path.join(path, "leaves.npz"),
             **{k: v.detach().cpu().numpy() for k, v in leaves.items()})
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump({"format_version": FORMAT_VERSION, "nodes": meta}, f)


def load_quantized(path, device: DeviceLike = None) -> Any:
    """Inverse of save_quantized (and of the reference's), on `device`
    (default CUDA)."""
    dev = resolve_device(device)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if manifest["format_version"] != FORMAT_VERSION:
        raise ValueError(
            f"weight cache format {manifest['format_version']} != "
            f"supported {FORMAT_VERSION}")
    with np.load(os.path.join(path, "leaves.npz")) as npz:
        data = {k: torch.from_numpy(np.array(npz[k], order="C")).to(dev)
                for k in npz.files}
    return unflatten(manifest["nodes"], data)
