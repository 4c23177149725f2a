"""Training-state checkpoint and restore for crash recovery (counterpart of
piquant_tpu/utils/checkpoint.py).

(params, optimizer state, step) determine a run, so a restart is a restore
and a continue.  `save_checkpoint` flattens any tree (`utils/tree.py`: dict
keys sorted, as `jax.tree.leaves` orders them) into one npz and
`restore_checkpoint` rebuilds into a caller's template of the same
structure.  The files are the reference's: `leaves.npz` (`leaf_{i}`, bf16
as its uint16 bits), `meta.json` (`format_version` 1, `step`, `n_leaves`,
`dtypes` by numpy's names) and the rename of the leaves' file as the last
act, so a crash mid-save leaves the previous checkpoint loadable.  A params
checkpoint written by either package therefore restores into the other's
template bit for bit.  The optimizer state is the port's own
(`train.Optimizer`: the torch optimizers' state tensors of each leaf, keys
sorted), so it does not cross packages.
"""

from __future__ import annotations

import json
import os
from typing import Any, Tuple

import numpy as np
import torch

from piquant_tpu_torch.utils.tree import flatten

FORMAT_VERSION = 1

# torch dtypes by the names numpy (and the reference's meta.json) give them
_NAMES = {torch.float32: "float32", torch.float64: "float64",
          torch.float16: "float16", torch.bfloat16: "bfloat16",
          torch.int8: "int8", torch.uint8: "uint8", torch.int16: "int16",
          torch.int32: "int32", torch.int64: "int64", torch.bool: "bool"}
_DTYPES = {v: k for k, v in _NAMES.items()}


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(the array npz holds, the leaf's logical dtype name)."""
    if not isinstance(leaf, torch.Tensor):
        arr = np.asarray(leaf)
        return arr, str(arr.dtype)
    t = leaf.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:     # npz holds no bf16: its raw bits
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), _NAMES[t.dtype]


def save_checkpoint(path: str, state: Any, *, step: int = 0) -> None:
    """Write `state` (any tree) and the step counter to directory `path`."""
    os.makedirs(path, exist_ok=True)
    leaves, _ = flatten(state)
    arrays, dtypes = {}, []
    for i, leaf in enumerate(leaves):
        arr, name = _to_numpy(leaf)
        arrays[f"leaf_{i}"] = arr
        dtypes.append(name)
    tmp = os.path.join(path, "leaves_tmp.npz")  # np.savez appends .npz to
    np.savez(tmp, **arrays)                     # names without the suffix
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({"format_version": FORMAT_VERSION, "step": step,
                   "n_leaves": len(leaves), "dtypes": dtypes}, f)
    os.replace(tmp, os.path.join(path, "leaves.npz"))


def _from_numpy(arr: np.ndarray, logical: str, like) -> Any:
    if not isinstance(like, torch.Tensor):
        return arr.item() if arr.ndim == 0 and np.isscalar(like) else arr
    if logical == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if t.dtype != like.dtype or t.shape != like.shape:
        raise ValueError(f"checkpoint leaf {logical}{list(t.shape)} against "
                         f"the template's {like.dtype}{list(like.shape)} — "
                         "model/optimizer mismatch")
    return t.to(like.device)


def restore_checkpoint(path: str, template: Any) -> Tuple[Any, int]:
    """Rebuild a state tree with `template`'s structure (and its leaves'
    devices) from `path`.  Returns (state, step).  Raises ValueError if the
    leaf count, a shape or a dtype does not match the template (wrong
    model/optimizer geometry)."""
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if meta["format_version"] != FORMAT_VERSION:
        raise ValueError(f"checkpoint format {meta['format_version']} != "
                         f"supported {FORMAT_VERSION}")
    like, unflatten = flatten(template)
    if len(like) != meta["n_leaves"]:
        raise ValueError(
            f"checkpoint has {meta['n_leaves']} leaves but the template "
            f"needs {len(like)} — model/optimizer mismatch")
    with np.load(os.path.join(path, "leaves.npz")) as data:
        leaves = [_from_numpy(data[f"leaf_{i}"], logical, lk)
                  for i, (logical, lk) in enumerate(zip(meta["dtypes"],
                                                        like))]
    return unflatten(leaves), meta["step"]
