"""safetensors files, read and written in plain Python, numpy and torch
(counterpart of piquant_tpu/utils/safetensors_io.py, which calls the
`safetensors` package; the port needs no such package).

The container: an 8-byte little-endian header length N, N bytes of JSON
(each tensor's dtype, shape and [begin, end) byte offsets into the data
that follows, and an optional `__metadata__` map of strings), then the
raw little-endian bytes.  `save_file` / `load_file` write and read one
file; a file is memory-mapped and each tensor copied once to the target
device.  `load_checkpoint` reads an HF checkpoint directory: its shards by
`model.safetensors.index.json`'s weight_map, or a lone
`model.safetensors`; `save_checkpoint` writes one in shards with that
index.

`save_safetensors` / `load_safetensors` are the reference's export of a
quantized param pytree into one such file: the same "t"-prefixed keys
(the flattened paths of utils/weight_cache.py), the same `piquant_format`
and `piquant_tree` metadata, bf16 leaves stored as their uint16 bits (the
reference's fixup: safetensors' numpy side has no bfloat16), so files
cross between the two packages both ways.  The grouped side streams
(s_chunk / z_chunk) are rebuilt at load, as there.

    save_safetensors("model.safetensors", qparams)
    qparams = load_safetensors("model.safetensors", device="cuda")
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Any, Dict, Optional

import torch

from piquant_tpu_torch._device import DeviceLike, resolve_device

__all__ = ["save_file", "load_file", "read_header", "load_checkpoint",
           "save_checkpoint", "save_safetensors", "load_safetensors"]

FORMAT_VERSION = 1
INDEX = "model.safetensors.index.json"
SINGLE = "model.safetensors"

# the container's dtype names <-> torch dtypes
DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
          "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
          "I16": torch.int16, "U16": torch.uint16, "I8": torch.int8,
          "U8": torch.uint8, "BOOL": torch.bool}
_NAMES = {v: k for k, v in DTYPES.items()}


def _header(f):
    """(header, offset of the data) of an open file."""
    n = struct.unpack("<Q", f.read(8))[0]
    return json.loads(f.read(n)), 8 + n


def read_header(path) -> Dict[str, Any]:
    """The file's JSON header: {name: {"dtype", "shape", "data_offsets"}},
    and `__metadata__` where the file has one."""
    with open(path, "rb") as f:
        return _header(f)[0]


def load_file(path, device: DeviceLike = None,
              names=None) -> Dict[str, torch.Tensor]:
    """{name: tensor} of one safetensors file (or of `names` alone), each
    tensor copied once from the memory-mapped file to `device` (default
    CUDA).  Raises on a dtype the container lists that this reader does
    not take, and on offsets that disagree with a tensor's shape."""
    dev = resolve_device(device)
    out = {}
    with open(path, "rb") as f:
        header, start = _header(f)
        header.pop("__metadata__", None)
        # copy-on-write pages: torch.frombuffer wants a writable buffer, and
        # nothing is ever written back to the file
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
        try:
            for name in (header if names is None else names):
                info = header[name]
                if info["dtype"] not in DTYPES:
                    raise TypeError(f"{path}: {name} has dtype "
                                    f"{info['dtype']}, which this reader "
                                    f"does not take ({sorted(DTYPES)})")
                dt = DTYPES[info["dtype"]]
                shape = tuple(info["shape"])
                b0, b1 = info["data_offsets"]
                numel = 1
                for s in shape:
                    numel *= s
                if b1 - b0 != numel * dt.itemsize or start + b1 > len(mm):
                    raise ValueError(f"{path}: {name}'s offsets {b0}-{b1} do "
                                     f"not hold a {list(shape)} "
                                     f"{info['dtype']} tensor")
                if numel == 0:
                    out[name] = torch.empty(shape, dtype=dt, device=dev)
                    continue
                view = torch.frombuffer(mm, dtype=dt, count=numel,
                                        offset=start + b0).reshape(shape)
                out[name] = view.to(dev, copy=True)
                del view
        finally:
            mm.close()
    return out


def save_file(tensors: Dict[str, torch.Tensor], path,
              metadata: Optional[Dict[str, str]] = None) -> None:
    """Write {name: tensor} (on any device) as one safetensors file, the
    tensors ordered by item size then name so that every offset is aligned
    to its dtype, the header padded with spaces to 8 bytes."""
    items = sorted(tensors.items(),
                   key=lambda kv: (-kv[1].element_size(), kv[0]))
    header: Dict[str, Any] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    off = 0
    for name, t in items:
        if t.dtype not in _NAMES:
            raise TypeError(f"{name}: dtype {t.dtype} has no safetensors "
                            "name here")
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + n]}
        off += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for _, t in items:
            if t.numel():
                b = t.detach().contiguous().reshape(-1).view(torch.uint8)
                f.write(memoryview(b.cpu().numpy()))


def load_checkpoint(directory, device: DeviceLike = None
                    ) -> Dict[str, torch.Tensor]:
    """The state dict of an HF checkpoint directory: the shards named by
    `model.safetensors.index.json`'s weight_map, else `model.safetensors`,
    each tensor copied once to `device`."""
    idx = os.path.join(directory, INDEX)
    if os.path.exists(idx):
        with open(idx) as f:
            weight_map = json.load(f)["weight_map"]
        by_shard: Dict[str, list] = {}
        for name, shard in weight_map.items():
            by_shard.setdefault(shard, []).append(name)
        out = {}
        for shard, names in sorted(by_shard.items()):
            out.update(load_file(os.path.join(directory, shard), device,
                                 names))
        return out
    single = os.path.join(directory, SINGLE)
    if os.path.exists(single):
        return load_file(single, device)
    raise FileNotFoundError(f"{directory}: no {INDEX} or {SINGLE}")


def save_checkpoint(tensors: Dict[str, torch.Tensor], directory,
                    shards: int = 1) -> list:
    """Write a state dict as an HF checkpoint directory: `shards` files of
    about equal bytes, in the state dict's order, named
    model-0000i-of-0000n.safetensors, with `model.safetensors.index.json`
    (the total size and the weight_map); one shard is `model.safetensors`
    alone.  Returns the files written."""
    os.makedirs(directory, exist_ok=True)
    names = list(tensors)
    if shards <= 1:
        path = os.path.join(directory, SINGLE)
        save_file(tensors, path)
        return [path]
    total = sum(t.numel() * t.element_size() for t in tensors.values())
    groups, acc, cur = [[] for _ in range(shards)], 0, 0
    for name in names:
        if cur < shards - 1 and acc >= total * (cur + 1) / shards:
            cur += 1
        groups[cur].append(name)
        acc += tensors[name].numel() * tensors[name].element_size()
    groups = [g for g in groups if g]
    files, weight_map = [], {}
    for i, group in enumerate(groups):
        fname = f"model-{i + 1:05d}-of-{len(groups):05d}.safetensors"
        save_file({n: tensors[n] for n in group},
                  os.path.join(directory, fname))
        files.append(os.path.join(directory, fname))
        weight_map.update({n: fname for n in group})
    with open(os.path.join(directory, INDEX), "w") as f:
        json.dump({"metadata": {"total_size": total},
                   "weight_map": weight_map}, f, indent=2)
    return files


# ---------------------------------------------------------------------------
# quantized param pytrees (the reference's export)
# ---------------------------------------------------------------------------

def save_safetensors(path, params: Any) -> None:
    """Write params (dicts and lists of tensors, QuantizedLinear and
    QuantizedExpertStack leaves) to one .safetensors file, flattened as
    utils/weight_cache.py flattens them."""
    from piquant_tpu_torch.utils.weight_cache import flatten

    leaves, meta = flatten(params)
    save_file({"t" + k: v for k, v in leaves.items()}, path,
              metadata={"piquant_format": str(FORMAT_VERSION),
                        "piquant_tree": json.dumps(meta)})


def load_safetensors(path, device: DeviceLike = None) -> Any:
    """Inverse of save_safetensors (and of the reference's), on `device`
    (default CUDA)."""
    from piquant_tpu_torch.utils.weight_cache import unflatten

    md = read_header(path).get("__metadata__") or {}
    if md.get("piquant_format") != str(FORMAT_VERSION):
        raise ValueError(
            f"{path}: piquant_format {md.get('piquant_format')!r} != "
            f"supported {FORMAT_VERSION} (not a piquant-tpu checkpoint?)")
    data = {k[1:]: v for k, v in load_file(path, device).items()}
    return unflatten(json.loads(md["piquant_tree"]), data)
