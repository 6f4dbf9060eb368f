"""The safetensors file format, read and written with numpy alone.

A file is an 8-byte little-endian header length N, N bytes of JSON (each
tensor's dtype, shape and [begin, end) byte offsets into the data that
follows, and an optional "__metadata__" map of strings), then the raw
little-endian tensor bytes.  The port writes the HF serving checkpoint
(bin/export_serving_lm.py) this way, so it needs no `safetensors` package.
"""
from __future__ import annotations

import json
import struct

import numpy as np
import torch

_DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
           "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
           "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}
_NAMES = {v: k for k, v in _DTYPES.items()}


def _bytes(t: torch.Tensor) -> bytes:
    """The tensor's bytes in memory order (a little-endian host's, as x86 and
    the GPU machines are)."""
    t = t.detach().cpu().contiguous()
    return t.view(torch.int16).numpy().tobytes() if t.dtype == torch.bfloat16 else \
        t.numpy().tobytes()


def save_safetensors(path: str, tensors: dict, metadata: dict | None = None) -> None:
    """{name: tensor or array} -> `path`, tensors in name order."""
    header, blobs, offset = {}, [], 0
    for name in sorted(tensors):
        t = torch.as_tensor(tensors[name])
        if t.dtype not in _NAMES:
            raise TypeError(f"{name}: safetensors has no dtype for {t.dtype}")
        blob = _bytes(t)
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(blob)]}
        blobs.append(blob)
        offset += len(blob)
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)          # the data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for blob in blobs:
            f.write(blob)


def load_safetensors(path: str) -> dict:
    """`path` -> {name: CPU tensor}."""
    with open(path, "rb") as f:
        data = f.read()
    (n,) = struct.unpack("<Q", data[:8])
    header = json.loads(data[8:8 + n])
    body = memoryview(data)[8 + n:]
    out = {}
    for name, spec in header.items():
        if name == "__metadata__":
            continue
        dtype = _DTYPES[spec["dtype"]]
        begin, end = spec["data_offsets"]
        if begin == end:
            out[name] = torch.empty(spec["shape"], dtype=dtype)
            continue
        raw = torch.from_numpy(np.frombuffer(body[begin:end], np.uint8).copy())
        out[name] = raw.view(dtype).reshape(spec["shape"])
    return out
