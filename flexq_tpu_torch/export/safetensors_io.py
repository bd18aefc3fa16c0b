"""Read and write the safetensors file format over torch tensors.

The port's own reader and writer, so that neither the checkpoint loader nor
the exporter needs the ``safetensors`` package. A file is:

    8 bytes     little-endian u64: the header's length N
    N bytes     a JSON object: for each tensor {"dtype", "shape",
                "data_offsets": [begin, end]} (offsets into the data
                region), and an optional "__metadata__" of strings; the
                writer pads it with spaces to a multiple of 8 bytes
    the rest    every tensor's raw little-endian bytes, C order

bf16 buffers are read as uint16 and reinterpreted as torch.bfloat16, bit
for bit (numpy has no bf16). The writer lays the tensors out as the
``safetensors`` package does (by dtype, then by name), so either side reads
the other's files.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Optional

import numpy as np
import torch

# safetensors dtype name -> (torch dtype, numpy dtype of the same bytes)
_DTYPES = {
    "BF16": (torch.bfloat16, np.uint16),
    "F16": (torch.float16, np.float16),
    "F32": (torch.float32, np.float32),
    "F64": (torch.float64, np.float64),
    "I8": (torch.int8, np.int8),
    "U8": (torch.uint8, np.uint8),
    "I16": (torch.int16, np.int16),
    "I32": (torch.int32, np.int32),
    "I64": (torch.int64, np.int64),
    "BOOL": (torch.bool, np.bool_),
}
_NAMES = {tdt: name for name, (tdt, _) in _DTYPES.items()}
# the safetensors package's dtype order; its writer lays tensors out by
# descending dtype, then by name
_RANK = {n: i for i, n in enumerate(("BOOL", "U8", "I8", "I16", "F16", "BF16", "I32", "F32", "F64", "I64"))}


def _read_header(f, path: str):
    raw = f.read(8)
    if len(raw) != 8:
        raise ValueError(f"{path}: not a safetensors file (shorter than its 8-byte header length)")
    (n,) = struct.unpack("<Q", raw)
    if n > os.fstat(f.fileno()).st_size - 8:
        raise ValueError(f"{path}: header length {n} runs past the end of the file")
    return json.loads(f.read(n)), 8 + n


def load_file(path: str, device="cpu") -> Dict[str, torch.Tensor]:
    """Every tensor of the file, by name, on ``device``."""
    with open(path, "rb") as f:
        header, start = _read_header(f, path)
        data = np.fromfile(f, dtype=np.uint8)
    out: Dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has unsupported dtype {info['dtype']}")
        tdt, ndt = _DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        if end > data.size or end - begin != int(np.prod(shape, dtype=np.int64)) * np.dtype(ndt).itemsize:
            raise ValueError(f"{path}: tensor {name!r}: data_offsets {begin}..{end} do not fit {shape}")
        buf = data[begin:end]
        if (start + begin) % np.dtype(ndt).itemsize:
            buf = buf.copy()  # an unaligned buffer: numpy views need aligned elements for torch
        t = torch.from_numpy(buf.view(ndt).reshape(shape))
        if tdt == torch.bfloat16:
            t = t.view(torch.bfloat16)
        out[name] = t.to(device)
    return out


def save_file(tensors: Dict[str, torch.Tensor], path: str, metadata: Optional[Dict[str, str]] = None) -> None:
    """Write ``tensors`` (any device; copied to the host, C order)."""
    host = {}
    for name, t in tensors.items():
        if t.dtype not in _NAMES:
            raise ValueError(f"tensor {name!r}: dtype {t.dtype} has no safetensors name")
        host[name] = t.detach().to("cpu").contiguous()
    order = sorted(host, key=lambda k: (-_RANK[_NAMES[host[k].dtype]], k))
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for name in order:
        t = host[name]
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape), "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name in order:
            t = host[name]
            if t.numel():
                f.write(t.reshape(-1).view(torch.uint8).numpy())
