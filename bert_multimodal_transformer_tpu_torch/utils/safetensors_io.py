"""Pure-numpy safetensors reader/writer (a copy of the JAX package's
``utils/safetensors_io.py``; no ``safetensors`` package needed).

Current HF checkpoints ship ``model.safetensors`` rather than the
torch-pickle ``pytorch_model.bin`` of the reference's era
(multimodal_driver.py:316-323 loads either through ``from_pretrained``),
so ``--pretrained_checkpoint`` reads both, and ``--export_hf`` writes this
format to a path ending in ``.safetensors``. The format
(github.com/huggingface/safetensors) is:

    [uint64 LE header_size][header_size bytes of JSON][raw tensor data]

where the JSON maps tensor name → {"dtype", "shape",
"data_offsets": [begin, end]} (offsets relative to the data section)
plus an optional "__metadata__" object. No pickle, no arbitrary code
execution: a plain binary parse.

bfloat16 has no numpy dtype; BF16 tensors are widened to float32 by
bit-shifting the uint16 payload into the upper half of a uint32
(exactly the bf16→f32 embedding, no rounding involved).
"""

from __future__ import annotations

import json
import struct
from typing import Dict, Optional

import numpy as np

_DTYPES = {
    "F64": np.dtype("<f8"),
    "F32": np.dtype("<f4"),
    "F16": np.dtype("<f2"),
    "I64": np.dtype("<i8"),
    "I32": np.dtype("<i4"),
    "I16": np.dtype("<i2"),
    "I8": np.dtype("i1"),
    "U8": np.dtype("u1"),
    "BOOL": np.dtype("?"),
    # BF16 handled specially (no numpy dtype)
}

_TO_SAFETENSORS = {
    np.dtype("float64"): "F64",
    np.dtype("float32"): "F32",
    np.dtype("float16"): "F16",
    np.dtype("int64"): "I64",
    np.dtype("int32"): "I32",
    np.dtype("int16"): "I16",
    np.dtype("int8"): "I8",
    np.dtype("uint8"): "U8",
    np.dtype("bool"): "BOOL",
}


def load_safetensors(path: str) -> Dict[str, np.ndarray]:
    """Read a .safetensors file into {name: numpy array}. BF16 tensors
    come back as float32 (exact widening)."""
    with open(path, "rb") as f:
        raw = f.read()
    if len(raw) < 8:
        raise ValueError(f"{path}: not a safetensors file (too short)")
    (header_size,) = struct.unpack("<Q", raw[:8])
    if 8 + header_size > len(raw):
        raise ValueError(f"{path}: truncated safetensors header "
                         f"({header_size} > {len(raw) - 8})")
    header = json.loads(raw[8:8 + header_size])
    data = memoryview(raw)[8 + header_size:]
    out: Dict[str, np.ndarray] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype_tag = info["dtype"]
        shape = tuple(info["shape"])
        begin, end = info["data_offsets"]
        if not (0 <= begin <= end <= len(data)):
            raise ValueError(f"{path}: tensor {name!r} offsets "
                             f"[{begin}, {end}) out of bounds")
        buf = data[begin:end]
        if dtype_tag == "BF16":
            u16 = np.frombuffer(buf, dtype="<u2")
            arr = (u16.astype(np.uint32) << 16).view(np.float32)
        else:
            dt = _DTYPES.get(dtype_tag)
            if dt is None:
                raise ValueError(
                    f"{path}: unsupported safetensors dtype {dtype_tag!r}")
            arr = np.frombuffer(buf, dtype=dt)
        expected = int(np.prod(shape, dtype=np.int64)) if shape else 1
        if arr.size != expected:
            raise ValueError(
                f"{path}: tensor {name!r} payload has {arr.size} elements, "
                f"shape {shape} needs {expected}")
        out[name] = arr.reshape(shape).copy()
    return out


def save_safetensors(path: str, tensors: Dict[str, np.ndarray],
                     metadata: Optional[Dict[str, str]] = None) -> None:
    """Write {name: numpy array} as a .safetensors file (used for
    round-trip tests and to export native checkpoints in the format
    current HF tooling expects)."""
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = dict(metadata)
    blobs = []
    offset = 0
    for name in sorted(tensors):
        arr = np.ascontiguousarray(tensors[name])
        if arr.dtype.byteorder == ">":
            # normalize BEFORE the tag lookup: a big-endian dtype never
            # equals its native-order key in _TO_SAFETENSORS
            arr = arr.astype(arr.dtype.newbyteorder("<"))
        tag = _TO_SAFETENSORS.get(arr.dtype)
        if tag is None:
            raise ValueError(f"unsupported dtype {arr.dtype} for {name!r}")
        blob = arr.tobytes()
        header[name] = {"dtype": tag, "shape": list(arr.shape),
                        "data_offsets": [offset, offset + len(blob)]}
        blobs.append(blob)
        offset += len(blob)
    hjson = json.dumps(header, separators=(",", ":")).encode("utf-8")
    # spec: header is padded with spaces to an 8-byte multiple
    pad = (-(8 + len(hjson))) % 8
    hjson += b" " * pad
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hjson)))
        f.write(hjson)
        for blob in blobs:
            f.write(blob)
