"""The safetensors file format, read and written without the package.

A file is an 8-byte little-endian header length ``n``, then ``n`` bytes of
JSON, then the tensors' raw little-endian bytes. The header maps each
tensor's name to ``{"dtype", "shape", "data_offsets": [begin, end]}``
(offsets into the byte section) and may hold ``"__metadata__"``, a map of
strings. The writer pads the header with spaces to a multiple of 8 bytes,
as the ``safetensors`` package does, so that every tensor's bytes start
aligned.

:func:`load_file` maps the file and copies each tensor out of the map into
memory of its own, then moves it to ``device``: the host holds one tensor
at a time, never the whole file. Tensors keep the file's dtype (bf16 and
the I64 ``position_ids`` of CLIP files included).
"""

from __future__ import annotations

import json
import mmap
import os
import sys
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from edgestyle_tpu_torch.core.device import DeviceLike, resolve_device

DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}
NAMES = {v: k for k, v in DTYPES.items()}
MAX_HEADER = 100 * 2 ** 20  # the package's own limit on the JSON header


def _check_byteorder() -> None:
    if sys.byteorder != "little":
        raise NotImplementedError("safetensors files are little-endian; this host is not")


def read_header(path: str):
    """(header dict without ``__metadata__``, metadata or None, byte
    section's start, file size), with every entry checked: a known dtype,
    offsets that match the shape's size, lie in the file and do not
    overlap."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) != 8:
            raise ValueError(f"{path}: shorter than the 8-byte header length")
        n = int.from_bytes(head, "little")
        if n > MAX_HEADER or 8 + n > size:
            raise ValueError(f"{path}: header length {n} does not fit the file ({size} bytes)")
        try:
            header = json.loads(f.read(n))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise ValueError(f"{path}: the header is not JSON ({e})") from e
    if not isinstance(header, dict):
        raise ValueError(f"{path}: the header is not a JSON object")
    metadata = header.pop("__metadata__", None)
    if metadata is not None and not (isinstance(metadata, dict) and all(
            isinstance(k, str) and isinstance(v, str) for k, v in metadata.items())):
        raise ValueError(f"{path}: __metadata__ must map strings to strings")
    start, spans = 8 + n, []
    for name, e in header.items():
        try:
            dtype, shape, (a, b) = DTYPES[e["dtype"]], e["shape"], e["data_offsets"]
        except (KeyError, TypeError, ValueError) as err:
            raise ValueError(f"{path}: tensor {name!r} has a malformed entry {e!r}") from err
        if not (isinstance(shape, list) and all(isinstance(d, int) and d >= 0 for d in shape)):
            raise ValueError(f"{path}: tensor {name!r} has a malformed shape {shape!r}")
        want = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        if not (isinstance(a, int) and isinstance(b, int) and 0 <= a <= b):
            raise ValueError(f"{path}: tensor {name!r} has offsets {[a, b]}")
        if b - a != want:
            raise ValueError(f"{path}: tensor {name!r} spans {b - a} bytes, its shape "
                             f"{shape} of {e['dtype']} needs {want}")
        if start + b > size:
            raise ValueError(f"{path}: tensor {name!r} runs past the end of the file")
        spans.append((a, b, name))
    spans.sort()
    for (a0, b0, n0), (a1, b1, n1) in zip(spans, spans[1:]):
        if a1 < b0:
            raise ValueError(f"{path}: tensors {n0!r} and {n1!r} overlap")
    return header, metadata, start, size


def load_file(path: str, device: DeviceLike = "cpu") -> Dict[str, torch.Tensor]:
    """{name: tensor} of a safetensors file, each tensor in the file's dtype
    on ``device``, in the file's order of offsets."""
    _check_byteorder()
    dev = resolve_device(device)
    header, _, start, size = read_header(path)
    order = sorted(header, key=lambda k: header[k]["data_offsets"][0])
    out = {}
    with open(path, "rb") as f:
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) if size > start else None
        try:
            for name in order:
                e = header[name]
                a, b = e["data_offsets"]
                host = torch.empty(b - a, dtype=torch.uint8)
                if b > a:
                    host.numpy()[:] = np.frombuffer(mm, np.uint8, b - a, start + a)
                t = host.view(DTYPES[e["dtype"]]).reshape(e["shape"])
                out[name] = t.to(dev)
        finally:
            if mm is not None:
                mm.close()
    return out


def save_file(tensors: Mapping[str, torch.Tensor], path: str,
              metadata: Optional[Mapping[str, str]] = None) -> int:
    """Write ``tensors`` (any device, any memory format: each is written in
    its logical row-major order) to ``path``, widest dtype first and then
    by name, as the package orders them, so that each tensor's bytes are
    aligned to its element size; returns the file's size. The file is
    written beside ``path`` and then moved over it, so a reader never sees
    half a file."""
    _check_byteorder()
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    names = sorted(tensors, key=lambda k: (-tensors[k].element_size(), k))
    offset = 0
    for name in names:
        t = tensors[name]
        if t.dtype not in NAMES:
            raise ValueError(f"tensor {name!r}: dtype {t.dtype} has no safetensors name")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(len(blob).to_bytes(8, "little"))
        f.write(blob)
        for name in names:
            t = tensors[name].detach().contiguous().cpu().reshape(-1)
            if t.numel():
                f.write(t.view(torch.uint8).numpy())
    os.replace(tmp, path)
    return 8 + len(blob) + offset
