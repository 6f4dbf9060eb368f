"""Pure-Python ONNX weight I/O (struct and numpy; no `onnx` package).

A copy of cosyvoice_tpu/utils/onnx_io.py.  A released CosyVoice2 model
directory ships two frozen ONNX models, `campplus.onnx` (speaker vector) and
`speech_tokenizer_v2.onnx` (25 Hz speech tokens).  The port runs both as
PyTorch modules (models/campplus.py, models/s3tokenizer.py), so all it needs
from the files is their weights: `{initializer name: ndarray}`, the names
being the torch state_dict names that torch's ONNX exporter keeps.

ONNX is protobuf; this module reads and writes exactly the fields needed:

  ModelProto:  field 7 = graph (GraphProto)
  GraphProto:  field 5 = initializer (repeated TensorProto),
               field 1 = node (NodeProto; Constant nodes can carry tensors)
  NodeProto:   field 4 = op_type, field 5 = attribute, field 6 = output name
  AttributeProto: field 1 = name, field 4 = t (TensorProto)
  TensorProto: 1 dims, 2 data_type, 4 float_data, 5 int32_data, 6 string_data,
               7 int64_data, 8 name, 9 raw_data, 10 double_data, 11 uint64_data,
               13 external_data, 14 data_location

The writer emits a minimal valid ModelProto that holds only named
initializers, enough to build a model directory in the released format.
"""
from __future__ import annotations

import struct
from typing import Iterator

import numpy as np

# TensorProto.DataType -> numpy dtype
_DTYPES = {
    1: np.dtype(np.float32), 2: np.dtype(np.uint8), 3: np.dtype(np.int8),
    4: np.dtype(np.uint16), 5: np.dtype(np.int16), 6: np.dtype(np.int32),
    7: np.dtype(np.int64), 9: np.dtype(np.bool_), 10: np.dtype(np.float16),
    11: np.dtype(np.float64), 12: np.dtype(np.uint32), 13: np.dtype(np.uint64),
}
_DTYPE_CODES = {v: k for k, v in _DTYPES.items()}


# ---------------------------------------------------------------- decoding

def _read_varint(buf: memoryview, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint too long (corrupt protobuf)")


def _iter_fields(buf: memoryview) -> Iterator[tuple[int, int, memoryview | int]]:
    """Yield (field_number, wire_type, value) over one message's bytes.

    Length-delimited values come back as memoryviews; varints as ints;
    fixed32/64 as raw memoryviews of 4/8 bytes.
    """
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:          # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 1:        # 64-bit
            val = buf[pos:pos + 8]
            pos += 8
        elif wire == 2:        # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:        # 32-bit
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire} (field {field})")
        yield field, wire, val


def _packed_varints(val, wire) -> list[int]:
    if wire == 0:
        return [val]
    out = []
    pos = 0
    while pos < len(val):
        v, pos = _read_varint(val, pos)
        out.append(v)
    return out


def _signed64(vals: list[int]) -> np.ndarray:
    # protobuf int64 fields are plain two's-complement varints (not zigzag);
    # reinterpret the unsigned decode as signed 64-bit
    return np.asarray(vals, np.uint64).astype(np.int64)


def _parse_tensor(buf: memoryview) -> tuple[str, np.ndarray]:
    dims: list[int] = []
    data_type = 1
    name = ""
    raw: bytes | None = None
    f32: list = []
    i32: list[int] = []
    i64: list[int] = []
    f64: list = []
    u64: list[int] = []
    for field, wire, val in _iter_fields(buf):
        if field == 1:
            dims.extend(_packed_varints(val, wire))
        elif field == 2:
            data_type = val
        elif field == 4:   # float_data (packed 32-bit)
            f32.extend(struct.unpack(f"<{len(val) // 4}f", bytes(val))
                       if wire == 2 else struct.unpack("<f", bytes(val)))
        elif field == 5:   # int32_data (varints; also carries u8/i8/bool/f16)
            i32.extend(_packed_varints(val, wire))
        elif field == 7:   # int64_data
            i64.extend(_packed_varints(val, wire))
        elif field == 8:
            name = bytes(val).decode("utf-8")
        elif field == 9:
            raw = bytes(val)
        elif field == 10:  # double_data
            f64.extend(struct.unpack(f"<{len(val) // 8}d", bytes(val))
                       if wire == 2 else struct.unpack("<d", bytes(val)))
        elif field == 11:  # uint64_data
            u64.extend(_packed_varints(val, wire))
        elif field == 14 and val != 0:
            raise NotImplementedError(
                f"tensor '{name}': external data files are not supported")
    if data_type not in _DTYPES:
        raise NotImplementedError(f"tensor '{name}': data_type {data_type}")
    dt = _DTYPES[data_type]
    if raw is not None:
        arr = np.frombuffer(raw, dt)
    elif f32:
        arr = np.asarray(f32, np.float32)
    elif f64:
        arr = np.asarray(f64, np.float64)
    elif i64:
        arr = _signed64(i64)
    elif u64:
        arr = np.asarray(u64, np.uint64)
    elif i32 or data_type in (2, 3, 4, 5, 6, 9, 10):
        # int32_data carries u8/i8/u16/i16/i32/bool/f16 as varints; negative
        # values arrive sign-extended to 64 bits — wrap-cast recovers them
        a = np.asarray(i32, np.uint64).astype(np.int64)
        if data_type == 10:  # float16 stored as uint16 bit pattern
            arr = a.astype(np.uint16).view(np.float16)
        else:
            with np.errstate(over="ignore"):
                arr = a.astype(dt)
    else:
        arr = np.zeros(0, dt)
    return name, arr.astype(dt, copy=False).reshape(dims)


def read_onnx_tensors(path: str) -> dict[str, np.ndarray]:
    """All named weight tensors in an .onnx file: graph initializers plus
    tensors carried by Constant nodes (named after the node's output)."""
    with open(path, "rb") as f:
        model = memoryview(f.read())
    graph = None
    for field, _, val in _iter_fields(model):
        if field == 7:
            graph = val
            break
    if graph is None:
        raise ValueError(f"{path}: no GraphProto found (not an ONNX model?)")
    out: dict[str, np.ndarray] = {}
    for field, _, val in _iter_fields(graph):
        if field == 5:                       # initializer
            name, arr = _parse_tensor(val)
            out[name] = arr
        elif field == 1:                     # node — look for Constant
            op_type, outputs, tensors = "", [], []
            for nf, _, nv in _iter_fields(val):
                if nf == 4:
                    op_type = bytes(nv).decode("utf-8")
                elif nf == 6:
                    outputs.append(bytes(nv).decode("utf-8"))
                elif nf == 5:                # attribute
                    for af, _, av in _iter_fields(nv):
                        if af == 4:          # t: TensorProto
                            tensors.append(av)
            if op_type == "Constant" and outputs and tensors:
                _, arr = _parse_tensor(tensors[0])
                out.setdefault(outputs[0], arr)
    return out


# ---------------------------------------------------------------- encoding

def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(num: int, wire: int, payload: bytes) -> bytes:
    if wire == 2:
        return _varint(num << 3 | 2) + _varint(len(payload)) + payload
    return _varint(num << 3 | wire) + payload


def _encode_tensor(name: str, arr: np.ndarray) -> bytes:
    shape = np.asarray(arr).shape
    arr = np.ascontiguousarray(arr).reshape(shape)
    if arr.dtype not in _DTYPE_CODES:
        raise TypeError(f"tensor '{name}': unsupported dtype {arr.dtype}")
    out = b""
    for d in arr.shape:
        out += _field(1, 0, _varint(d))
    out += _field(2, 0, _varint(_DTYPE_CODES[arr.dtype]))
    out += _field(8, 2, name.encode("utf-8"))
    out += _field(9, 2, arr.tobytes())
    return out


def write_onnx_tensors(path: str, tensors: dict[str, np.ndarray],
                       graph_name: str = "weights") -> None:
    """Minimal valid ModelProto holding only named initializers (joined
    once, so a file of a gigabyte is not copied once a tensor)."""
    graph = b"".join([_field(2, 2, graph_name.encode("utf-8"))]
                     + [_field(5, 2, _encode_tensor(name, np.asarray(arr)))
                        for name, arr in tensors.items()])
    opset = _field(2, 0, _varint(17))  # OperatorSetIdProto.version
    model = (_field(1, 0, _varint(8))                       # ir_version
             + _field(2, 2, b"cosyvoice_tpu_torch")         # producer_name
             + _field(7, 2, graph)
             + _field(8, 2, opset))
    with open(path, "wb") as f:
        f.write(model)
