"""Read ONNX graph initializers without the `onnx` package.

The port's own copy of `qwen3_tts_tpu/utils/onnx_weights.py`. The reference
bundles its CAM++ x-vector as `campplus.onnx` and runs it via onnxruntime
(speech_vq.py:118-159). To run that network in PyTorch only the weight
tensors are needed; this module walks the protobuf wire format of a
ModelProto directly (varint/length-delimited framing — ~60 lines) and
returns {initializer_name: np.ndarray}.  No protobuf codegen, no onnx dep.

Wire layout used (onnx.proto3):
  ModelProto.graph        = field 7  (GraphProto)
  GraphProto.initializer  = field 5  (repeated TensorProto)
  TensorProto.dims        = field 1  (repeated int64)
  TensorProto.data_type   = field 2  (enum; 1=float32, 6=int32, 7=int64,
                                      10=float16, 11=double)
  TensorProto.float_data  = field 4  (packed floats, alt encoding)
  TensorProto.int64_data  = field 7  (packed varints, alt encoding)
  TensorProto.name        = field 8  (string)
  TensorProto.raw_data    = field 9  (bytes, little-endian)
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np

_DTYPES = {1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
           6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16,
           11: np.float64, 12: np.uint32, 13: np.uint64}


def _varint(buf: bytes, pos: int) -> Tuple[int, int]:
    out = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7
        if shift > 70:
            raise ValueError("malformed varint")


def _fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """Yield (field_number, wire_type, value) over a protobuf message body.
    Length-delimited values are returned as bytes; varints as int; fixed
    32/64 as raw bytes."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _varint(buf, pos)
        elif wire == 1:
            val, pos = buf[pos:pos + 8], pos + 8
        elif wire == 2:
            ln, pos = _varint(buf, pos)
            val, pos = buf[pos:pos + ln], pos + ln
        elif wire == 5:
            val, pos = buf[pos:pos + 4], pos + 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _parse_tensor(buf: bytes) -> Tuple[str, np.ndarray]:
    dims = []
    dtype = None
    name = ""
    raw = None
    float_data = []
    int64_data = []
    for field, wire, val in _fields(buf):
        if field == 1:
            if wire == 0:
                dims.append(val)
            else:  # packed
                pos = 0
                while pos < len(val):
                    v, pos = _varint(val, pos)
                    dims.append(v)
        elif field == 2 and wire == 0:
            dtype = val
        elif field == 4:
            if wire == 2:
                float_data.extend(np.frombuffer(val, "<f4").tolist())
            else:
                float_data.append(np.frombuffer(bytes(val), "<f4")[0])
        elif field == 7:
            # int64_data: protobuf encodes negatives as 10-byte
            # two's-complement varints — fold back into signed int64
            def _signed(v):
                return v - (1 << 64) if v >= (1 << 63) else v

            if wire == 2:
                pos = 0
                while pos < len(val):
                    v, pos = _varint(val, pos)
                    int64_data.append(_signed(v))
            else:
                int64_data.append(_signed(val))
        elif field == 8 and wire == 2:
            name = val.decode("utf-8")
        elif field == 9 and wire == 2:
            raw = val
    np_dtype = _DTYPES.get(dtype)
    if np_dtype is None:
        raise ValueError(f"initializer {name!r}: unsupported data_type {dtype}")
    if raw is not None:
        arr = np.frombuffer(raw, np.dtype(np_dtype).newbyteorder("<"))
    elif float_data:
        arr = np.asarray(float_data, np.float32)
    elif int64_data:
        arr = np.asarray(int64_data, np.int64)
    else:
        arr = np.zeros(0, np_dtype)
    return name, arr.reshape(dims if dims else arr.shape).astype(np_dtype)


def read_onnx_initializers(path_or_bytes) -> Dict[str, np.ndarray]:
    """Parse an .onnx file and return its graph initializers by name."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    graph = None
    for field, wire, val in _fields(data):
        if field == 7 and wire == 2:  # ModelProto.graph
            graph = val
            break
    if graph is None:
        raise ValueError("not an ONNX ModelProto (no graph field)")
    out: Dict[str, np.ndarray] = {}
    for field, wire, val in _fields(graph):
        if field == 5 and wire == 2:  # GraphProto.initializer
            name, arr = _parse_tensor(val)
            out[name] = arr
    return out


_DTYPE_IDS = {np.dtype(v): k for k, v in _DTYPES.items()}


def _pb_varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b7 = v & 0x7F
        v >>= 7
        if not v:
            out.append(b7)
            return bytes(out)
        out.append(b7 | 0x80)


def _pb_field(num: int, wire: int, payload) -> bytes:
    key = _pb_varint((num << 3) | wire)
    if wire == 2:
        return key + _pb_varint(len(payload)) + payload
    return key + _pb_varint(payload)


def write_onnx_initializers(path: str, tensors: Dict[str, np.ndarray]) -> None:
    """Write a ModelProto whose graph holds only `tensors` as initializers
    (dims, data_type, name, little-endian raw_data): the part of an .onnx
    file `read_onnx_initializers` reads. For weights fabricated in tests
    and smoke runs; it is not a runnable graph."""
    graph = bytearray()
    for name, arr in tensors.items():
        arr = np.asarray(arr)
        body = b"".join(_pb_field(1, 0, int(d)) for d in arr.shape)
        body += _pb_field(2, 0, _DTYPE_IDS[arr.dtype])
        body += _pb_field(8, 2, name.encode("utf-8"))
        body += _pb_field(9, 2, np.ascontiguousarray(arr, arr.dtype.newbyteorder("<")).tobytes())
        graph += _pb_field(5, 2, body)
    with open(path, "wb") as f:
        f.write(_pb_field(1, 0, 8) + _pb_field(7, 2, bytes(graph)))   # ir_version, graph
