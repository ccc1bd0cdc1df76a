"""GGUF v2/v3 reader: header, typed metadata, tensor table, mmap'd data.

Tensor bytes are exposed as zero-copy numpy views over an mmap, so loading a
multi-GB model file touches pages lazily; `load_quant` converts a quantized
2-D weight straight into the SoA device layout (quant/layouts.py), optionally
slicing a block-aligned row/column shard first — this is what makes
tensor-parallel loads read only each host's shard from disk.
"""

from __future__ import annotations

import mmap
import struct
from dataclasses import dataclass

import numpy as np

from .constants import (
    GGML_BLOCK_INFO, GGML_TO_FMT, GGUF_DEFAULT_ALIGNMENT, GGUF_MAGIC,
    GGMLType, GGUFValueType, tensor_nbytes,
)

_SCALAR_FMT = {
    GGUFValueType.UINT8: "<B", GGUFValueType.INT8: "<b",
    GGUFValueType.UINT16: "<H", GGUFValueType.INT16: "<h",
    GGUFValueType.UINT32: "<I", GGUFValueType.INT32: "<i",
    GGUFValueType.FLOAT32: "<f", GGUFValueType.BOOL: "<?",
    GGUFValueType.UINT64: "<Q", GGUFValueType.INT64: "<q",
    GGUFValueType.FLOAT64: "<d",
}


@dataclass
class TensorInfo:
    name: str
    shape: tuple          # numpy (row-major) order; GGUF stores reversed
    ggml_type: GGMLType
    offset: int           # relative to the data section start
    nbytes: int


class GGUFReader:
    def __init__(self, path: str):
        self.path = path
        self._file = open(path, "rb")
        self._mm = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        self._pos = 0
        self.metadata: dict = {}
        self.metadata_types: dict = {}  # key -> GGUFValueType (round-trips)
        self.tensors: dict[str, TensorInfo] = {}
        self._parse()

    # --------------------------------------------------------- low level ---
    def _read(self, n: int) -> bytes:
        b = self._mm[self._pos:self._pos + n]
        if len(b) != n:
            raise EOFError(f"truncated GGUF file at offset {self._pos}")
        self._pos += n
        return b

    def _scalar(self, vt: GGUFValueType):
        fmt = _SCALAR_FMT[vt]
        return struct.unpack(fmt, self._read(struct.calcsize(fmt)))[0]

    def _string(self) -> str:
        n = struct.unpack("<Q", self._read(8))[0]
        return self._read(n).decode("utf-8")

    def _value(self, vt: GGUFValueType):
        if vt == GGUFValueType.STRING:
            return self._string()
        if vt == GGUFValueType.ARRAY:
            item_vt = GGUFValueType(struct.unpack("<I", self._read(4))[0])
            n = struct.unpack("<Q", self._read(8))[0]
            if item_vt == GGUFValueType.STRING:
                return [self._string() for _ in range(n)]
            if item_vt == GGUFValueType.ARRAY:
                return [self._value(GGUFValueType.ARRAY) for _ in range(n)]
            fmt = _SCALAR_FMT[item_vt]
            size = struct.calcsize(fmt)
            raw = self._read(n * size)
            dtype = np.dtype(fmt[1]).newbyteorder("<")
            return np.frombuffer(raw, dtype=dtype, count=n)
        return self._scalar(vt)

    # ------------------------------------------------------------- parse ---
    def _parse(self):
        if self._read(4) != GGUF_MAGIC:
            raise ValueError(f"{self.path}: not a GGUF file")
        self.version = struct.unpack("<I", self._read(4))[0]
        if self.version not in (2, 3):
            raise ValueError(f"unsupported GGUF version {self.version}")
        n_tensors = struct.unpack("<Q", self._read(8))[0]
        n_kv = struct.unpack("<Q", self._read(8))[0]

        for _ in range(n_kv):
            key = self._string()
            vt = GGUFValueType(struct.unpack("<I", self._read(4))[0])
            self.metadata[key] = self._value(vt)
            self.metadata_types[key] = vt

        infos = []
        for _ in range(n_tensors):
            name = self._string()
            n_dims = struct.unpack("<I", self._read(4))[0]
            dims = struct.unpack(f"<{n_dims}Q", self._read(8 * n_dims))
            raw_type = struct.unpack("<I", self._read(4))[0]
            try:
                ggml_type = GGMLType(raw_type)
            except ValueError:      # e.g. IQ-series: table still parses;
                ggml_type = raw_type  # loading the tensor errors
            offset = struct.unpack("<Q", self._read(8))[0]
            # GGUF dims: ne[0] fastest-varying -> numpy shape is reversed
            shape = tuple(reversed(dims))
            n_elems = int(np.prod(dims)) if dims else 1
            nbytes = (tensor_nbytes(ggml_type, n_elems)
                      if isinstance(ggml_type, GGMLType) else None)
            infos.append(TensorInfo(name, shape, ggml_type, offset, nbytes))

        align = int(self.metadata.get("general.alignment", GGUF_DEFAULT_ALIGNMENT))
        if align <= 0:   # malformed metadata must not divide by zero
            raise ValueError(
                f"{self.path}: invalid general.alignment {align}")
        self.data_start = (self._pos + align - 1) // align * align
        for ti in infos:
            self.tensors[ti.name] = ti

    # -------------------------------------------------------------- API ---
    def tensor_bytes(self, name: str) -> np.ndarray:
        """Raw GGUF block bytes of a tensor as a zero-copy uint8 view."""
        ti = self.tensors[name]
        if ti.nbytes is None:
            tname = (ti.ggml_type.name if isinstance(ti.ggml_type, GGMLType)
                     else f"type {ti.ggml_type}")
            raise ValueError(
                f"{name}: unsupported quantization {tname} (metadata and "
                f"other tensors in this file remain readable)")
        start = self.data_start + ti.offset
        if start + ti.nbytes > len(self._mm):
            raise ValueError(
                f"{name}: tensor data [{start}, {start + ti.nbytes}) runs "
                f"past the end of {self.path} ({len(self._mm)} bytes) — "
                "truncated or corrupt file")
        return np.frombuffer(self._mm, dtype=np.uint8, count=ti.nbytes, offset=start)

    def load_array(self, name: str) -> np.ndarray:
        """Load an F32/F16/BF16/I* tensor as a numpy array."""
        ti = self.tensors[name]
        raw = self.tensor_bytes(name)
        if ti.ggml_type == GGMLType.F32:
            return raw.view(np.float32).reshape(ti.shape)
        if ti.ggml_type == GGMLType.F16:
            return raw.view(np.float16).reshape(ti.shape)
        if ti.ggml_type == GGMLType.BF16:
            u = raw.view(np.uint16).astype(np.uint32) << 16
            return u.view(np.float32).reshape(ti.shape)
        if ti.ggml_type == GGMLType.I32:
            return raw.view(np.int32).reshape(ti.shape)
        raise ValueError(f"{name}: use load_quant/dequantize for {ti.ggml_type.name}")

    def load_quant(self, name: str, rows: slice | None = None):
        """Load a quantized 2-D weight into the SoA device layout (QuantTensor).

        `rows` optionally selects a row shard (output features) — rows are
        whole superblocks so any row range is valid; this is the
        tensor-parallel load path.

        3-D tensors (MoE expert stacks, GGUF shape (E, M, K)) flatten to
        (E*M, K): experts are row-major-contiguous in the file, so expert e
        is exactly rows [e*M, (e+1)*M) of the flattened view (the MoE load
        path in models/loader.py).
        """
        from ..quant.layouts import to_soa

        ti = self.tensors[name]
        fmt = GGML_TO_FMT.get(ti.ggml_type)
        if fmt is None:
            tname = (ti.ggml_type.name if isinstance(ti.ggml_type, GGMLType)
                     else f"type {ti.ggml_type}")  # tolerant parser keeps
            raise ValueError(f"{name}: {tname} has no MMQ kernel")  # raw ints
        *lead, k = ti.shape
        m = int(np.prod(lead)) if lead else 1
        raw = self.tensor_bytes(name)
        if rows is not None:
            block, nbytes = GGML_BLOCK_INFO[ti.ggml_type]
            row_bytes = k // block * nbytes
            start, stop, step = rows.indices(m)
            assert step == 1
            raw = raw[start * row_bytes:stop * row_bytes]
            m = stop - start
        return to_soa(fmt, raw, m, k)

    def dequantize(self, name: str) -> np.ndarray:
        """Any tensor -> float32 numpy array (host-side, via the codecs)."""
        from ..quant import (dequantize_q8_0, dequantize_q2_k,
                             dequantize_q3_k, dequantize_q4_k,
                             dequantize_q5_k, dequantize_q6_k,
                             dequantize_q4_0, dequantize_q4_1,
                             dequantize_q5_0, dequantize_q5_1,
                             dequantize_iq4_nl, dequantize_iq4_xs)

        ti = self.tensors[name]
        if ti.ggml_type in (GGMLType.F32, GGMLType.F16, GGMLType.BF16):
            return self.load_array(name).astype(np.float32)
        deq = {GGMLType.Q8_0: dequantize_q8_0, GGMLType.Q2_K: dequantize_q2_k,
               GGMLType.Q3_K: dequantize_q3_k, GGMLType.Q4_K: dequantize_q4_k,
               GGMLType.Q5_K: dequantize_q5_k,
               GGMLType.Q6_K: dequantize_q6_k,
               GGMLType.Q4_0: dequantize_q4_0, GGMLType.Q4_1: dequantize_q4_1,
               GGMLType.Q5_0: dequantize_q5_0, GGMLType.Q5_1: dequantize_q5_1,
               GGMLType.IQ4_NL: dequantize_iq4_nl,
               GGMLType.IQ4_XS: dequantize_iq4_xs,
               }[ti.ggml_type]
        return np.asarray(deq(self.tensor_bytes(name), ti.shape), dtype=np.float32)

    def close(self):
        try:
            self._mm.close()
        except BufferError:
            # zero-copy tensor views still reference the map; the OS unmaps
            # when the last view is garbage collected
            pass
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
