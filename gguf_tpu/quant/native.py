"""ctypes bridge to the native K-quant codec core (csrc/gguf_kquant.c).

The reference repo requires the user to hand-compile its .so files
(/root/reference/utils/quantize/q4_k.py:41-45 raises with gcc instructions);
here the library is built automatically on first use via csrc/Makefile.

All entry points take/return numpy arrays; byte buffers are flat uint8 in the
exact GGUF on-disk block layout.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "csrc")
_SO_PATH = os.path.join(_CSRC_DIR, "build", "libgguf_kquant.so")

_lib = None
_lib_lock = threading.Lock()

QK_K = 256
Q2K_BLOCK_BYTES = 84
Q3K_BLOCK_BYTES = 110
Q4K_BLOCK_BYTES = 144
Q5K_BLOCK_BYTES = 176
Q6K_BLOCK_BYTES = 210


def _build_library() -> None:
    proc = subprocess.run(["make", "-C", _CSRC_DIR], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"building the native codec (make -C {_CSRC_DIR}) failed:\n"
            f"{proc.stdout[-4000:]}{proc.stderr[-4000:]}")


def get_lib() -> ctypes.CDLL:
    """Load (building if necessary) the native codec library."""
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        if (not os.path.exists(_SO_PATH)
                or os.path.getmtime(_SO_PATH)
                < os.path.getmtime(os.path.join(_CSRC_DIR, "gguf_kquant.c"))):
            _build_library()   # make's deps also rebuild a stale .so
        lib = ctypes.CDLL(_SO_PATH)

        f32p = ctypes.POINTER(ctypes.c_float)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u16p = ctypes.POINTER(ctypes.c_uint16)

        for fmt in ("q2_k", "q3_k"):
            q = getattr(lib, f"gq_quantize_{fmt}")
            q.argtypes = [f32p, u8p, ctypes.c_int64]
            q.restype = None
            dq = getattr(lib, f"gq_dequantize_{fmt}")
            dq.argtypes = [u8p, f32p, ctypes.c_int64]
            dq.restype = None
        lib.gq_quantize_q4_k.argtypes = [f32p, u8p, ctypes.c_int64]
        lib.gq_quantize_q4_k.restype = None
        lib.gq_quantize_q5_k.argtypes = [f32p, u8p, ctypes.c_int64]
        lib.gq_quantize_q5_k.restype = None
        lib.gq_quantize_q6_k.argtypes = [f32p, u8p, ctypes.c_int64]
        lib.gq_quantize_q6_k.restype = None
        lib.gq_dequantize_q4_k.argtypes = [u8p, f32p, ctypes.c_int64]
        lib.gq_dequantize_q4_k.restype = None
        lib.gq_dequantize_q5_k.argtypes = [u8p, f32p, ctypes.c_int64]
        lib.gq_dequantize_q5_k.restype = None
        lib.gq_dequantize_q6_k.argtypes = [u8p, f32p, ctypes.c_int64]
        lib.gq_dequantize_q6_k.restype = None
        lib.gq_fp16_to_fp32.argtypes = [ctypes.c_uint16]
        lib.gq_fp16_to_fp32.restype = ctypes.c_float
        lib.gq_fp32_to_fp16.argtypes = [ctypes.c_float]
        lib.gq_fp32_to_fp16.restype = ctypes.c_uint16
        lib.gq_fp16_to_fp32_buf.argtypes = [u16p, f32p, ctypes.c_int64]
        lib.gq_fp16_to_fp32_buf.restype = None
        lib.gq_fp32_to_fp16_buf.argtypes = [f32p, u16p, ctypes.c_int64]
        lib.gq_fp32_to_fp16_buf.restype = None
        lib.gq_nearest_int.argtypes = [ctypes.c_float]
        lib.gq_nearest_int.restype = ctypes.c_int

        _lib = lib
        return _lib


def _as_f32_c(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x, dtype=np.float32)


# superblocks per worker below which one thread quantizes the whole array
_MIN_BLOCKS_PER_THREAD = 4096


def _quantize_kquant(x: np.ndarray, fmt: str, block_bytes: int) -> np.ndarray:
    """Flat K-quant bytes of x. Superblocks quantize independently, so a
    large array is split into block ranges across threads (ctypes releases
    the GIL while the C code runs); the bytes are identical either way."""
    from concurrent.futures import ThreadPoolExecutor

    x = _as_f32_c(x.reshape(-1))
    n = x.size
    if n % QK_K:
        raise ValueError(f"{fmt} needs size % 256 == 0, got {n}")
    nb = n // QK_K
    out = np.empty(nb * block_bytes, dtype=np.uint8)
    fn = getattr(get_lib(), f"gq_quantize_{fmt}")

    def run(lo: int, hi: int) -> None:
        fn(ctypes.cast(x.ctypes.data + lo * QK_K * 4,
                       ctypes.POINTER(ctypes.c_float)),
           ctypes.cast(out.ctypes.data + lo * block_bytes,
                       ctypes.POINTER(ctypes.c_uint8)),
           ctypes.c_int64((hi - lo) * QK_K))

    workers = max(1, min(os.cpu_count() or 1, nb // _MIN_BLOCKS_PER_THREAD))
    if workers == 1:
        run(0, nb)
    else:
        edges = [nb * i // workers for i in range(workers + 1)]
        with ThreadPoolExecutor(workers) as ex:
            list(ex.map(run, edges[:-1], edges[1:]))
    return out


def _dequantize_kquant(q: np.ndarray, n_elems: int, fmt: str) -> np.ndarray:
    q = np.ascontiguousarray(q.reshape(-1).view(np.uint8))
    out = np.empty(n_elems, dtype=np.float32)
    getattr(get_lib(), f"gq_dequantize_{fmt}")(
        q.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(n_elems),
    )
    return out


def quantize_q2_k(x: np.ndarray) -> np.ndarray:
    """Quantize a float array (size % 256 == 0) to flat Q2_K bytes (uint8)."""
    return _quantize_kquant(x, "q2_k", Q2K_BLOCK_BYTES)


def quantize_q3_k(x: np.ndarray) -> np.ndarray:
    """Quantize a float array (size % 256 == 0) to flat Q3_K bytes (uint8)."""
    return _quantize_kquant(x, "q3_k", Q3K_BLOCK_BYTES)


def dequantize_q2_k_native(q: np.ndarray, n_elems: int) -> np.ndarray:
    return _dequantize_kquant(q, n_elems, "q2_k")


def dequantize_q3_k_native(q: np.ndarray, n_elems: int) -> np.ndarray:
    return _dequantize_kquant(q, n_elems, "q3_k")


def quantize_q4_k(x: np.ndarray) -> np.ndarray:
    """Quantize a float array (size % 256 == 0) to flat Q4_K bytes (uint8)."""
    return _quantize_kquant(x, "q4_k", Q4K_BLOCK_BYTES)


def quantize_q5_k(x: np.ndarray) -> np.ndarray:
    """Quantize a float array (size % 256 == 0) to flat Q5_K bytes (uint8)."""
    return _quantize_kquant(x, "q5_k", Q5K_BLOCK_BYTES)


def quantize_q6_k(x: np.ndarray) -> np.ndarray:
    """Quantize a float array (size % 256 == 0) to flat Q6_K bytes (uint8)."""
    return _quantize_kquant(x, "q6_k", Q6K_BLOCK_BYTES)


def dequantize_q4_k_native(q: np.ndarray, n_elems: int) -> np.ndarray:
    q = np.ascontiguousarray(q.reshape(-1).view(np.uint8))
    out = np.empty(n_elems, dtype=np.float32)
    get_lib().gq_dequantize_q4_k(
        q.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(n_elems),
    )
    return out


def dequantize_q5_k_native(q: np.ndarray, n_elems: int) -> np.ndarray:
    q = np.ascontiguousarray(q.reshape(-1).view(np.uint8))
    out = np.empty(n_elems, dtype=np.float32)
    get_lib().gq_dequantize_q5_k(
        q.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(n_elems),
    )
    return out


def dequantize_q6_k_native(q: np.ndarray, n_elems: int) -> np.ndarray:
    q = np.ascontiguousarray(q.reshape(-1).view(np.uint8))
    out = np.empty(n_elems, dtype=np.float32)
    get_lib().gq_dequantize_q6_k(
        q.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(n_elems),
    )
    return out


def fp16_bits_to_fp32(h: np.ndarray) -> np.ndarray:
    """Exact fp16(bits)->fp32 via the native core (widening is lossless)."""
    h = np.ascontiguousarray(h, dtype=np.uint16)
    out = np.empty(h.shape, dtype=np.float32)
    get_lib().gq_fp16_to_fp32_buf(
        h.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(h.size),
    )
    return out


def fp32_to_fp16_bits(f: np.ndarray) -> np.ndarray:
    """fp32->fp16 bits, IEEE round-to-nearest-even (matches GGML exactly)."""
    f = _as_f32_c(f)
    out = np.empty(f.shape, dtype=np.uint16)
    get_lib().gq_fp32_to_fp16_buf(
        f.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        ctypes.c_int64(f.size),
    )
    return out


# ----------------------------------------------------- SoA transform core ---

_SOA_SO_PATH = os.path.join(_CSRC_DIR, "build", "libgguf_soa.so")
_soa_lib = None


def get_soa_lib() -> ctypes.CDLL:
    """Load (building if necessary) the native SoA-transform library — the
    fast model-load path (layouts.py's numpy transforms are the tested
    reference; these produce byte-identical arrays ~50x faster)."""
    global _soa_lib
    if _soa_lib is not None:
        return _soa_lib
    with _lib_lock:
        if _soa_lib is not None:
            return _soa_lib
        if (not os.path.exists(_SOA_SO_PATH)
                or os.path.getmtime(_SOA_SO_PATH)
                < os.path.getmtime(os.path.join(_CSRC_DIR, "gguf_soa.c"))):
            _build_library()
        lib = ctypes.CDLL(_SOA_SO_PATH)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i8p = ctypes.POINTER(ctypes.c_int8)
        u16p = ctypes.POINTER(ctypes.c_uint16)
        i64 = ctypes.c_int64
        lib.q8_0_to_soa_c.argtypes = [u8p, i64, i64, u16p, i8p]
        lib.q8_0_to_soa_c.restype = None
        lib.q2_k_to_soa_c.argtypes = [u8p, i64, i64, u16p, u16p, u8p, u8p, u8p]
        lib.q2_k_to_soa_c.restype = None
        lib.q3_k_to_soa_c.argtypes = [u8p, i64, i64, u16p, i8p, u8p, u8p]
        lib.q3_k_to_soa_c.restype = None
        lib.q4_k_to_soa_c.argtypes = [u8p, i64, i64, u16p, u16p, u8p, u8p, u8p]
        lib.q4_k_to_soa_c.restype = None
        lib.q5_k_to_soa_c.argtypes = [u8p, i64, i64, u16p, u16p, u8p, u8p,
                                      u8p, u8p]
        lib.q5_k_to_soa_c.restype = None
        lib.q6_k_to_soa_c.argtypes = [u8p, i64, i64, u16p, i8p, u8p, u8p]
        lib.q6_k_to_soa_c.restype = None
        _soa_lib = lib
    return _soa_lib


def _u8(a):
    return np.ascontiguousarray(a).ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def soa_arrays(fmt: str, qbytes, m: int, k: int) -> dict:
    """GGUF block bytes -> dict of K-major SoA numpy arrays (same contents
    as layouts.py's numpy transforms, computed natively)."""
    lib = get_soa_lib()
    src = np.ascontiguousarray(np.asarray(qbytes).reshape(-1).view(np.uint8))
    srcp = src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    sb = k // QK_K
    u16 = lambda rows: np.empty((rows, m), np.uint16)
    u8a = lambda rows: np.empty((rows, m), np.uint8)
    i8a = lambda rows: np.empty((rows, m), np.int8)
    cp = lambda a, ct: a.ctypes.data_as(ctypes.POINTER(ct))

    if fmt == "q8_0":
        nbk = k // 32
        d, qs = u16(nbk), i8a(k)
        lib.q8_0_to_soa_c(srcp, m, nbk, cp(d, ctypes.c_uint16),
                          cp(qs, ctypes.c_int8))
        return {"d_bits": d, "qs": qs}
    if fmt == "q2_k":
        d, dm, sc, mn, qs = u16(sb), u16(sb), u8a(sb * 16), u8a(sb * 16), \
            u8a(k // 4)
        lib.q2_k_to_soa_c(srcp, m, sb, cp(d, ctypes.c_uint16),
                          cp(dm, ctypes.c_uint16), cp(sc, ctypes.c_uint8),
                          cp(mn, ctypes.c_uint8), cp(qs, ctypes.c_uint8))
        return {"d_bits": d, "dmin_bits": dm, "sc": sc, "mn": mn, "qs": qs}
    if fmt == "q3_k":
        d, sc, qs, qh = u16(sb), i8a(sb * 16), u8a(k // 4), u8a(k // 8)
        lib.q3_k_to_soa_c(srcp, m, sb, cp(d, ctypes.c_uint16),
                          cp(sc, ctypes.c_int8), cp(qs, ctypes.c_uint8),
                          cp(qh, ctypes.c_uint8))
        return {"d_bits": d, "sc": sc, "qs": qs, "qh": qh}
    if fmt == "q4_k":
        d, dm, sc, mn, qs = u16(sb), u16(sb), u8a(sb * 8), u8a(sb * 8), \
            u8a(k // 2)
        lib.q4_k_to_soa_c(srcp, m, sb, cp(d, ctypes.c_uint16),
                          cp(dm, ctypes.c_uint16), cp(sc, ctypes.c_uint8),
                          cp(mn, ctypes.c_uint8), cp(qs, ctypes.c_uint8))
        return {"d_bits": d, "dmin_bits": dm, "sc": sc, "mn": mn, "qs": qs}
    if fmt == "q5_k":
        d, dm, sc, mn = u16(sb), u16(sb), u8a(sb * 8), u8a(sb * 8)
        qs, qh = u8a(k // 2), u8a(k // 8)
        lib.q5_k_to_soa_c(srcp, m, sb, cp(d, ctypes.c_uint16),
                          cp(dm, ctypes.c_uint16), cp(sc, ctypes.c_uint8),
                          cp(mn, ctypes.c_uint8), cp(qs, ctypes.c_uint8),
                          cp(qh, ctypes.c_uint8))
        return {"d_bits": d, "dmin_bits": dm, "sc": sc, "mn": mn,
                "qs": qs, "qh": qh}
    if fmt == "q6_k":
        d, sc, ql, qh = u16(sb), i8a(sb * 16), u8a(k // 2), u8a(k // 4)
        lib.q6_k_to_soa_c(srcp, m, sb, cp(d, ctypes.c_uint16),
                          cp(sc, ctypes.c_int8), cp(ql, ctypes.c_uint8),
                          cp(qh, ctypes.c_uint8))
        return {"d_bits": d, "sc": sc, "ql": ql, "qh": qh}
    raise ValueError(f"unknown format {fmt!r}")
