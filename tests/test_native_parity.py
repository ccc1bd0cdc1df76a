"""Bit-exactness of our native K-quant cores vs the reference compiled as an
independent oracle.

The upstream C sources (/root/reference/utils/quantize/q4_k_ref.c,
q6_k_ref.c — themselves copied from GGML) are compiled read-only into /tmp at
test time and driven via ctypes. Our from-scratch implementation in
csrc/gguf_kquant.c must produce byte-identical blocks, proving quantization
stays bit-compatible with llama.cpp. No oracle code ships in this repo.
"""

import ctypes
import os
import subprocess

import numpy as np
import pytest

from gguf_tpu.quant import quantize_q4_k, quantize_q6_k

REF_DIR = "/root/reference/utils/quantize"
ORACLE_DIR = "/tmp/gguf_ref_oracle"


def _build_oracle(src_name: str, fn_name: str):
    src = os.path.join(REF_DIR, src_name)
    if not os.path.exists(src):
        pytest.skip("reference sources unavailable")
    os.makedirs(ORACLE_DIR, exist_ok=True)
    so = os.path.join(ORACLE_DIR, src_name.replace(".c", ".so"))
    if not os.path.exists(so):
        subprocess.run(
            ["gcc", "-O2", "-fPIC", "-shared", "-o", so, src, "-lm"],
            check=True, capture_output=True,
        )
    lib = ctypes.CDLL(so)
    fn = getattr(lib, fn_name)
    fn.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.c_void_p, ctypes.c_int64]
    fn.restype = None
    return fn


def _run_oracle(fn, x: np.ndarray, block_bytes: int) -> np.ndarray:
    x = np.ascontiguousarray(x, dtype=np.float32)
    out = np.zeros(x.size // 256 * block_bytes, dtype=np.uint8)
    fn(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(x.size),
    )
    return out


@pytest.mark.parametrize("dist", ["normal", "uniform", "outliers", "tiny", "positive"])
def test_q4_k_bit_exact_vs_reference(rng, dist):
    fn = _build_oracle("q4_k_ref.c", "quantize_row_q4_K_ref")
    x = _make_data(rng, dist, 256 * 64)
    ours = quantize_q4_k(x)
    theirs = _run_oracle(fn, x, 144)
    np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("dist", ["normal", "uniform", "outliers", "tiny", "positive"])
def test_q6_k_bit_exact_vs_reference(rng, dist):
    fn = _build_oracle("q6_k_ref.c", "quantize_row_q6_K_ref")
    x = _make_data(rng, dist, 256 * 64)
    ours = quantize_q6_k(x)
    theirs = _run_oracle(fn, x, 210)
    np.testing.assert_array_equal(ours, theirs)


def test_q4_k_zero_and_constant_blocks():
    fn = _build_oracle("q4_k_ref.c", "quantize_row_q4_K_ref")
    x = np.zeros(512, dtype=np.float32)
    x[256:] = 3.25  # constant block (max == min path)
    np.testing.assert_array_equal(quantize_q4_k(x), _run_oracle(fn, x, 144))


def test_q6_k_zero_blocks():
    fn = _build_oracle("q6_k_ref.c", "quantize_row_q6_K_ref")
    x = np.zeros(512, dtype=np.float32)
    x[300] = 1e-20  # below GROUP_MAX_EPS: all-zero superblock path
    np.testing.assert_array_equal(quantize_q6_k(x), _run_oracle(fn, x, 210))


def _make_data(rng, dist: str, n: int) -> np.ndarray:
    if dist == "normal":
        return rng.standard_normal(n).astype(np.float32)
    if dist == "uniform":
        return rng.uniform(-4, 4, n).astype(np.float32)
    if dist == "outliers":
        x = rng.standard_normal(n).astype(np.float32)
        x[rng.integers(0, n, n // 100)] *= 50.0
        return x
    if dist == "tiny":
        return (rng.standard_normal(n) * 1e-5).astype(np.float32)
    if dist == "positive":
        return np.abs(rng.standard_normal(n)).astype(np.float32)
    raise ValueError(dist)


@pytest.mark.parametrize("fmt", ["q4_k", "q5_k", "q6_k"])
def test_native_dequant_equals_numpy(fmt):
    """The C dequantizers must produce floats exactly equal to the numpy
    reference path (same op order)."""
    import gguf_tpu.quant as q

    rng = np.random.default_rng(hash(fmt) % 2**31)
    x = rng.standard_normal((8, 1024)).astype(np.float32)
    qb = getattr(q, f"quantize_{fmt}")(x)
    deq = getattr(q, f"dequantize_{fmt}")
    a = deq(qb, x.shape, native=True)
    b = deq(qb, x.shape, native=False)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fmt,block_bytes", [("q4_k", 144), ("q6_k", 210)])
def test_soft_fp16_build_matches(tmp_path, rng, fmt, block_bytes):
    """Compilers without _Float16 (gcc < 12) build the software fp16 pair
    (-DGQ_SOFT_FP16 forces it here): bit-identical conversions on every
    fp16 pattern and on rounding ties, and identical quantized bytes."""
    from gguf_tpu.quant import native

    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "csrc", "gguf_kquant.c")
    so = str(tmp_path / "soft.so")
    subprocess.run(["gcc", "-O2", "-fPIC", "-shared", "-DGQ_SOFT_FP16",
                    "-o", so, src, "-lm"], check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    f32p = ctypes.POINTER(ctypes.c_float)
    u16p = ctypes.POINTER(ctypes.c_uint16)
    lib.gq_fp16_to_fp32_buf.argtypes = [u16p, f32p, ctypes.c_int64]
    lib.gq_fp32_to_fp16_buf.argtypes = [f32p, u16p, ctypes.c_int64]
    q = getattr(lib, f"gq_quantize_{fmt}")
    q.argtypes = [f32p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]

    bits = np.arange(2**16, dtype=np.uint16)
    bits = bits[np.isfinite(bits.view(np.float16))]
    f32 = np.empty(bits.size, np.float32)
    lib.gq_fp16_to_fp32_buf(bits.ctypes.data_as(u16p), f32.ctypes.data_as(f32p),
                            bits.size)
    np.testing.assert_array_equal(f32, bits.view(np.float16).astype(np.float32))
    # fp16 values, midpoints between neighbours (ties) and random floats
    x = np.concatenate([f32, (f32[:-1] + f32[1:]) / 2,
                        rng.standard_normal(4096).astype(np.float32) * 1e3])
    x = np.ascontiguousarray(x[np.isfinite(x)], np.float32)
    back = np.empty(x.size, np.uint16)
    lib.gq_fp32_to_fp16_buf(x.ctypes.data_as(f32p), back.ctypes.data_as(u16p),
                            x.size)
    np.testing.assert_array_equal(back, x.astype(np.float16).view(np.uint16))

    w = _make_data(rng, "normal", 256 * 64)
    out = np.zeros(w.size // 256 * block_bytes, np.uint8)
    q(w.ctypes.data_as(f32p), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
      w.size)
    np.testing.assert_array_equal(out, getattr(native, f"quantize_{fmt}")(w))
