"""Codec round-trip and structural tests for all four GGUF formats.

Replaces the reference's manual __main__ demos (q8_0.py:103-113 etc.) with
asserted pytest cases, plus decoder-level unit tests the reference lacks.
"""

import numpy as np
import pytest

from gguf_tpu.quant import (
    quantize_q8_0, dequantize_q8_0,
    quantize_q8_1, dequantize_q8_1, parse_q8_1,
    quantize_q4_k, dequantize_q4_k, parse_q4_k,
    quantize_q5_k, dequantize_q5_k, parse_q5_k,
    quantize_q6_k, dequantize_q6_k, parse_q6_k,
)
from gguf_tpu.quant.q4_k import pack_scale_min, unpack_scale_min
from gguf_tpu.quant import native


@pytest.mark.parametrize("n", [32, 256, 4096])
def test_q8_0_roundtrip(rng, n):
    x = rng.standard_normal(n).astype(np.float16)
    q = quantize_q8_0(x)
    assert q.size == n // 32 * 34
    y = dequantize_q8_0(q, (n,))
    # int8 absmax quantization in fp16 arithmetic: error bounded by one
    # quantum (0.5 from rounding + fp16 division/product rounding slack)
    scale = (np.abs(x).reshape(-1, 32).max(axis=1) / 127.0).astype(np.float32)
    err = np.abs(x.astype(np.float32) - y.astype(np.float32)).reshape(-1, 32)
    assert np.all(err <= scale[:, None] * 1.05 + 1e-4)


def test_q8_0_zero_block():
    # all-zero blocks store d=1.0 (reference quirk, q8_0.py:25) and decode to 0
    x = np.zeros(64, dtype=np.float16)
    q = quantize_q8_0(x)
    d = q.reshape(-1, 34)[:, :2].copy().view(np.float16)
    assert np.all(d == 1.0)
    assert np.all(dequantize_q8_0(q, (64,)) == 0)


@pytest.mark.parametrize("n", [32, 2048])
def test_q8_1_roundtrip(rng, n):
    x = rng.standard_normal(n).astype(np.float16)
    q = quantize_q8_1(x)
    assert q.size == n // 32 * 36
    y = dequantize_q8_1(q, (n,))
    assert np.max(np.abs(x.astype(np.float32) - y.astype(np.float32))) < 0.05

    # the stored s must equal d * sum(qs) in fp16
    d, s, qs = parse_q8_1(q)
    s_expect = (d.astype(np.float16) * qs.sum(axis=1, dtype=np.int32).astype(np.float16)).astype(np.float32)
    np.testing.assert_array_equal(s, s_expect)


def test_q8_1_zero_block():
    x = np.zeros(32, dtype=np.float16)
    q = quantize_q8_1(x)
    d, s, qs = parse_q8_1(q)
    assert d[0] == 0.0 and s[0] == 0.0 and np.all(qs == 0)


@pytest.mark.parametrize("n", [256, 1024, 8192])
def test_q4_k_roundtrip(rng, n):
    x = rng.standard_normal(n).astype(np.float32)
    q = quantize_q4_k(x)
    assert q.size == n // 256 * 144
    y = dequantize_q4_k(q, (n,))
    # 4-bit with per-32 affine fit: rms error well under 0.2 for unit normals
    rms = np.sqrt(np.mean((x - y) ** 2))
    assert rms < 0.2, rms


@pytest.mark.parametrize("n", [256, 1024, 8192])
def test_q6_k_roundtrip(rng, n):
    x = rng.standard_normal(n).astype(np.float32)
    q = quantize_q6_k(x)
    assert q.size == n // 256 * 210
    y = dequantize_q6_k(q, (n,))
    rms = np.sqrt(np.mean((x - y) ** 2))
    assert rms < 0.05, rms


def test_q4_k_scale_pack_unpack_inverse(rng):
    sc = rng.integers(0, 64, size=(17, 8)).astype(np.uint8)
    mn = rng.integers(0, 64, size=(17, 8)).astype(np.uint8)
    sc2, mn2 = unpack_scale_min(pack_scale_min(sc, mn))
    np.testing.assert_array_equal(sc, sc2)
    np.testing.assert_array_equal(mn, mn2)


def test_q4_k_parse_fields(rng):
    x = rng.standard_normal(512).astype(np.float32)
    q = quantize_q4_k(x)
    d, dmin, sc, mn, codes = parse_q4_k(q)
    assert d.shape == (2,) and sc.shape == (2, 8) and codes.shape == (2, 256)
    assert codes.max() <= 15 and np.all(sc < 64) and np.all(mn < 64)


def test_q6_k_parse_fields(rng):
    x = rng.standard_normal(512).astype(np.float32)
    q = quantize_q6_k(x)
    d, scales, codes = parse_q6_k(q)
    assert d.shape == (2,) and scales.shape == (2, 16) and codes.shape == (2, 256)
    assert codes.min() >= -32 and codes.max() <= 31


def test_native_dequant_matches_numpy(rng):
    """The C dequantizer and the vectorized numpy dequantizer agree bitwise."""
    x = rng.standard_normal(1024).astype(np.float32)
    q4 = quantize_q4_k(x)
    np.testing.assert_array_equal(
        native.dequantize_q4_k_native(q4, 1024), dequantize_q4_k(q4, (1024,)))
    q6 = quantize_q6_k(x)
    np.testing.assert_array_equal(
        native.dequantize_q6_k_native(q6, 1024), dequantize_q6_k(q6, (1024,)))


def test_fp16_bit_conversion_exact(rng):
    """Native fp16<->fp32 agrees with numpy's IEEE conversions on all 2^16 bit patterns."""
    bits = np.arange(2**16, dtype=np.uint16)
    finite = np.isfinite(bits.view(np.float16))
    f32 = native.fp16_bits_to_fp32(bits[finite])
    np.testing.assert_array_equal(f32, bits[finite].view(np.float16).astype(np.float32))
    back = native.fp32_to_fp16_bits(f32)
    np.testing.assert_array_equal(back, bits[finite])


def test_jax_fp16_bits_roundtrip_exact():
    """The JAX integer-op f32->fp16 conversion (quant/layouts.py) is bit-exact
    vs numpy on every finite fp16 pattern, eager AND jitted — astype(f16)
    round-trips are NOT jit-stable (XLA elides the lossy convert pair)."""
    import jax
    from gguf_tpu.quant.layouts import f32_to_fp16_bits, fp16_bits_to_f32

    bits = np.arange(2**16, dtype=np.uint16)
    finite = bits[np.isfinite(bits.view(np.float16))]
    f32 = finite.view(np.float16).astype(np.float32)
    for fn in (f32_to_fp16_bits, jax.jit(f32_to_fp16_bits)):
        np.testing.assert_array_equal(np.asarray(fn(f32)), finite)
    for fn in (fp16_bits_to_f32, jax.jit(fp16_bits_to_f32)):
        np.testing.assert_array_equal(np.asarray(fn(finite)), f32)
    # halfway cases round to even
    half = np.float32(1.0) + np.float32(2.0**-11)  # exactly between fp16 ulps
    assert int(f32_to_fp16_bits(np.float32([half]))[0]) == 0x3C00


def test_activation_quant_jit_stable_and_codec_exact(rng):
    """quantize_q8_1_act emits the same int8 codes eager, jitted, and vs the
    numpy Q8_1 codec (regression: f16 jnp arithmetic quantized differently
    under jit because XLA contracts fused f16 chains at f32)."""
    import jax
    from gguf_tpu.ops.activation import quantize_q8_1_act

    x = rng.standard_normal((16, 4096)).astype(np.float32)
    qe, de, se = quantize_q8_1_act(x)
    qj, dj, sj = jax.jit(quantize_q8_1_act)(x)
    np.testing.assert_array_equal(np.asarray(qe), np.asarray(qj))
    np.testing.assert_array_equal(np.asarray(de), np.asarray(dj))
    np.testing.assert_array_equal(np.asarray(se), np.asarray(sj))

    d_np, s_np, qs_np = parse_q8_1(quantize_q8_1(x.astype(np.float16)))
    np.testing.assert_array_equal(np.asarray(qe).reshape(-1, 32), qs_np)
    np.testing.assert_array_equal(np.asarray(de).reshape(-1), d_np)
    np.testing.assert_array_equal(np.asarray(se).reshape(-1), s_np)


def test_relative_error_heatmap(tmp_path, rng):
    from gguf_tpu.utils.testing import relative_error_heatmap

    exact = rng.standard_normal((16, 16)).astype(np.float32)
    approx = exact + rng.standard_normal((16, 16)).astype(np.float32) * 1e-3
    out = str(tmp_path / "err.png")
    err = relative_error_heatmap(approx, exact, path=out)
    assert err.shape == (16, 16) and err.max() < 0.1
    import os
    assert os.path.getsize(out) > 0


@pytest.mark.parametrize("n", [256, 1024])
def test_q2_k_roundtrip(rng, n):
    """2-bit: the coarsest K-quant; SNR for unit normals sits near 11 dB."""
    from gguf_tpu.quant import quantize_q2_k, dequantize_q2_k, parse_q2_k
    from gguf_tpu.utils.testing import snr_db

    x = rng.standard_normal(n).astype(np.float32)
    q = quantize_q2_k(x)
    assert q.size == n // 256 * 84
    y = dequantize_q2_k(q, (n,))
    assert snr_db(x, x - y) > 8.0
    d, dmin, sc, mn, codes = parse_q2_k(q)
    assert codes.max() <= 3 and np.all(sc < 16) and np.all(mn < 16)


@pytest.mark.parametrize("n", [256, 1024])
def test_q3_k_roundtrip(rng, n):
    """3-bit signed: SNR between q2_k (~11 dB) and q4_k (~24 dB)."""
    from gguf_tpu.quant import quantize_q3_k, dequantize_q3_k, parse_q3_k
    from gguf_tpu.utils.testing import snr_db

    x = rng.standard_normal(n).astype(np.float32)
    q = quantize_q3_k(x)
    assert q.size == n // 256 * 110
    y = dequantize_q3_k(q, (n,))
    assert snr_db(x, x - y) > 13.0
    d, sc, codes = parse_q3_k(q)
    assert codes.max() <= 3 and codes.min() >= -4
    assert sc.max() < 32 and sc.min() >= -32


def test_q2_k_q3_k_code_pack_unpack_inverse(rng):
    from gguf_tpu.quant.q2_k import pack_q2_k_codes, parse_q2_k_codes
    from gguf_tpu.quant.q3_k import (pack_q3_k_codes, parse_q3_k_codes,
                                     pack_q3_k_scales, unpack_q3_k_scales)

    codes2 = rng.integers(0, 4, (4, 256)).astype(np.uint8)
    blocks = np.zeros((4, 84), np.uint8)
    blocks[:, 16:80] = pack_q2_k_codes(codes2)
    np.testing.assert_array_equal(parse_q2_k_codes(blocks.reshape(-1)), codes2)

    codes3 = rng.integers(-4, 4, (4, 256)).astype(np.int8)
    hm, qs = pack_q3_k_codes(codes3)
    blocks = np.zeros((4, 110), np.uint8)
    blocks[:, :32] = hm
    blocks[:, 32:96] = qs
    np.testing.assert_array_equal(parse_q3_k_codes(blocks.reshape(-1)), codes3)

    sc = rng.integers(-32, 32, (4, 16))
    np.testing.assert_array_equal(unpack_q3_k_scales(pack_q3_k_scales(sc)), sc)


@pytest.mark.parametrize("n", [256, 1024])
def test_q5_k_roundtrip(rng, n):
    """5-bit SNR sits between q4_k (~24 dB) and q6_k (~34 dB)."""
    from gguf_tpu.utils.testing import snr_db

    x = rng.standard_normal(n).astype(np.float32)
    q = quantize_q5_k(x)
    assert q.size == n // 256 * 176
    y = dequantize_q5_k(q, (n,))
    assert snr_db(x, x - y) > 25.0
    d, dmin, sc, mn, codes = parse_q5_k(q)
    assert codes.max() <= 31 and np.all(sc < 64) and np.all(mn < 64)


def test_q5_k_code_pack_unpack_inverse(rng):
    from gguf_tpu.quant.q5_k import pack_q5_k_codes

    codes = rng.integers(0, 32, (4, 256)).astype(np.uint8)
    qh, qs = pack_q5_k_codes(codes)
    # re-parse through a synthetic block: build bytes and parse
    blocks = np.zeros((4, 176), np.uint8)
    blocks[:, 16:48] = qh
    blocks[:, 48:] = qs
    _, _, _, _, back = parse_q5_k(blocks.reshape(-1))
    np.testing.assert_array_equal(back, codes)


@pytest.mark.parametrize("fmt,bpb,floor", [
    ("q4_0", 18, 18.0), ("q4_1", 20, 19.0),
    ("q5_0", 22, 24.0), ("q5_1", 24, 25.0),
])
@pytest.mark.parametrize("n", [32, 1024])
def test_legacy_roundtrip(rng, fmt, bpb, floor, n):
    """Legacy 32-block formats: byte sizes, SNR floors (about +6 dB per
    extra bit), code ranges, and quantize->parse->dequantize coherence."""
    from gguf_tpu.quant import legacy as lg
    from gguf_tpu.utils.testing import snr_db

    quant = getattr(lg, f"quantize_{fmt}")
    deq = getattr(lg, f"dequantize_{fmt}")
    parse = getattr(lg, f"parse_{fmt}")

    x = rng.standard_normal(n).astype(np.float32)
    q = quant(x)
    assert q.size == n // 32 * bpb
    y = deq(q, (n,))
    assert snr_db(x, x - y) > floor
    codes = parse(q)[-1]
    assert codes.max() < (32 if fmt.startswith("q5") else 16)
    assert codes.min() >= 0


@pytest.mark.parametrize("fmt,bpb,nel,floor", [
    ("iq4_nl", 18, 32, 21.0), ("iq4_xs", 136, 256, 21.0),
])
@pytest.mark.parametrize("n", [256, 2048])
def test_iq4_roundtrip(rng, fmt, bpb, nel, floor, n):
    """IQ4 codebook formats: byte sizes, SNR floors (the nonlinear table
    beats linear 4-bit by ~3 dB on gaussian data), index ranges, and
    quantize->parse->dequantize coherence."""
    from gguf_tpu.quant import iq4
    from gguf_tpu.utils.testing import snr_db

    quant = getattr(iq4, f"quantize_{fmt}")
    deq = getattr(iq4, f"dequantize_{fmt}")
    parse = getattr(iq4, f"parse_{fmt}")

    x = rng.standard_normal(n).astype(np.float32)
    q = quant(x)
    assert q.size == n // nel * bpb
    y = deq(q, (n,))
    assert snr_db(x, x - y) > floor
    codes = parse(q)[-1]
    assert codes.max() < 16 and codes.min() >= 0
    assert np.isfinite(y).all()


def test_iq4_best_index_ties_and_extremes():
    """best_index must clamp to the table ends and break midpoint ties
    upward (the ggml best_index_int8 contract)."""
    from gguf_tpu.quant.iq4 import KVALUES, best_index

    assert best_index(np.float32(-1000.0)) == 0
    assert best_index(np.float32(1000.0)) == 15
    for i, v in enumerate(KVALUES):
        assert best_index(np.float32(v)) == i
    mid = (KVALUES[3] + KVALUES[4]) / 2.0   # exact tie -> upper index
    assert best_index(np.float32(mid)) == 4


def test_iq4_all_zero_block():
    from gguf_tpu.quant import iq4

    for fmt, n in (("iq4_nl", 64), ("iq4_xs", 256)):
        q = getattr(iq4, f"quantize_{fmt}")(np.zeros(n, np.float32))
        y = getattr(iq4, f"dequantize_{fmt}")(q, (n,))
        np.testing.assert_array_equal(y, 0.0)


def test_legacy_qh_pack_unpack_inverse(rng):
    from gguf_tpu.quant.legacy import _pack_qh, _unpack_qh

    hi = rng.integers(0, 2, (6, 32)).astype(np.uint8)
    np.testing.assert_array_equal(_unpack_qh(_pack_qh(hi)), hi)


def test_legacy_all_zero_block():
    """d == 0 blocks must quantize without dividing by zero and dequantize
    back to exact zeros (the GGML id = d ? 1/d : 0 guard)."""
    from gguf_tpu.quant import legacy as lg

    x = np.zeros(64, np.float32)
    for fmt in ("q4_0", "q4_1", "q5_0", "q5_1"):
        q = getattr(lg, f"quantize_{fmt}")(x)
        y = getattr(lg, f"dequantize_{fmt}")(q, (64,))
        np.testing.assert_array_equal(y, 0.0)


def test_quantize_codes_pallas_bit_identical():
    """quantize_q8_1_codes (the integer-dot operands: codes, d and the
    fp16 s-field, reshaped to any leading shape) must produce EXACTLY the
    q/d/s of quantize_q8_1_act — same fp16 rounding points, same clip."""
    import jax.numpy as jnp

    from gguf_tpu.ops.activation import (quantize_q8_1_act,
                                         quantize_q8_1_codes)

    rng = np.random.default_rng(11)
    for n, k in ((1, 256), (16, 1024), (64, 4096)):
        x = jnp.asarray(rng.standard_normal((n, k)).astype(np.float32)) * 5
        qr, dr, sr = quantize_q8_1_act(x)
        qg, dg, sg = quantize_q8_1_codes(x)
        assert (np.asarray(qg) == np.asarray(qr)).all(), (n, k)
        assert (np.asarray(dg) == np.asarray(dr)).all(), (n, k)
        assert (np.asarray(sg) == np.asarray(sr)).all(), (n, k)
    # the zero-block guard: d == 0 must emit zero codes, not NaNs
    x0 = jnp.zeros((8, 256), jnp.float32)
    qg, dg, sg = quantize_q8_1_codes(x0)
    assert (np.asarray(qg) == 0).all() and (np.asarray(dg) == 0).all()
