"""Decode attention and cache insert over the int8 KV cache
(ops/attention.py) vs numpy references."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from gguf_tpu.ops import attention as attn
from gguf_tpu.ops.attention import decode_attention


def _quant(x):
    amax = np.abs(x).max(-1)
    sc = amax / 127.0
    sc[sc == 0] = 1e-9
    q = np.clip(np.rint(x / sc[..., None]), -127, 127).astype(np.int8)
    return jnp.asarray(q), jnp.asarray(sc.astype(np.float32))


def _reference(q, k_i, ks, v_i, vs, pos, t):
    """Dequantize-everything einsum attention, f64."""
    b, h, _, hd = q.shape
    kvh, s = k_i.shape[1], k_i.shape[2]
    g = h // kvh
    k_all = np.asarray(k_i).astype(np.float64) * np.asarray(ks)[..., None]
    v_all = np.asarray(v_i).astype(np.float64) * np.asarray(vs)[..., None]
    qg = np.asarray(q).astype(np.float64).reshape(b, kvh, g * t, hd)
    scores = np.einsum("bgqd,bgsd->bgqs", qg, k_all) / np.sqrt(hd)
    tok = np.asarray(pos)[:, None] + (np.arange(g * t) % t)[None, :]
    mask = np.arange(s)[None, None, :] <= tok[:, :, None]          # (b, Q, s)
    scores = np.where(mask[:, None], scores, -1e30)
    probs = np.exp(scores - scores.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    return np.einsum("bgqs,bgsd->bgqd", probs, v_all).reshape(b, h, t, hd)


@pytest.mark.parametrize("t", [1, 2, 4])
@pytest.mark.parametrize("b,h,kvh,s,hd", [
    (4, 8, 2, 64, 64),     # GQA
    (2, 4, 4, 32, 64),     # MHA (g=1)
    (3, 8, 1, 128, 128),   # MQA, 128 head dim
])
def test_decode_attention_matches_reference(t, b, h, kvh, s, hd):
    rng = np.random.default_rng(hash((t, b, h)) % 2**31)
    q = jnp.asarray(rng.standard_normal((b, h, t, hd)), jnp.float32)
    k_i, ks = _quant(rng.standard_normal((b, kvh, s, hd)).astype(np.float32))
    v_i, vs = _quant(rng.standard_normal((b, kvh, s, hd)).astype(np.float32))
    pos = jnp.asarray(rng.integers(1, s - t, b), jnp.int32)

    ref = _reference(q, k_i, ks, v_i, vs, pos, t)
    for precision, tol in [("high", 2e-5), ("fast", 2e-2)]:
        out = np.asarray(decode_attention(
            q, k_i, ks, v_i, vs, pos, t=t, precision=precision))
        err = np.abs(out - ref).max() / np.abs(ref).max()
        assert err < tol, (precision, err)


def test_decode_attention_causality():
    """Key slots beyond pos must not influence the output."""
    rng = np.random.default_rng(0)
    b, h, kvh, s, hd, t = 2, 4, 2, 32, 64, 1
    q = jnp.asarray(rng.standard_normal((b, h, t, hd)), jnp.float32)
    kf = rng.standard_normal((b, kvh, s, hd)).astype(np.float32)
    vf = rng.standard_normal((b, kvh, s, hd)).astype(np.float32)
    pos = jnp.asarray([5, 9], jnp.int32)

    k_i, ks = _quant(kf)
    v_i, vs = _quant(vf)
    out_a = np.asarray(decode_attention(q, k_i, ks, v_i, vs, pos, t=t))

    # scribble on the future slots — output must not move
    kf2, vf2 = kf.copy(), vf.copy()
    for i, p in enumerate([5, 9]):
        kf2[i, :, p + 1:] = 1e3
        vf2[i, :, p + 1:] = -1e3
    k_i2, ks2 = _quant(kf2)
    v_i2, vs2 = _quant(vf2)
    out_b = np.asarray(decode_attention(q, k_i2, ks2, v_i2, vs2, pos, t=t))
    np.testing.assert_allclose(out_a, out_b, rtol=0, atol=1e-6)


def test_kv_cache_insert_windows():
    """Insert writes exactly the t new rows (quantized per-contract) and
    leaves every other cache byte untouched."""
    from gguf_tpu.ops.attention import kv_cache_insert

    rng = np.random.default_rng(3)
    b, kvh, s, hd = 3, 2, 256, 128
    for t, positions in [(1, [0, 130, 255]), (4, [30, 127, 200]),
                         (1, [999, 5, 600])]:      # >= s: ignored (dead slot)
        kf = rng.standard_normal((b, kvh, s, hd)).astype(np.float32)
        vf = rng.standard_normal((b, kvh, s, hd)).astype(np.float32)
        k_i, ks = _quant(kf)
        v_i, vs = _quant(vf)
        kn = rng.standard_normal((b, kvh, t, hd)).astype(np.float32)
        vn = rng.standard_normal((b, kvh, t, hd)).astype(np.float32)
        pos = jnp.asarray(positions, jnp.int32)

        ko, kso, vo, vso = jax.tree.map(
            np.asarray,
            kv_cache_insert(jnp.asarray(kn), jnp.asarray(vn), k_i, ks,
                            v_i, vs, pos, t=t))

        qn, sn = _quant(kn)
        qvn, svn = _quant(vn)
        exp_k, exp_ks = np.asarray(k_i).copy(), np.asarray(ks).copy()
        exp_v, exp_vs = np.asarray(v_i).copy(), np.asarray(vs).copy()
        for i, p in enumerate(positions):
            for tj in range(t):
                if p + tj >= s:
                    continue
                exp_k[i, :, p + tj] = np.asarray(qn)[i, :, tj]
                exp_ks[i, :, p + tj] = np.asarray(sn)[i, :, tj]
                exp_v[i, :, p + tj] = np.asarray(qvn)[i, :, tj]
                exp_vs[i, :, p + tj] = np.asarray(svn)[i, :, tj]
        np.testing.assert_array_equal(ko, exp_k)
        np.testing.assert_array_equal(vo, exp_v)
        # in-kernel f32 quantization matches the host path to float rounding
        np.testing.assert_allclose(kso, exp_ks, rtol=1e-6)
        np.testing.assert_allclose(vso, exp_vs, rtol=1e-6)


def test_decode_attention_span_equivalence():
    """With every pos + t <= span, reading only the span prefix must give
    the same output as scanning the whole cache."""
    rng = np.random.default_rng(11)
    b, h, kvh, s, hd = 2, 8, 2, 512, 128
    for t in (1, 4):
        q = jnp.asarray(rng.standard_normal((b, h, t, hd)), jnp.float32)
        k_i, ks = _quant(rng.standard_normal((b, kvh, s, hd)).astype(np.float32))
        v_i, vs = _quant(rng.standard_normal((b, kvh, s, hd)).astype(np.float32))
        pos = jnp.asarray([7, 100], jnp.int32)
        full = np.asarray(decode_attention(
            q, k_i, ks, v_i, vs, pos, t=t, precision="high"))
        for span in (128, 256):
            part = np.asarray(decode_attention(
                q, k_i, ks, v_i, vs, pos, t=t, precision="high", span=span))
            np.testing.assert_allclose(part, full, rtol=0, atol=1e-5)


def test_decode_attention_update_roundtrip():
    """insert + span attention == reference over a cache with the new rows
    already placed."""
    from gguf_tpu.ops.attention import decode_attention_update

    rng = np.random.default_rng(4)
    b, h, kvh, s, hd, t = 2, 8, 4, 256, 64, 1
    q = jnp.asarray(rng.standard_normal((b, h, t, hd)), jnp.float32)
    kf = rng.standard_normal((b, kvh, s, hd)).astype(np.float32)
    vf = rng.standard_normal((b, kvh, s, hd)).astype(np.float32)
    kn = rng.standard_normal((b, kvh, t, hd)).astype(np.float32)
    vn = rng.standard_normal((b, kvh, t, hd)).astype(np.float32)
    pos = jnp.asarray([12, 90], jnp.int32)
    k_i, ks = _quant(kf)
    v_i, vs = _quant(vf)

    out, ko, kso, vo, vso = decode_attention_update(
        q, jnp.asarray(kn), jnp.asarray(vn), k_i, ks, v_i, vs, pos,
        t=t, precision="high", span=128)

    # build the expected cache on the host, then the reference attention
    qn, sn = _quant(kn)
    qvn, svn = _quant(vn)
    exp_k, exp_ks = np.asarray(k_i).copy(), np.asarray(ks).copy()
    exp_v, exp_vs = np.asarray(v_i).copy(), np.asarray(vs).copy()
    for i, p in enumerate([12, 90]):
        exp_k[i, :, p] = np.asarray(qn)[i, :, 0]
        exp_ks[i, :, p] = np.asarray(sn)[i, :, 0]
        exp_v[i, :, p] = np.asarray(qvn)[i, :, 0]
        exp_vs[i, :, p] = np.asarray(svn)[i, :, 0]
    ref = _reference(q, exp_k, exp_ks, exp_v, exp_vs, pos, t)
    err = np.abs(np.asarray(out) - ref).max() / np.abs(ref).max()
    assert err < 2e-5, err
    np.testing.assert_array_equal(np.asarray(ko), exp_k)
    np.testing.assert_array_equal(np.asarray(vo), exp_v)


@pytest.mark.parametrize("b,h,kvh,s,hd", [
    (2, 8, 2, 512, 64),     # GQA
    (2, 4, 4, 256, 128),    # MHA
    (3, 8, 1, 512, 128),    # MQA
])
def test_tiled_decode_attention_matches_single_tile(b, h, kvh, s, hd):
    """The single-token entry point over a 256-row span and the whole
    cache == `decode_attention` over the whole cache."""
    from gguf_tpu.ops.attention import decode_attention_tiled

    rng = np.random.default_rng(hash((b, h, kvh)) % 2**31)
    q = jnp.asarray(rng.standard_normal((b, h, 1, hd)), jnp.float32)
    k_i, ks = _quant(rng.standard_normal((b, kvh, s, hd)).astype(np.float32))
    v_i, vs = _quant(rng.standard_normal((b, kvh, s, hd)).astype(np.float32))
    pos = jnp.asarray(rng.integers(1, s - 1, b), jnp.int32)

    ref = np.asarray(decode_attention(
        q, k_i, ks, v_i, vs, pos, t=1, precision="high"))
    for span in (256, s):
        out = np.asarray(decode_attention_tiled(
            q, k_i, ks, v_i, vs, pos, precision="high", span=span))
        # spans shorter than pos+1 only cover prefixes; compare where valid
        valid = np.asarray(pos) < span
        np.testing.assert_allclose(out[valid], ref[valid], rtol=0, atol=2e-5)


def _reference_swa(q, k_i, ks, v_i, vs, pos, t, window=0, softcap=0.0):
    """_reference plus sliding window and score soft-capping."""
    b, h, _, hd = q.shape
    kvh, s = k_i.shape[1], k_i.shape[2]
    g = h // kvh
    k_all = np.asarray(k_i).astype(np.float64) * np.asarray(ks)[..., None]
    v_all = np.asarray(v_i).astype(np.float64) * np.asarray(vs)[..., None]
    qg = np.asarray(q).astype(np.float64).reshape(b, kvh, g * t, hd)
    scores = np.einsum("bgqd,bgsd->bgqs", qg, k_all) / np.sqrt(hd)
    if softcap:
        scores = softcap * np.tanh(scores / softcap)
    tok = np.asarray(pos)[:, None] + (np.arange(g * t) % t)[None, :]
    mask = np.arange(s)[None, None, :] <= tok[:, :, None]
    if window:
        mask &= np.arange(s)[None, None, :] > tok[:, :, None] - window
    scores = np.where(mask[:, None], scores, -1e30)
    probs = np.exp(scores - scores.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    return np.einsum("bgqs,bgsd->bgqd", probs, v_all).reshape(b, h, t, hd)


@pytest.mark.parametrize("t", [1, 4])
@pytest.mark.parametrize("window,softcap", [(16, 0.0), (0, 10.0), (16, 10.0)])
def test_decode_attention_window_softcap(t, window, softcap):
    """Sliding-window mask and score soft-capping (gemma2-family) against
    the f64 einsum reference, for single-token and multi-token steps."""
    b, h, kvh, s, hd = 3, 8, 2, 64, 64
    rng = np.random.default_rng(hash((t, window)) % 2**31)
    q = jnp.asarray(rng.standard_normal((b, h, t, hd)), jnp.float32)
    k_i, ks = _quant(rng.standard_normal((b, kvh, s, hd)).astype(np.float32))
    v_i, vs = _quant(rng.standard_normal((b, kvh, s, hd)).astype(np.float32))
    pos = jnp.asarray([30, 40, 50 - t], jnp.int32)   # all beyond the window

    ref = _reference_swa(q, k_i, ks, v_i, vs, pos, t,
                         window=window, softcap=softcap)
    got = np.asarray(decode_attention(
        q, k_i, ks, v_i, vs, pos, t=t, precision="high",
        window=window, softcap=softcap))
    np.testing.assert_allclose(got, ref, atol=2e-3)
    if window:
        # dropping the window changes the result (positions exceed it)
        base = np.asarray(decode_attention(
            q, k_i, ks, v_i, vs, pos, t=t, precision="high",
            softcap=softcap))
        assert np.abs(base - got).max() > 1e-3


def test_tiled_decode_attention_window_softcap():
    """The single-token entry point over a span agrees with the whole-cache
    form under window + softcap."""
    from gguf_tpu.ops.attention import decode_attention_tiled

    b, h, kvh, s, hd = 2, 8, 2, 512, 64
    rng = np.random.default_rng(9)
    q = jnp.asarray(rng.standard_normal((b, h, 1, hd)), jnp.float32)
    k_i, ks = _quant(rng.standard_normal((b, kvh, s, hd)).astype(np.float32))
    v_i, vs = _quant(rng.standard_normal((b, kvh, s, hd)).astype(np.float32))
    pos = jnp.asarray([300, 440], jnp.int32)

    a = np.asarray(decode_attention(
        q, k_i, ks, v_i, vs, pos, t=1, precision="high",
        window=64, softcap=8.0))
    bt = np.asarray(decode_attention_tiled(
        q, k_i, ks, v_i, vs, pos, precision="high", span=512,
        window=64, softcap=8.0))
    np.testing.assert_allclose(bt, a, atol=2e-3)


def _cache(rng, b, kvh, s, hd):
    k = jnp.asarray(rng.integers(-127, 128, (b, kvh, s, hd)), jnp.int8)
    sc = jnp.asarray(rng.uniform(0.005, 0.02, (b, kvh, s)), jnp.float32)
    return k, sc


@pytest.mark.parametrize("hd,b,h,kvh,span,window,softcap", [
    (64, 3, 8, 2, 128, 0, 0.0),       # GQA
    (64, 2, 8, 2, 512, 0, 0.0),       # whole cache
    (128, 2, 4, 4, 256, 0, 0.0),      # MHA at head_dim 128
    (128, 1, 8, 1, 192, 0, 0.0),      # MQA, span not a power of two
    (64, 2, 8, 2, 256, 48, 0.0),      # sliding window
    (64, 2, 8, 2, 256, 0, 20.0),      # soft-capped scores
])
def test_decode_attention_precisions_match_reference(hd, b, h, kvh, span,
                                                     window, softcap):
    """Single-token decode over a span prefix at both precisions against
    the f64 reference on the span: bf16 operands within 1e-2 of max|ref|,
    f32 at HIGHEST within 1e-5. Rows past the span hold garbage that must
    not leak in."""
    rng = np.random.default_rng(hd + span + window)
    s = 512
    k, ks = _cache(rng, b, kvh, s, hd)
    v, vs = _cache(rng, b, kvh, s, hd)
    k = k.at[:, :, span:].set(127)
    ks = ks.at[:, :, span:].set(1e3)
    q = jnp.asarray(rng.standard_normal((b, h, 1, hd)), jnp.float32)
    pos = jnp.asarray(rng.integers(0, span, b), jnp.int32).at[0].set(
        span - 1)
    want = _reference_swa(q, k[:, :, :span], ks[:, :, :span],
                          v[:, :, :span], vs[:, :, :span], pos, 1,
                          window=window, softcap=softcap)
    for precision, tol in (("fast", 1e-2), ("high", 1e-5)):
        got = np.asarray(decode_attention(
            q, k, ks, v, vs, pos, t=1, precision=precision, span=span,
            window=window, softcap=softcap))
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err < tol, (precision, err)


def test_kv_cache_insert_drops_rows_outside_the_cache():
    """Negative positions (rows owned by an earlier sequence shard) and
    rows past the end are dropped; rows inside land exactly."""
    rng = np.random.default_rng(6)
    b, kvh, s, hd, t = 3, 2, 32, 64, 4
    k, ks = _cache(rng, b, kvh, s, hd)
    new = jnp.asarray(rng.standard_normal((b, kvh, t, hd)), jnp.float32)
    pos = jnp.asarray([-2, 10, 30], jnp.int32)
    k2, ks2, _, _ = attn.kv_cache_insert(new, new, k, ks, k, ks, pos, t=t)
    q, _ = attn.quantize_kv(new)
    k2, k0, q = np.asarray(k2), np.asarray(k), np.asarray(q)
    for i, p in enumerate([-2, 10, 30]):
        for j in range(t):
            r = p + j
            if 0 <= r < s:
                np.testing.assert_array_equal(k2[i, :, r], q[i, :, j])
        keep = [r for r in range(s) if not p <= r < p + t]
        np.testing.assert_array_equal(k2[i, :, keep], k0[i, :, keep])
