"""Context parallelism (sp): sequence-sharded KV cache on the virtual mesh.

The cache's sequence dim is split contiguously over the `sp` mesh axis;
each shard inserts only the rows it owns (out-of-shard positions no-op in
the cache insert) and attention joins per-shard flash partials
with a pmax + two psums (models/llama.py:_cp_attention). These tests pin
the sharded forward to the single-device path across prefill chunks that
straddle shard boundaries and multi-step decode.

The reference has no distributed/long-context story (SURVEY.md §5 scoped
ring-style parallelism as the north-star gap) — this realization: resident sharded cache + LSE combine, no ring permutes.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from gguf_tpu.gguf import GGMLType
from gguf_tpu.models import (
    LlamaConfig, MMOpts, forward, init_kv_cache, load_llama,
    write_random_llama_gguf,
)
from gguf_tpu.parallel import (
    init_sharded_cache, make_mesh, make_tp_forward, shard_llama,
)

CFG = LlamaConfig(
    vocab_size=64, dim=512, n_layers=2, n_heads=4, n_kv_heads=2,
    ffn_dim=768, max_seq_len=64,
)
MAX_SEQ = 64


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cp") / "tiny.gguf")
    write_random_llama_gguf(path, CFG, fmt=GGMLType.Q4_K, seed=11)
    return load_llama(path)


def _reference_stream(cfg, params, token_stream, batch):
    """Single-device logits after each forward call in the stream."""
    cache = init_kv_cache(cfg, batch=batch, max_seq=MAX_SEQ)
    pos = np.zeros(batch, np.int32)
    outs = []
    for toks in token_stream:
        logits, cache = forward(params, cfg, jnp.asarray(toks),
                                jnp.asarray(pos), cache,
                                MMOpts(precision="high"))
        outs.append(np.asarray(logits[:, -1]))
        pos += toks.shape[1]
    return outs


def _sharded_stream(cfg, params, token_stream, batch, tp, sp, dp=1):
    mesh = make_mesh(tp=tp, dp=dp, sp=sp)
    params_s, cfg_s = shard_llama(params, cfg, mesh)
    fwd = make_tp_forward(cfg_s, mesh, MMOpts(precision="high"))
    cache = init_sharded_cache(cfg_s, mesh, batch=batch, max_seq=MAX_SEQ)
    pos = np.zeros(batch, np.int32)
    outs = []
    for toks in token_stream:
        logits, cache = fwd(params_s, jnp.asarray(toks), jnp.asarray(pos),
                            cache, batch_axis=None if batch < dp else "dp")
        outs.append(np.asarray(logits[:, -1]))
        pos += toks.shape[1]
    return outs


def _stream(rng, batch, chunks):
    return [rng.integers(0, CFG.vocab_size, (batch, t)).astype(np.int32)
            for t in chunks]


@pytest.mark.parametrize("tp,sp", [
    pytest.param(1, 2, marks=pytest.mark.slow),
    pytest.param(1, 4, marks=pytest.mark.slow),
    pytest.param(2, 2, marks=pytest.mark.slow),
])
def test_cp_matches_single_device(model, rng, tp, sp):
    """Prefill chunks that straddle the 16/32-row shard boundaries (t=40
    crosses two boundaries at sp=4) + decode steps must reproduce the
    unsharded logits."""
    cfg, params = model
    stream = _stream(rng, batch=2, chunks=[40, 1, 1, 8, 1])
    ref = _reference_stream(cfg, params, stream, batch=2)
    got = _sharded_stream(cfg, params, stream, batch=2, tp=tp, sp=sp)
    for step, (r, g) in enumerate(zip(ref, got)):
        np.testing.assert_allclose(
            g, r, rtol=0, atol=2e-2 * np.abs(r).max(),
            err_msg=f"step {step} tp={tp} sp={sp}")


@pytest.mark.slow
def test_cp_with_dp(model, rng):
    """Full dp x sp x tp mesh (2x2x2 = 8 virtual devices)."""
    cfg, params = model
    stream = _stream(rng, batch=2, chunks=[12, 1, 1])
    ref = _reference_stream(cfg, params, stream, batch=2)
    got = _sharded_stream(cfg, params, stream, batch=2, tp=2, sp=2, dp=2)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g, r, rtol=0, atol=2e-2 * np.abs(r).max())


def test_cp_smoke_boundary_chunk(model, rng):
    """Fast-suite CP coverage: one boundary-straddling prefill + one decode
    step at sp=2 must match single-device logits (the full multi-chunk
    streams and tp x sp x dp grids run under -m slow)."""
    cfg, params = model
    stream = _stream(rng, batch=1, chunks=[40, 1])
    ref = _reference_stream(cfg, params, stream, batch=1)
    got = _sharded_stream(cfg, params, stream, batch=1, tp=1, sp=2)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g, r, rtol=0, atol=2e-2 * np.abs(r).max())


def test_cp_cache_rows_land_on_owner_shards(model):
    """After a 40-token prefill at sp=2, each shard's scale rows must be
    nonzero exactly where it owns written rows: shard 0 rows 0..31 of 32,
    shard 1 rows 0..7."""
    cfg, params = model
    mesh = make_mesh(tp=1, sp=2)
    params_s, cfg_s = shard_llama(params, cfg, mesh)
    fwd = make_tp_forward(cfg_s, mesh, MMOpts(precision="high"))
    cache = init_sharded_cache(cfg_s, mesh, batch=1, max_seq=MAX_SEQ)
    toks = jnp.asarray(np.arange(40, dtype=np.int32)[None, :] % CFG.vocab_size)
    _, cache = fwd(params_s, toks, jnp.zeros(1, jnp.int32), cache,
                   batch_axis=None)
    ks = cache[0]["k_scale"]          # (1, KVH, 64) sharded over sp
    shards = [np.asarray(s.data) for s in ks.addressable_shards]
    assert len(shards) >= 2
    # row-major mesh order: device 0 = sp shard 0 (rows 0..31)
    s0, s1 = shards[0][0], shards[1][0]   # (KVH, 32) each
    assert (np.abs(s0) > 0).all(), "shard 0 should own rows 0..31, all written"
    assert (np.abs(s1[:, :8]) > 0).all(), "shard 1 rows 0..7 written"
    assert (s1[:, 8:] == 0).all(), "shard 1 rows 8..31 untouched"


def test_cp_sliding_window_softcap_gemma2(rng, tmp_path):
    """Gemma-2-shaped model (sliding window + attn softcap, alternating
    layers) under sp=2 must reproduce single-device logits — the window is
    one extra global-row compare in _cp_attention's mask; shards holding
    only out-of-window rows drop out of the flash psums."""
    cfg = LlamaConfig(
        vocab_size=64, dim=512, n_layers=2, n_heads=4, n_kv_heads=2,
        ffn_dim=768, max_seq_len=64, sliding_window=16, swa_pattern=2,
        attn_softcap=50.0,
    )
    path = str(tmp_path / "g2.gguf")
    write_random_llama_gguf(path, cfg, fmt=GGMLType.Q4_K, seed=13,
                            arch="gemma2")
    lcfg, params = load_llama(path)
    assert lcfg.sliding_window == 16 and lcfg.attn_softcap == 50.0

    # 40-token prefill crosses the sp=2 shard boundary AND exceeds the
    # window, so shard 0 contributes zero mass for late queries
    stream = _stream(rng, batch=1, chunks=[40, 1, 1])
    ref = _reference_stream(lcfg, params, stream, batch=1)
    got = _sharded_stream(lcfg, params, stream, batch=1, tp=1, sp=2)
    for step, (r, g) in enumerate(zip(ref, got)):
        np.testing.assert_allclose(
            g, r, rtol=0, atol=2e-2 * np.abs(r).max(),
            err_msg=f"step {step}")
