"""The MMQ Pallas kernel (Triton route, ops/mmq.py) in interpret mode
against its plain XLA form, plus the wrapper's tile choice, padding and
dispatch. The compiled kernel is compared on the card by
`python chip_smoke.py`."""

import jax.numpy as jnp
import numpy as np
import pytest

from gguf_tpu.ops import mmq as mmq_mod
from gguf_tpu.ops.mmq import Tiles, kernel_tiles, mmq_kernel, mmq_xla
from gguf_tpu.quant.layouts import quantize_to_soa
from gguf_tpu.utils import allclose_rel, max_rel_err

# real decode GEMM classes: TinyLlama-1.1B and Llama-2-7B (M, K)
MODEL_SHAPES = [(2560, 2048), (11264, 2048), (2048, 5632), (32000, 2048),
                (4096, 4096), (22528, 4096), (4096, 11008), (32000, 4096)]


def _weights(fmt, m, k, seed=0):
    rng = np.random.default_rng(seed)
    return quantize_to_soa(rng.standard_normal((m, k)).astype(np.float32),
                           fmt)


def _acts(n, k, seed=1):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.standard_normal((n, k)).astype(np.float32))


def _reference(w, b):
    """Dequantize-then-dot in f32 on the bf16-rounded activation: the
    kernel's operands, minus the rounding of the weights to bf16."""
    return np.asarray(mmq_xla(w, b.astype(jnp.bfloat16).astype(jnp.float32),
                              precision="high"))


@pytest.mark.parametrize("fmt", ["q4_k", "q6_k"])
@pytest.mark.parametrize("n", [1, 5, 16, 32])
@pytest.mark.parametrize("m,k", [(64, 256), (200, 1024), (130, 2304)])
def test_kernel_matches_plain_form(fmt, n, m, k):
    """Decode widths x shapes with one, several and ragged M tiles and
    K splits (2304 = 9 superblocks): the fused kernel equals
    dequantize-then-dot up to the bf16 rounding of the weights."""
    w = _weights(fmt, m, k)
    b = _acts(n, k)
    got = np.asarray(mmq_kernel(w, b))
    assert got.shape == (n, m)
    want = _reference(w, b)
    assert allclose_rel(got, want, 1e-2), max_rel_err(got, want)


@pytest.mark.parametrize("fmt", ["q4_k", "q6_k"])
@pytest.mark.parametrize("tiles", [
    Tiles(bn=16, bm=16, k_splits=1, per_split=6),   # one program walks all K
    Tiles(bn=16, bm=64, k_splits=6, per_split=1),   # one superblock each
    Tiles(bn=32, bm=32, k_splits=2, per_split=4),   # last split is short
], ids=["k-loop", "k-split", "ragged-split"])
def test_kernel_forced_tiles(fmt, tiles):
    """The K loop inside a program and the K-split second pass give the
    same product for any tiling of a 96x1536 GEMM."""
    w = _weights(fmt, 96, 1536, seed=2)
    b = _acts(7, 1536, seed=3)
    got = np.asarray(mmq_kernel(w, b, tiles=tiles))
    want = _reference(w, b)
    assert allclose_rel(got, want, 1e-2), max_rel_err(got, want)


@pytest.mark.parametrize("m,k", MODEL_SHAPES)
@pytest.mark.parametrize("n", [1, 16, 32])
def test_kernel_tiles_by_shape_class(m, k, n):
    """Tile choice at the model shapes: power-of-two N padding of at least
    16 rows, 64-wide M tiles, and K splits that cover every superblock
    without an empty split, and at least one wave of 132 SMs where the
    superblocks allow it."""
    t = kernel_tiles(m, k, n)
    sb = k // 256
    assert t.bn >= max(16, n) and t.bn & (t.bn - 1) == 0
    assert t.bm == 64
    assert t.k_splits * t.per_split >= sb > (t.k_splits - 1) * t.per_split
    programs = -(-m // t.bm) * t.k_splits
    assert programs >= min(132, -(-m // t.bm) * sb)


@pytest.mark.parametrize("fmt,n,precision,gpu,want", [
    ("q4_k", 1, "fast", True, True),
    ("q6_k", 32, "fast", True, True),
    ("q4_k", 33, "fast", True, False),     # prefill width: cuBLAS
    ("q4_k", 16, "high", True, False),     # f32 HIGHEST stays in XLA
    ("q8_0", 16, "fast", True, False),     # no kernel for this format
    ("q5_k", 16, "fast", True, False),
    ("q4_k", 16, "fast", False, False),    # CPU backend: plain form
])
def test_mmq_dispatch(fmt, n, precision, gpu, want):
    assert mmq_mod.use_kernel(fmt, n, precision, gpu) is want


def test_mmq_dispatch_takes_kernel_when_chosen(monkeypatch):
    """MMQ[fmt] runs the kernel when the dispatch says so (interpret mode
    here) and matches the plain form it replaces."""
    w = _weights("q4_k", 64, 512, seed=4)
    b = _acts(3, 512, seed=5)
    plain = np.asarray(mmq_mod.MMQ["q4_k"](w, b, act_quant=False,
                                           precision="fast"))
    calls = []
    real = mmq_mod.mmq_kernel
    monkeypatch.setattr(mmq_mod, "on_gpu", lambda: True)
    monkeypatch.setattr(mmq_mod, "mmq_kernel",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    fused = np.asarray(mmq_mod.MMQ["q4_k"](w, b, act_quant=False,
                                           precision="fast"))
    assert calls
    assert allclose_rel(fused, plain, 1e-2), max_rel_err(fused, plain)


@pytest.mark.parametrize("fmt,permute,plane", [
    ("q4_k", mmq_mod.permute_acts_q4k, "_Q4K_PLANE_LO"),
    ("q6_k", mmq_mod.permute_acts_q6k, "_Q6K_ELEM_AT_ROW"),
])
def test_activation_permutation_matches_layout(fmt, permute, plane):
    """The N-side permutation puts column c of a superblock at the element
    the layout stores in unpack row c."""
    from gguf_tpu.quant import layouts

    elem = getattr(layouts, plane)
    if fmt == "q4_k":
        elem = np.concatenate([elem, elem + 16])
    b = jnp.arange(512, dtype=jnp.float32)[None, :]
    got = np.asarray(permute(b))[0]
    for s in range(2):
        np.testing.assert_array_equal(got[s * 256:(s + 1) * 256],
                                      s * 256 + elem)
