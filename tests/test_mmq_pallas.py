"""The MMQ ops (`MMQ[fmt]`, ops/mmq.py) vs the byte-level CPU goldens — the
reference's parity sweep (test/test_mmq_q8_0.py:17-43 etc.), as pytest. On
the CPU the dispatch takes the plain XLA form; the Triton kernel is driven
here directly in interpret mode (test_mmq_multi_tile_grid) and across its
shape classes in test_mmq_triton.py. `python chip_smoke.py` compares the
compiled kernel on the card.

The contract (reference test asymmetry, SURVEY.md §3.3): the golden consumes
pre-quantized Q8_1 activations, the kernel consumes float activations and
quantizes internally (act_quant=True) — both must agree to 1% of max|C|.
"""

import numpy as np
import pytest

from gguf_tpu.ops import (mmq_q8_0, mmq_q2_k, mmq_q3_k, mmq_q4_k,
                          mmq_q5_k, mmq_q6_k, mmq_q4_0, mmq_q4_1,
                          mmq_q5_0, mmq_q5_1, mmq_iq4_nl, mmq_iq4_xs)
from gguf_tpu.quant import (
    quantize_q8_0, quantize_q2_k, quantize_q3_k, quantize_q4_k,
    quantize_q5_k, quantize_q6_k, quantize_q8_1,
    quantize_q4_0, quantize_q4_1, quantize_q5_0, quantize_q5_1,
    quantize_iq4_nl, quantize_iq4_xs,
    mmq_q8_0_q8_1_golden, mmq_q2_k_q8_1_golden, mmq_q3_k_q8_1_golden,
    mmq_q4_k_q8_1_golden, mmq_q5_k_q8_1_golden, mmq_q6_k_q8_1_golden,
    mmq_q4_0_q8_1_golden, mmq_q4_1_q8_1_golden, mmq_q5_0_q8_1_golden,
    mmq_q5_1_q8_1_golden, mmq_iq4_nl_q8_1_golden, mmq_iq4_xs_q8_1_golden,
)
from gguf_tpu.quant.layouts import to_soa
from gguf_tpu.utils import allclose_rel, max_rel_err

CASES = {
    "q8_0": (quantize_q8_0, mmq_q8_0_q8_1_golden, mmq_q8_0, "q8_0", 32),
    "q2_k": (quantize_q2_k, mmq_q2_k_q8_1_golden, mmq_q2_k, "q2_k", 256),
    "q3_k": (quantize_q3_k, mmq_q3_k_q8_1_golden, mmq_q3_k, "q3_k", 256),
    "q4_k": (quantize_q4_k, mmq_q4_k_q8_1_golden, mmq_q4_k, "q4_k", 256),
    "q5_k": (quantize_q5_k, mmq_q5_k_q8_1_golden, mmq_q5_k, "q5_k", 256),
    "q6_k": (quantize_q6_k, mmq_q6_k_q8_1_golden, mmq_q6_k, "q6_k", 256),
    # legacy 32-block formats (beyond the reference's set)
    "q4_0": (quantize_q4_0, mmq_q4_0_q8_1_golden, mmq_q4_0, "q4_0", 256),
    "q4_1": (quantize_q4_1, mmq_q4_1_q8_1_golden, mmq_q4_1, "q4_1", 256),
    "q5_0": (quantize_q5_0, mmq_q5_0_q8_1_golden, mmq_q5_0, "q5_0", 256),
    "q5_1": (quantize_q5_1, mmq_q5_1_q8_1_golden, mmq_q5_1, "q5_1", 256),
    # IQ4 codebook formats
    "iq4_nl": (quantize_iq4_nl, mmq_iq4_nl_q8_1_golden, mmq_iq4_nl,
               "iq4_nl", 256),
    "iq4_xs": (quantize_iq4_xs, mmq_iq4_xs_q8_1_golden, mmq_iq4_xs,
               "iq4_xs", 256),
}


def _run(rng, fmt, m, n, k, **kw):
    quantize, golden, kernel, _, _ = CASES[fmt]
    a = rng.standard_normal((m, k)).astype(np.float16)
    b = rng.standard_normal((n, k)).astype(np.float16)
    c_golden = golden(quantize(a), quantize_q8_1(b), m, n, k)
    w = to_soa(fmt, quantize(a), m, k)
    c_kernel = np.asarray(kernel(w, b.astype(np.float32), **kw))
    assert c_kernel.shape == (n, m)
    return c_kernel, c_golden


# the reference's shape sweep: M,N in {1,4,16}, K from one block upwards
@pytest.mark.parametrize("m", [1, 4, 16])
@pytest.mark.parametrize("n", [1, 4, 16])
@pytest.mark.parametrize("k", [32, 256, 512])
def test_mmq_q8_0_parity(rng, m, n, k):
    got, want = _run(rng, "q8_0", m, n, k)
    assert allclose_rel(got, want, 0.01), max_rel_err(got, want)


@pytest.mark.parametrize("m", [1, 4, 16])
@pytest.mark.parametrize("n", [1, 4, 16])
@pytest.mark.parametrize("k", [256, 512, 1024])
def test_mmq_q4_k_parity(rng, m, n, k):
    got, want = _run(rng, "q4_k", m, n, k)
    assert allclose_rel(got, want, 0.01), max_rel_err(got, want)


@pytest.mark.parametrize("m", [1, 4, 16])
@pytest.mark.parametrize("n", [1, 4, 16])
@pytest.mark.parametrize("k", [256, 512, 1024])
def test_mmq_q5_k_parity(rng, m, n, k):
    got, want = _run(rng, "q5_k", m, n, k)
    assert allclose_rel(got, want, 0.01)


@pytest.mark.parametrize("m", [1, 4, 16])
@pytest.mark.parametrize("n", [1, 4, 16])
@pytest.mark.parametrize("k", [256, 512, 1024])
def test_mmq_q2_k_parity(rng, m, n, k):
    got, want = _run(rng, "q2_k", m, n, k)
    assert allclose_rel(got, want, 0.01), max_rel_err(got, want)


@pytest.mark.parametrize("m", [1, 4, 16])
@pytest.mark.parametrize("n", [1, 4, 16])
@pytest.mark.parametrize("k", [256, 512, 1024])
def test_mmq_q3_k_parity(rng, m, n, k):
    got, want = _run(rng, "q3_k", m, n, k)
    assert allclose_rel(got, want, 0.01), max_rel_err(got, want)


@pytest.mark.parametrize("m,n", [(1, 1), (4, 4), (16, 16), (16, 1)])
@pytest.mark.parametrize("k", [256, 512, 1024])
def test_mmq_q6_k_parity(rng, m, n, k):
    got, want = _run(rng, "q6_k", m, n, k)
    assert allclose_rel(got, want, 0.01), max_rel_err(got, want)


@pytest.mark.parametrize("fmt", ["iq4_nl", "iq4_xs"])
@pytest.mark.parametrize("m,n", [(1, 1), (4, 4), (16, 16), (1, 16)])
@pytest.mark.parametrize("k", [256, 1024])
def test_mmq_iq4_parity(rng, fmt, m, n, k):
    """IQ4 codebook formats: the reference M,N sweep against the byte-level
    integer-dot goldens (exercises the in-kernel codebook lookup)."""
    got, want = _run(rng, fmt, m, n, k)
    assert allclose_rel(got, want, 0.01), max_rel_err(got, want)


@pytest.mark.parametrize("fmt", ["q4_0", "q4_1", "q5_0", "q5_1"])
@pytest.mark.parametrize("m,n", [(1, 1), (4, 4), (16, 16), (1, 16)])
@pytest.mark.parametrize("k", [256, 1024])
def test_mmq_legacy_parity(rng, fmt, m, n, k):
    """Legacy 32-block formats (beyond the reference's kernel set): the
    reference M,N sweep against the byte-level integer-dot goldens."""
    got, want = _run(rng, fmt, m, n, k)
    assert allclose_rel(got, want, 0.01), max_rel_err(got, want)


@pytest.mark.parametrize("fmt", ["q8_0", "q2_k", "q3_k", "q4_k", "q5_k", "q6_k",
                                 "q4_0", "q4_1", "q5_0", "q5_1",
                                 "iq4_nl", "iq4_xs"])
def test_mmq_multi_tile_grid(rng, fmt):
    """Shapes that force several M tiles and a multi-superblock K loop in
    each of two K splits: the Triton kernel (interpret mode) for q4_k/q6_k,
    the dispatch for the rest, both against the golden."""
    from gguf_tpu.ops.mmq import Tiles, mmq_kernel
    from gguf_tpu.ops.activation import fake_quantize_q8_1

    got, want = _run(rng, fmt, 200, 4, 1024)
    assert allclose_rel(got, want, 0.01), max_rel_err(got, want)
    if fmt in ("q4_k", "q6_k"):
        quantize, golden, _, _, _ = CASES[fmt]
        a = rng.standard_normal((200, 1024)).astype(np.float16)
        b = rng.standard_normal((4, 1024)).astype(np.float16)
        want = golden(quantize(a), quantize_q8_1(b), 200, 4, 1024)
        w = to_soa(fmt, quantize(a), 200, 1024)
        got = np.asarray(mmq_kernel(
            w, fake_quantize_q8_1(b.astype(np.float32)),
            tiles=Tiles(bn=16, bm=64, k_splits=2, per_split=2)))
        assert allclose_rel(got, want, 0.01), max_rel_err(got, want)


@pytest.mark.parametrize("fmt", ["q8_0", "q2_k", "q3_k", "q4_k", "q5_k", "q6_k",
                                 "q4_0", "q4_1", "q5_0", "q5_1",
                                 "iq4_nl", "iq4_xs"])
@pytest.mark.parametrize("n", [40, 96])
def test_mmq_glue_arms_parity(rng, fmt, n):
    """Widths past the decode kernel's (KERNEL_MAX_N = 32): n=40 and n=96
    always take dequantize-then-dot. The main sweep stops at n=16."""
    got, want = _run(rng, fmt, 16, n, 512)
    assert allclose_rel(got, want, 0.01), max_rel_err(got, want)


@pytest.mark.parametrize("fmt", ["q8_0", "q2_k", "q3_k", "q4_k", "q5_k", "q6_k",
                                 "q4_0", "q4_1", "q5_0", "q5_1",
                                 "iq4_nl", "iq4_xs"])
def test_mmq_no_act_quant_matches_dequant_matmul(rng, fmt):
    """act_quant=False: kernel must equal dequantized-weights x float B."""
    quantize, _, kernel, _, _ = CASES[fmt]
    m, n, k = 16, 4, 512
    a = rng.standard_normal((m, k)).astype(np.float16)
    b = rng.standard_normal((n, k)).astype(np.float32)
    w = to_soa(fmt, quantize(a), m, k)
    got = np.asarray(kernel(w, b, act_quant=False))
    want = (np.asarray(w.dequantize()) @ b.T).T
    assert allclose_rel(got, want, 0.005), max_rel_err(got, want)


@pytest.mark.parametrize("fmt", ["q8_0", "q2_k", "q3_k", "q4_k", "q5_k", "q6_k"])
def test_mmq_large_n_tiled(rng, fmt):
    """Prefill-sized N (300 rows) through the dispatch."""
    got, want = _run(rng, fmt, 64, 300, 512)
    assert allclose_rel(got, want, 0.01), max_rel_err(got, want)


@pytest.mark.parametrize("fmt", ["q8_0", "q2_k", "q3_k", "q4_k", "q5_k", "q6_k"])
def test_compat_reference_signature(rng, fmt):
    """The reference's exact calling convention — raw GGUF bytes +
    (N, K) activations + explicit M, N, K — works through gguf_tpu.compat
    (reference: kernels/mmq_q8_0.py:102 etc.)."""
    from gguf_tpu import compat

    quant, golden, _, _, granule = CASES[fmt]
    m, n, k = 16, 4, 2 * granule
    a = rng.standard_normal((m, k)).astype(np.float16)
    b = rng.standard_normal((n, k)).astype(np.float16)
    qa = quant(a)
    want = golden(qa, quantize_q8_1(b), m, n, k)
    got = np.asarray(getattr(compat, f"mmq_{fmt}")(
        qa, b, m, n, k, precision="high"))
    assert got.shape == (n, m)
    assert allclose_rel(got, want, 0.01)
