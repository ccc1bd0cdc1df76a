"""Quantized matrix multiply (MMQ): C = (A @ B.T).T for a GGUF-quantized
weight A (M, K, SoA layout, quant/layouts.py) and float activations B
(N, K); the output is (N, M). Capability match of the reference's
`mmq_q8_0` / `mmq_q4_k` / `mmq_q6_k` entry points, extended to twelve
formats.

Two forms sit behind the one dispatch, `MMQ[fmt]`:

* The plain XLA form, for every format and width: `w.dequantize()` to f32,
  then one `dot_general` with f32 accumulation. precision="fast" feeds it
  bf16 operands; precision="high" keeps f32 operands at
  `Precision.HIGHEST` (an f32 dot on the GPU otherwise runs in TF32).
  `act_quant=True` first rounds B through Q8_1 (ops/activation.py), which
  reproduces the reference's numeric contract.
* A fused dequantize+matmul Pallas kernel through Triton for the two
  formats that carry a Q4_K_M checkpoint's weight stream (q4_k and q6_k),
  used on the GPU at decode widths (N <= KERNEL_MAX_N) with
  precision="fast". There the GEMM is bound by weight bytes; the kernel
  reads only the packed bytes, where the XLA form writes a dequantized
  copy of the weight before the dot reads it.

The kernel follows the reference's Triton design rather than a block
layout of its own: one program per (M tile, K split), a loop over
256-element superblocks inside the program, the codes unpacked with u8
shifts and masks in registers, a bf16 `pl.dot` per unpack plane with f32
accumulation. The weight is read in the stored SoA layout; the
activation columns are permuted once on the (small) N side into the
layout's plane order (`permute_acts_*`). Where the M tiles alone leave
most of the card idle, K is split across programs and the partial sums
meet in a second XLA pass.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..quant.layouts import QuantTensor, fp16_bits_to_f32, fp16_round
from .activation import fake_quantize_q8_1
from .common import next_pow2, on_gpu, pad_cols, pad_rows, running_interpreted

QK_K = 256

FORMATS = ("q8_0", "q2_k", "q3_k", "q4_k", "q5_k", "q6_k",
           "q4_0", "q4_1", "q5_0", "q5_1", "iq4_nl", "iq4_xs")

# widest activation batch the decode kernel serves; wider calls are
# compute-bound prefill and take dequantize-then-dot
KERNEL_MAX_N = 32

# programs the split-K tiling aims for: two waves over the H200's 132 SMs
_TARGET_PROGRAMS = 264


# -------------------------------------------------------- plain XLA form ---


def mmq_xla(w: QuantTensor, b: jax.Array, *,
            precision: str = "high") -> jax.Array:
    """Dequantize-then-dot: (N, K) float x (M, K) quantized -> (N, M)."""
    wd = w.dequantize()
    dims = (((1,), (1,)), ((), ()))
    if precision == "fast":
        out = jax.lax.dot_general(
            b.astype(jnp.bfloat16), wd.astype(jnp.bfloat16), dims,
            preferred_element_type=jnp.float32)
    else:
        out = jax.lax.dot_general(
            b.astype(jnp.float32), wd, dims,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST)
    return out


# ------------------------------------------------ activation permutations ---


def permute_acts_q4k(b: jax.Array) -> jax.Array:
    """Reorder activation columns into the Q4_K plane order: within each
    superblock, element (g*32 + h*16 + p) moves to column
    (h*128 + p*8 + g) — the order in which the kernel's [lo; hi] nibble
    planes of the stored qs rows hold the weights."""
    n, k = b.shape
    return b.reshape(n, k // QK_K, 8, 2, 16).transpose(0, 1, 3, 4, 2) \
            .reshape(n, k)


def permute_acts_q6k(b: jax.Array) -> jax.Array:
    """Reorder activation columns into the Q6_K plane order: within each
    superblock, element (blk*16 + h*8 + p) moves to column
    (h*128 + p*16 + blk)."""
    n, k = b.shape
    return b.reshape(n, k // QK_K, 16, 2, 8).transpose(0, 1, 3, 4, 2) \
            .reshape(n, k)


# ------------------------------------------ per-format decode functions ---
#
# Each format supplies: `fields(w)`, the stored arrays as free views whose
# leading axis is the superblock index and whose last axis is M; the
# activation permutation; and `decode(refs, s)`, which unpacks superblock
# s of the program's M tile into (column offset, (K_piece, BM) f32) pieces
# of the dequantized weight, the offsets indexing the permuted
# activation's 256 columns of that superblock.


def _q4_k_fields(w: QuantTensor):
    sb = w.shape[1] // QK_K
    m = w.lanes
    f16 = lambda a: jax.lax.bitcast_convert_type(a, jnp.float16)
    # qs row s*128 + j*8 + g packs elements g*32 + j (low nibble) and
    # g*32 + 16 + j (high nibble); 32-block g
    return (f16(w.d_bits), f16(w.dmin_bits), w.sc.reshape(sb, 8, m),
            w.mn.reshape(sb, 8, m), w.qs.reshape(sb, 16, 8, m))


def _q4_k_decode(refs, s):
    d_ref, dmin_ref, sc_ref, mn_ref, qs_ref = refs
    scale = d_ref[s].astype(jnp.float32)[None, :] \
        * sc_ref[s].astype(jnp.float32)                       # (8, BM)
    mins = dmin_ref[s].astype(jnp.float32)[None, :] \
        * mn_ref[s].astype(jnp.float32)
    q = qs_ref[s]                                             # (16, 8, BM) u8
    bm = q.shape[-1]
    lo = (q & 0xF).astype(jnp.float32) * scale[None] - mins[None]
    hi = (q >> 4).astype(jnp.float32) * scale[None] - mins[None]
    return [(0, lo.reshape(128, bm)), (128, hi.reshape(128, bm))]


def _q6_k_fields(w: QuantTensor):
    sb = w.shape[1] // QK_K
    m = w.lanes
    # ql row s*128 + a*64 + j*16 + g packs the low nibbles of elements
    # g*16 + a*4 + j and g*16 + 8 + a*4 + j; qh row s*64 + j*16 + g holds
    # their high crumbs at bits (2a, 4 + 2a); 16-block g
    return (jax.lax.bitcast_convert_type(w.d_bits, jnp.float16),
            w.sc.reshape(sb, 16, m), w.ql.reshape(sb, 2, 4, 16, m),
            w.qh.reshape(sb, 4, 16, m))


def _q6_k_decode(refs, s):
    d_ref, sc_ref, ql_ref, qh_ref = refs
    scale = d_ref[s].astype(jnp.float32)[None, :] \
        * sc_ref[s].astype(jnp.float32)                       # (16, BM)
    bias = 32.0 * scale                                       # codes - 32
    h = qh_ref[s]                                             # (4, 16, BM) u8
    bm = h.shape[-1]
    pieces = []
    for a in (0, 1):
        ql = ql_ref[s, a]                                     # (4, 16, BM) u8
        lo = (ql & 0xF) | (((h >> (2 * a)) & 3) << 4)
        hi = (ql >> 4) | (((h >> (4 + 2 * a)) & 3) << 4)
        for off, codes in ((a * 64, lo), (128 + a * 64, hi)):
            wv = codes.astype(jnp.float32) * scale[None] - bias[None]
            pieces.append((off, wv.reshape(64, bm)))
    return pieces


class _Format(NamedTuple):
    fields: object
    permute: object
    decode: object


_KERNEL_FORMATS = {
    "q4_k": _Format(_q4_k_fields, permute_acts_q4k, _q4_k_decode),
    "q6_k": _Format(_q6_k_fields, permute_acts_q6k, _q6_k_decode),
}


# ------------------------------------------------------- Triton kernel ---


class Tiles(NamedTuple):
    bn: int        # padded activation rows (power of two, >= 16)
    bm: int        # output columns per program
    k_splits: int  # programs along K
    per_split: int  # superblocks per K split


def kernel_tiles(m: int, k: int, n: int) -> Tiles:
    """Tile choice by shape class: N padded to a power of two >= 16 (the
    tensor cores' smallest operand), 64-wide M tiles (narrower for tiny
    M), and K split across programs until the grid holds about two waves
    of the card's 132 SMs."""
    bn = max(16, next_pow2(n))
    bm = min(64, max(16, next_pow2(m)))
    sb = k // QK_K
    m_tiles = -(-m // bm)
    want = max(1, min(sb, -(-_TARGET_PROGRAMS // m_tiles)))
    per = -(-sb // want)
    return Tiles(bn, bm, -(-sb // per), per)


def _mmq_kernel_body(decode, n_fields, per, b_ref, *refs):
    field_refs, o_ref = refs[:n_fields], refs[n_fields]
    c = pl.program_id(1)
    sb = b_ref.shape[1]
    lo = c * per
    hi = jnp.minimum(lo + per, sb)

    def body(s, acc):
        for off, wv in decode(field_refs, s):
            kp = wv.shape[0]
            bp = b_ref[:, s, pl.ds(off, kp)]                  # (BN, kp) bf16
            acc += pl.dot(bp, wv.astype(jnp.bfloat16))
        return acc

    acc = jax.lax.fori_loop(
        lo, hi, body, jnp.zeros(o_ref.shape, jnp.float32))
    o_ref[...] = acc


def mmq_kernel(w: QuantTensor, b: jax.Array, *,
               tiles: Tiles | None = None) -> jax.Array:
    """The fused Triton kernel (q4_k/q6_k, bf16 operands, f32 sums):
    (N, K) x (M, K) -> (N, M) f32. `tiles` overrides `kernel_tiles`.
    Not jitted on its own; `mmq` jits it."""
    fmt = _KERNEL_FORMATS[w.fmt]
    m, k = w.shape
    n = b.shape[0]
    assert b.shape[1] == k and k % QK_K == 0, (b.shape, w.shape)
    t = tiles or kernel_tiles(m, k, n)
    sb = k // QK_K
    m_pad = -(-m // t.bm) * t.bm

    fields = [pad_cols(f, m_pad) for f in fmt.fields(w)]
    bp = pad_rows(fmt.permute(b.astype(jnp.float32)).astype(jnp.bfloat16),
                  t.bn).reshape(t.bn, sb, QK_K)

    def field_spec(f):
        nd = f.ndim
        return pl.BlockSpec(f.shape[:-1] + (t.bm,),
                            lambda i, c, nd=nd: (0,) * (nd - 1) + (i,))

    out = pl.pallas_call(
        functools.partial(_mmq_kernel_body, fmt.decode, len(fields),
                          t.per_split),
        grid=(m_pad // t.bm, t.k_splits),
        in_specs=[pl.BlockSpec(bp.shape, lambda i, c: (0, 0, 0))]
        + [field_spec(f) for f in fields],
        out_specs=pl.BlockSpec((None, t.bn, t.bm), lambda i, c: (c, 0, i)),
        out_shape=jax.ShapeDtypeStruct((t.k_splits, t.bn, m_pad),
                                       jnp.float32),
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=2),
        interpret=running_interpreted(),
        name=f"mmq_{w.fmt}",
    )(bp, *fields)
    out = out[0] if t.k_splits == 1 else out.sum(axis=0)
    return out[:n, :m]


# ------------------------------------------------------------ dispatch ---


def use_kernel(fmt: str, n: int, precision: str, gpu: bool) -> bool:
    """Whether `mmq` takes the Triton kernel: q4_k/q6_k at decode widths
    with bf16 operands, on a GPU backend."""
    return (gpu and fmt in _KERNEL_FORMATS and precision == "fast"
            and n <= KERNEL_MAX_N)


def mmq(w: QuantTensor, b: jax.Array, *, act_quant: bool = True,
        out_dtype=jnp.float32, precision: str = "high") -> jax.Array:
    """C = (A @ B.T).T for a quantized A (M, K) and float B (N, K); returns
    (N, M). precision="high" keeps f32 operands at HIGHEST; "fast" uses
    bf16 operands with f32 accumulation. act_quant=True rounds B through
    Q8_1 first (the reference's numeric contract)."""
    assert b.shape[1] == w.shape[1], (b.shape, w.shape)
    fused = use_kernel(w.fmt, b.shape[0], precision, on_gpu())
    return _mmq(w, b, act_quant=act_quant, out_dtype=out_dtype,
                precision=precision, fused=fused)


@functools.partial(jax.jit, static_argnames=("act_quant", "out_dtype",
                                             "precision", "fused"))
def _mmq(w, b, *, act_quant, out_dtype, precision, fused):
    if act_quant:
        b = fake_quantize_q8_1(b)
    if fused:
        out = mmq_kernel(w, b)
    else:
        out = mmq_xla(w, b, precision=precision)
    if act_quant and w.fmt in ("q4_1", "q5_1"):
        out = out + _q8_1_sum_rounding(w, b)
    return out.astype(out_dtype)


def _q8_1_sum_rounding(w: QuantTensor, b: jax.Array) -> jax.Array:
    """The contract's min term for the affine legacy formats (x = d*q + m
    per 32-block): the reference multiplies m by the Q8_1 `s` field, the
    block sum of the quantized activation rounded to fp16. The plain
    product uses the exact sum; this adds the difference (N, M)."""
    n, k = b.shape
    bsum = jnp.sum(b.reshape(n, k // 32, 32), axis=-1)
    m32 = fp16_bits_to_f32(w.dmin_bits)                       # (K/32, M)
    return jax.lax.dot_general(
        fp16_round(bsum) - bsum, m32, (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST)


def _named(fmt: str):
    def fn(w: QuantTensor, b: jax.Array, **kw) -> jax.Array:
        assert w.fmt == fmt, (w.fmt, fmt)
        return mmq(w, b, **kw)

    fn.__name__ = fn.__qualname__ = f"mmq_{fmt}"
    fn.__doc__ = f"`mmq` for {fmt} weights."
    return fn


MMQ = {fmt: _named(fmt) for fmt in FORMATS}
