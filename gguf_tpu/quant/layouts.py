"""Device layouts: GGUF block bytes <-> structure-of-arrays (SoA).

At load time each quantized matrix is transformed from 144-byte interleaved
block structs into aligned, homogeneous per-field arrays. Bit
fidelity is preserved exactly (same 4/6-bit codes, same fp16 scale bits); only
the arrangement changes. The CPU goldens keep operating on the original GGUF
bytes, and these transforms are round-trip tested against them.

Nibble repacking is chosen so an unpack is concat-friendly: within every
256-element superblock, packed byte j (j<128)
holds element j in the low nibble and element j+128 in the high nibble, so
`concat([v & 0xF, v >> 4], axis=-1)` yields elements in order. (The GGUF
on-disk nibble order interleaves per 64-element group instead —
/root/reference/kernels/mmq_q4_k.py:91-99 documents the CUDA-oriented
layout we are replacing.)

All arrays are stored K-MAJOR (transposed, K-ish dim first, M last): M
(output features) is the only dimension that is always large — per-block
scale arrays have K/32 or K/256 rows. K-major also puts the dot in natural
(N, K) x (K, M) orientation with zero transposes. Whether the GPU kernels
should read the GGUF blocks as stored instead is an open design question
(ROADMAP.md).

Per-format fields (M x K logical matrix, SB = K/256 superblocks per row):

  q8_0: d_bits (K/32, M) u16 | qs (K, M) i8
  q4_k: d_bits, dmin_bits (SB, M) u16 | sc, mn (SB*8, M) u8 | qs (K/2, M) u8
  q6_k: d_bits (SB, M) u16 | sc (SB*16, M) i8 | ql (K/2, M) u8, packed like
        q4_k's qs | qh (K/4, M) u8: byte j (j<64) of a superblock holds the
        high-2-bits of elements j, j+64, j+128, j+192 at bits 0, 2, 4, 6.
  q2_k: d_bits, dmin_bits (SB, M) u16 | sc, mn (SB*16, M) u8 | qs (K/4, M)
        u8: byte j (j<64) of a superblock holds the 2-bit codes of elements
        j, j+64, j+128, j+192 at bits 0, 2, 4, 6.
  q3_k: d_bits (SB, M) u16 | sc (SB*16, M) i8 (the -32 offset applied at
        load) | qs (K/4, M) u8, packed like q2_k's qs (low 2 bits of the
        +4-offset code in [0, 8)) | qh (K/8, M) u8: byte j (j<32) of a
        superblock holds the third code bit of elements {32b + j} at bit b
        (same shape as q5_k's qh).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .q4_k import unpack_scale_min, pack_scale_min
from .q5_k import pack_q5_k_codes
from .q8_0 import BLOCK_BYTES as Q8_0_BYTES
from .q2_k import BLOCK_BYTES as Q2K_BYTES
from .q3_k import BLOCK_BYTES as Q3K_BYTES
from .q4_k import BLOCK_BYTES as Q4K_BYTES
from .q5_k import BLOCK_BYTES as Q5K_BYTES
from .q6_k import BLOCK_BYTES as Q6K_BYTES

QK_K = 256


@partial(jax.tree_util.register_dataclass,
         data_fields=["d_bits", "dmin_bits", "sc", "mn", "qs", "ql", "qh"],
         meta_fields=["fmt", "q8_plane"])
@dataclass
class QuantTensor:
    """A quantized (M, K) matrix in SoA device layout (a JAX pytree).

    The logical shape is DERIVED from the array shapes, so sliced or
    shard_map-local views automatically report their local (M, K).

    q8_plane records whether a q8_0 tensor's qs rows are in PLANE order
    (see q8_0_to_soa). It must be a stored flag, not a shape rule: the
    loader zero-pads K for MoE/tp alignment (loader._pad_k_to), which can
    give an element-order tensor a plane-eligible padded K. Meta fields
    survive every tree_map (pad/slice/stack), so the flag follows views."""

    fmt: str   # q8_0 | q2_k | q3_k | q4_k | q5_k | q6_k | q4_0 | q4_1 | q5_0 | q5_1 | iq4_nl | iq4_xs
    d_bits: jax.Array           # fp16 scale bits, u16
    dmin_bits: Optional[jax.Array] = None
    sc: Optional[jax.Array] = None
    mn: Optional[jax.Array] = None
    qs: Optional[jax.Array] = None
    ql: Optional[jax.Array] = None
    qh: Optional[jax.Array] = None
    q8_plane: bool = False

    @property
    def shape(self) -> tuple:
        """Logical (M, K), derived from the K-major arrays."""
        if self.fmt == "q8_0":
            return (self.qs.shape[1], self.qs.shape[0])
        if self.fmt in ("q2_k", "q3_k"):      # 4 codes per packed byte
            return (self.qs.shape[1], self.qs.shape[0] * 4)
        codes = self.ql if self.fmt == "q6_k" else self.qs
        return (codes.shape[1], codes.shape[0] * 2)

    @property
    def lanes(self) -> int:
        """STORED output width (M incl. any loader padding) — the last axis
        of every field."""
        codes = self.ql if self.fmt == "q6_k" else self.qs
        return codes.shape[-1]

    def dequantize(self) -> jax.Array:
        """Pure-jnp dequantize to float32 (M, K); jit/shard_map friendly."""
        return _DEQUANT[self.fmt](self)

    def take_rows(self, ids: jax.Array) -> "QuantTensor":
        """Select logical rows (M dim) — a lane gather in the K-major layout.
        Used for embedding lookups from a quantized token_embd table."""
        return jax.tree_util.tree_map(lambda a: a[:, ids], self)

    def packed_bytes_per_row(self) -> int:
        m, k = self.shape
        per_block = {"q8_0": (32, Q8_0_BYTES), "q2_k": (QK_K, Q2K_BYTES),
                     "q3_k": (QK_K, Q3K_BYTES), "q4_k": (QK_K, Q4K_BYTES),
                     "q5_k": (QK_K, Q5K_BYTES), "q6_k": (QK_K, Q6K_BYTES),
                     "q4_0": (32, 18), "q4_1": (32, 20),
                     "q5_0": (32, 22), "q5_1": (32, 24),
                     "iq4_nl": (32, 18), "iq4_xs": (QK_K, 136)}[self.fmt]
        return k // per_block[0] * per_block[1]


def stack_experts(tensors: list) -> "QuantTensor":
    """Stack per-expert quantized matrices along a NEW leading expert axis.

    Every SoA field becomes (E, *field_shape) — a single array per field so
    expert parallelism can shard the expert dim with one P("ep", ...) spec
    (a list of per-expert leaves could not be split across a mesh axis).
    The result is an opaque pytree: its 2-D `shape`/`dequantize` contract
    does not apply; slice an expert back out with `take_expert` first."""
    first = tensors[0]
    assert all(t.fmt == first.fmt for t in tensors), [t.fmt for t in tensors]
    assert all(t.shape == first.shape for t in tensors), \
        [t.shape for t in tensors]
    return jax.tree_util.tree_map(
        lambda *arrs: jnp.stack(arrs, axis=0), *tensors)


def take_expert(stacked: "QuantTensor", e: int) -> "QuantTensor":
    """Slice expert `e` out of a stack_experts tensor -> ordinary 2-D
    QuantTensor (static index; inside jit this is a fused slice, not a
    copy)."""
    return jax.tree_util.tree_map(lambda a: a[e], stacked)


def concat_m(tensors: list) -> "QuantTensor":
    """Concatenate quantized matrices along M (output features). In the
    K-major SoA layout every field carries M on its LAST axis, so this is a
    single lane-axis concat per field — the basis for fused QKV / gate+up
    projections (one kernel launch instead of three). Requires same format
    and same K."""
    first = tensors[0]
    assert all(t.fmt == first.fmt for t in tensors), [t.fmt for t in tensors]
    assert all(t.shape[1] == first.shape[1] for t in tensors), \
        [t.shape for t in tensors]
    return jax.tree_util.tree_map(
        lambda *arrs: jnp.concatenate(arrs, axis=-1), *tensors)


# ------------------------------------------------------------------ fp16 ---

def fp16_bits_to_f32(bits: jax.Array) -> jax.Array:
    """Exact fp16(bits) -> float32, expressed in integer ops so it runs both
    under jit and inside Pallas kernels (where f16 compute support is not
    guaranteed). Handles normals, denormals, zero, inf and NaN; matches the
    IEEE widening conversion bit for bit."""
    h = bits.astype(jnp.uint32)
    w = h << 16
    sign = w & jnp.uint32(0x80000000)
    two_w = w + w
    # normal/overflow path: rebias exponent via float multiply
    norm_bits = (two_w >> 4) + (jnp.uint32(0xE0) << 23)
    norm = jax.lax.bitcast_convert_type(norm_bits, jnp.float32) * jnp.float32(2.0**-112)
    # denormal path: splice mantissa next to 0.5 and subtract it
    den_bits = (two_w >> 17) | (jnp.uint32(126) << 23)
    den = jax.lax.bitcast_convert_type(den_bits, jnp.float32) - jnp.float32(0.5)
    out_bits = sign | jnp.where(
        two_w < jnp.uint32(1 << 27),
        jax.lax.bitcast_convert_type(den, jnp.uint32),
        jax.lax.bitcast_convert_type(norm, jnp.uint32),
    )
    return jax.lax.bitcast_convert_type(out_bits, jnp.float32)


def f32_to_fp16_bits(x: jax.Array) -> jax.Array:
    """Exact float32 -> fp16(bits) with IEEE round-to-nearest-even, in pure
    integer ops (Giesen's float_to_half_fast3_rtne). Needed because XLA elides
    lossy f32->f16->f32 convert pairs under jit, so `x.astype(f16)` is NOT a
    reliable rounding point; this is, and it matches numpy bit for bit
    including denormals, inf and NaN."""
    f = jax.lax.bitcast_convert_type(x.astype(jnp.float32), jnp.uint32)
    sign = f & jnp.uint32(0x80000000)
    f = f ^ sign

    f32_infty = jnp.uint32(255 << 23)
    f16_max = jnp.uint32((127 + 16) << 23)
    denorm_magic_bits = jnp.uint32(126 << 23)  # the bits of 0.5f
    # written as the float literal, not a bitcast of the scalar constant
    denorm_magic = jnp.float32(0.5)

    # large: inf (0x7C00) or NaN (0x7E00)
    big = jnp.where(f > f32_infty, jnp.uint32(0x7E00), jnp.uint32(0x7C00))

    # subnormal f16: float add against 0.5 positions+rounds the bits (RNE)
    den_f = jax.lax.bitcast_convert_type(f, jnp.float32) + denorm_magic
    den = jax.lax.bitcast_convert_type(den_f, jnp.uint32) - denorm_magic_bits

    # normal: rebias exponent, RNE on the dropped 13 mantissa bits
    mant_odd = (f >> 13) & jnp.uint32(1)
    # ((u32)(15 - 127)) << 23 wraps to 0xC8000000 in two's complement
    norm = (f + jnp.uint32(0xC8000000) + jnp.uint32(0xFFF) + mant_odd) >> 13

    small = jnp.where(f < jnp.uint32(113 << 23), den, norm & jnp.uint32(0xFFFF))
    out = jnp.where(f >= f16_max, big, small)
    return (out | (sign >> 16)).astype(jnp.uint16)


def fp16_round(x: jax.Array) -> jax.Array:
    """Round f32 to the nearest fp16 value, returned as f32 — a jit-proof
    fp16 rounding point (see f32_to_fp16_bits)."""
    return fp16_bits_to_f32(f32_to_fp16_bits(x))


# -------------------------------------------------------- bytes -> SoA ---


# Q8_0 "plane" packing (chosen at load when k % 256 == 0, RECORDED in
# QuantTensor.q8_plane): within each 256-row group, row r holds element
# (r % 8)*32 + r // 8 — every row's 32-block id is (row % 8), so a
# per-32-block scale multiply is a tiled pattern. K not divisible by 256
# (the reference's K=32..128 sweep) keeps element order.
_Q8_PLANE_ELEM = ((np.arange(256) % 8) * 32 + np.arange(256) // 8)
_Q8_PLANE_INV = np.argsort(_Q8_PLANE_ELEM)


def q8_0_plane(k: int) -> bool:
    return k % 256 == 0


def q8_0_unplane(t: "QuantTensor") -> "QuantTensor":
    """Repack a plane-order q8_0 tensor (or stacked expert tensor) back to
    element order. Host-side, used by the tp shard path when a K shard
    would not land on a 256-row plane-group boundary — plane groups are
    only self-contained at 256-row granularity."""
    import dataclasses

    if not t.q8_plane:
        return t
    qs = np.asarray(t.qs)                        # (..., K, M)
    kk, m = qs.shape[-2], qs.shape[-1]
    qs = qs.reshape(*qs.shape[:-2], kk // 256, 256, m)[..., _Q8_PLANE_INV, :]
    return dataclasses.replace(
        t, qs=jnp.asarray(qs.reshape(*qs.shape[:-3], kk, m)),
        q8_plane=False)


def q8_0_to_soa(qbytes: np.ndarray, m: int, k: int) -> QuantTensor:
    b = np.asarray(qbytes).reshape(-1).view(np.uint8)
    blocks = b.reshape(m * (k // 32), Q8_0_BYTES)
    d_bits = blocks[:, :2].copy().view(np.uint16).reshape(m, k // 32)
    qs = blocks[:, 2:].view(np.int8).reshape(m, k)
    if q8_0_plane(k):
        qs = qs.reshape(m, k // 256, 256)[:, :, _Q8_PLANE_ELEM].reshape(m, k)
    return QuantTensor(fmt="q8_0", q8_plane=q8_0_plane(k),
                       d_bits=jnp.asarray(np.ascontiguousarray(d_bits.T)),
                       qs=jnp.asarray(np.ascontiguousarray(qs.T)))


def soa_to_q8_0(t: QuantTensor) -> np.ndarray:
    m, k = t.shape
    d_bits = np.ascontiguousarray(np.asarray(t.d_bits).T.reshape(-1))
    qs = np.ascontiguousarray(np.asarray(t.qs).T)
    if t.q8_plane:
        qs = qs.reshape(m, k // 256, 256)[:, :, _Q8_PLANE_INV].reshape(m, k)
    qs = np.ascontiguousarray(qs.reshape(-1, 32))
    out = np.empty((d_bits.size, Q8_0_BYTES), dtype=np.uint8)
    out[:, :2] = d_bits.view(np.uint8).reshape(-1, 2)
    out[:, 2:] = qs.view(np.uint8)
    return out.reshape(-1)


def _repack_nibbles(codes: np.ndarray) -> np.ndarray:
    """(nb, 256) 4-bit codes -> (nb, 128) bytes: elem j | elem j+128 << 4."""
    lo = codes[:, :128].astype(np.uint8)
    hi = codes[:, 128:].astype(np.uint8)
    return lo | (hi << 4)


# Q4_K "plane" packing: byte row rb of a superblock packs the two elements
# (block g = rb % 8, positions p = rb // 8 and p + 16), so the kernel's
# fixed [lo(0:128); hi(128:256)] unpack lands rows whose 32-block id is
# (row % 8) for BOTH halves, so the per-32-block scale multiply is a
# tiled pattern. The matching activation-column permutation is one XLA
# transpose in the MMQ wrapper (ops/mmq.py:permute_acts_q4k: per
# superblock (g:8, h:2, p':16) -> (h, p', g)).
_Q4K_PLANE_LO = ((np.arange(128) % 8) * 32 + np.arange(128) // 8)


def _repack_nibbles_plane(codes: np.ndarray) -> np.ndarray:
    """(nb, 256) 4-bit codes -> (nb, 128) bytes in Q4_K plane order."""
    lo = codes[:, _Q4K_PLANE_LO].astype(np.uint8)
    hi = codes[:, _Q4K_PLANE_LO + 16].astype(np.uint8)
    return lo | (hi << 4)


def _unpack_nibbles_plane(packed: np.ndarray) -> np.ndarray:
    """(nb, 128) plane bytes -> (nb, 256) codes, inverting the above."""
    codes = np.empty((packed.shape[0], QK_K), np.uint8)
    codes[:, _Q4K_PLANE_LO] = packed & 0x0F
    codes[:, _Q4K_PLANE_LO + 16] = packed >> 4
    return codes


# Q6_K plane packing: 16 sub-blocks of 16 elements. ql byte row rb packs
# (block rb%16, positions rb//16 and +8); qh byte row rh packs the hi-2-bits
# of the elements landing at unpack rows {rh, 64+rh, 128+rh, 192+rh} at bit
# pairs 0/2/4/6 — the kernel's fixed [lo;hi] nibble unpack and 4-way crumb
# unpack then agree row-for-row, and every row's 16-block id is (row % 16),
# so the per-16 scale multiply is a tiled pattern per plane
# (ops/mmq.py:_q6_k_decode reads it as a (4, 16) grid of rows).
_Q6K_PLANE_LO = ((np.arange(128) % 16) * 16 + np.arange(128) // 16)
_Q6K_ROW = np.arange(256)
_Q6K_ELEM_AT_ROW = np.where(
    _Q6K_ROW < 128,
    (_Q6K_ROW % 16) * 16 + _Q6K_ROW // 16,
    (_Q6K_ROW % 16) * 16 + 8 + (_Q6K_ROW - 128) // 16)


def _repack_crumbs(codes: np.ndarray) -> np.ndarray:
    """(nb, 256) 2-bit codes -> (nb, 64) bytes: byte j holds elems j, j+64,
    j+128, j+192 at bits 0, 2, 4, 6 (concat of 4 shift/masks unpacks in
    element order)."""
    c = codes.reshape(-1, 4, 64).astype(np.uint8)
    out = np.zeros((c.shape[0], 64), np.uint8)
    for s in range(4):
        out |= (c[:, s, :] << (2 * s)).astype(np.uint8)
    return out


# Q2_K/Q3_K "plane" packing: the kernel's fixed 4-way crumb unpack (shift
# 2s, byte row j -> unpacked row u = s*64 + j) lands element
# (j % 16)*16 + s*4 + j//16, so every unpacked row's 16-block id is
# (row % 16) and the per-16 scale multiply is a tiled pattern per 64-row
# plane, as in the Q4_K/Q6_K plane layouts.
_Q23_PLANE_E = ((np.arange(64)[None, :] % 16) * 16
                + np.arange(4)[:, None] * 4
                + np.arange(64)[None, :] // 16)          # (4, 64): elem(s, j)

# Q3_K high-bit plane in the SAME element order: qh byte row r, bit b holds
# the high bit of the element at unpacked row u = b*32 + r of the 8-way
# 1-bit unpack (shift b, mask 1), which the crumb layout
# pins to element (r%16)*16 + (b//2)*4 + (b%2)*2 + r//16.
_Q3K_QH_E = ((np.arange(32)[None, :] % 16) * 16
             + (np.arange(8)[:, None] // 2) * 4
             + (np.arange(8)[:, None] % 2) * 2
             + np.arange(32)[None, :] // 16)             # (8, 32): elem(b, r)


def _repack_crumbs_plane(codes: np.ndarray) -> np.ndarray:
    """(nb, 256) 2-bit codes -> (nb, 64) bytes in q2/q3 plane order."""
    out = np.zeros((codes.shape[0], 64), np.uint8)
    for s in range(4):
        out |= (codes[:, _Q23_PLANE_E[s]] << (2 * s)).astype(np.uint8)
    return out


def _unpack_crumbs_plane(packed: np.ndarray) -> np.ndarray:
    """(nb, 64) plane bytes -> (nb, 256) codes, inverting the above."""
    codes = np.empty((packed.shape[0], QK_K), np.uint8)
    for s in range(4):
        codes[:, _Q23_PLANE_E[s]] = (packed >> (2 * s)) & 3
    return codes


def _repack_hmask_plane(hibit: np.ndarray) -> np.ndarray:
    """(nb, 256) 0/1 high bits -> (nb, 32) qh bytes in q3 plane order."""
    out = np.zeros((hibit.shape[0], 32), np.uint8)
    for b in range(8):
        out |= (hibit[:, _Q3K_QH_E[b]] << b).astype(np.uint8)
    return out


def _unpack_hmask_plane(qh: np.ndarray) -> np.ndarray:
    """(nb, 32) plane qh bytes -> (nb, 256) 0/1 high bits."""
    hibit = np.empty((qh.shape[0], QK_K), np.uint8)
    for b in range(8):
        hibit[:, _Q3K_QH_E[b]] = (qh >> b) & 1
    return hibit


def q2_k_to_soa(qbytes: np.ndarray, m: int, k: int) -> QuantTensor:
    from .q2_k import parse_q2_k_codes

    sb = k // QK_K
    b = np.asarray(qbytes).reshape(-1).view(np.uint8)
    blocks = b.reshape(m * sb, Q2K_BYTES)
    d_bits = blocks[:, 80:82].copy().view(np.uint16).reshape(m, sb)
    dmin_bits = blocks[:, 82:84].copy().view(np.uint16).reshape(m, sb)
    sc = blocks[:, :16] & 0x0F
    mn = blocks[:, :16] >> 4
    codes = parse_q2_k_codes(qbytes)               # (nb, 256) in [0, 4)
    qs = _repack_crumbs_plane(codes).reshape(m, k // 4)
    t = lambda a: jnp.asarray(np.ascontiguousarray(a.T))
    return QuantTensor(
        fmt="q2_k",
        d_bits=t(d_bits), dmin_bits=t(dmin_bits),
        sc=t(sc.reshape(m, sb * 16)), mn=t(mn.reshape(m, sb * 16)),
        qs=t(qs),
    )


def soa_to_q2_k(t: QuantTensor) -> np.ndarray:
    from .q2_k import pack_q2_k_codes

    m, k = t.shape
    sb = k // QK_K
    nb = m * sb
    packed = np.asarray(t.qs).T.reshape(nb, 64)
    codes = _unpack_crumbs_plane(packed)

    out = np.empty((nb, Q2K_BYTES), dtype=np.uint8)
    out[:, :16] = ((np.asarray(t.sc).T.reshape(nb, 16) & 0x0F)
                   | (np.asarray(t.mn).T.reshape(nb, 16) << 4))
    out[:, 16:80] = pack_q2_k_codes(codes)
    out[:, 80:82] = np.ascontiguousarray(np.asarray(t.d_bits).T).reshape(nb).view(np.uint8).reshape(nb, 2)
    out[:, 82:84] = np.ascontiguousarray(np.asarray(t.dmin_bits).T).reshape(nb).view(np.uint8).reshape(nb, 2)
    return out.reshape(-1)


def q3_k_to_soa(qbytes: np.ndarray, m: int, k: int) -> QuantTensor:
    """Q3_K SoA: signed per-16 scales (the -32 offset applied at load), the
    +4-offset codes in [0, 8) split into a q2_k-style 2-bit plane (qs) and a
    q5_k-style high-bit plane (qh — the on-disk hmask already has exactly
    that shape)."""
    from .q3_k import parse_q3_k_codes, unpack_q3_k_scales

    sb = k // QK_K
    b = np.asarray(qbytes).reshape(-1).view(np.uint8)
    blocks = b.reshape(m * sb, Q3K_BYTES)
    d_bits = blocks[:, 108:110].copy().view(np.uint16).reshape(m, sb)
    sc = unpack_q3_k_scales(blocks[:, 96:108]).astype(np.int8)  # [-32, 32)
    codes = parse_q3_k_codes(qbytes)               # (nb, 256) signed [-4, 4)
    full = (codes.astype(np.int16) + 4).astype(np.uint8)        # [0, 8)
    qs = _repack_crumbs_plane(full & 3).reshape(m, k // 4)
    qh = _repack_hmask_plane(full >> 2).reshape(m, k // 8)
    t = lambda a: jnp.asarray(np.ascontiguousarray(a.T))
    return QuantTensor(
        fmt="q3_k",
        d_bits=t(d_bits),
        sc=t(sc.reshape(m, sb * 16)),
        qs=t(qs), qh=t(qh),
    )


def soa_to_q3_k(t: QuantTensor) -> np.ndarray:
    from .q3_k import pack_q3_k_scales

    m, k = t.shape
    sb = k // QK_K
    nb = m * sb
    packed = np.asarray(t.qs).T.reshape(nb, 64)
    low2 = _unpack_crumbs_plane(packed)
    hibit = _unpack_hmask_plane(np.asarray(t.qh).T.reshape(nb, 32))

    out = np.empty((nb, Q3K_BYTES), dtype=np.uint8)
    # disk hmask: byte r bit b = high bit of element b*32 + r
    out[:, 0:32] = _repack_bitplanes_disk(hibit)
    out[:, 32:96] = _disk_pack_q3_qs(low2)
    out[:, 96:108] = pack_q3_k_scales(np.asarray(t.sc).T.reshape(nb, 16))
    out[:, 108:110] = np.ascontiguousarray(np.asarray(t.d_bits).T).reshape(nb).view(np.uint8).reshape(nb, 2)
    return out.reshape(-1)


def _repack_bitplanes_disk(hibit: np.ndarray) -> np.ndarray:
    """(nb, 256) 0/1 bits -> (nb, 32) disk hmask: byte r bit b = elem
    b*32 + r (llama.cpp's q3_k hmask layout)."""
    c = hibit.reshape(-1, 8, 32)
    out = np.zeros((c.shape[0], 32), np.uint8)
    for b in range(8):
        out |= (c[:, b, :] << b).astype(np.uint8)
    return out


def _disk_pack_q3_qs(low2: np.ndarray) -> np.ndarray:
    """(nb, 256) low-2-bit planes -> on-disk qs (nb, 64): per 128-half h,
    byte 32h+l = elems 128h+l, +32, +64, +96 at bits 0, 2, 4, 6."""
    nb = low2.shape[0]
    c = low2.reshape(nb, 2, 4, 32)
    qs = np.zeros((nb, 2, 32), np.uint8)
    for s in range(4):
        qs |= (c[:, :, s, :] << (2 * s)).astype(np.uint8)
    return qs.reshape(nb, 64)


def q4_k_to_soa(qbytes: np.ndarray, m: int, k: int) -> QuantTensor:
    sb = k // QK_K
    b = np.asarray(qbytes).reshape(-1).view(np.uint8)
    blocks = b.reshape(m * sb, Q4K_BYTES)
    d_bits = blocks[:, 0:2].copy().view(np.uint16).reshape(m, sb)
    dmin_bits = blocks[:, 2:4].copy().view(np.uint16).reshape(m, sb)
    sc, mn = unpack_scale_min(blocks[:, 4:16])
    # on-disk nibble order: per 64-group g, byte 32g+l = elem 64g+l | 64g+32+l<<4
    qv = blocks[:, 16:].reshape(-1, 4, 32)
    codes = np.stack([qv & 0x0F, qv >> 4], axis=2).reshape(-1, QK_K)
    qs = _repack_nibbles_plane(codes).reshape(m, k // 2)
    t = lambda a: jnp.asarray(np.ascontiguousarray(a.T))
    return QuantTensor(
        fmt="q4_k",
        d_bits=t(d_bits), dmin_bits=t(dmin_bits),
        sc=t(sc.reshape(m, sb * 8)), mn=t(mn.reshape(m, sb * 8)),
        qs=t(qs),
    )


def soa_to_q4_k(t: QuantTensor) -> np.ndarray:
    m, k = t.shape
    sb = k // QK_K
    nb = m * sb
    packed = np.asarray(t.qs).T.reshape(nb, 128)
    codes = _unpack_nibbles_plane(packed)
    qv = codes.reshape(nb, 4, 2, 32)  # invert the stack in q4_k_to_soa
    disk_qs = (qv[:, :, 0, :] | (qv[:, :, 1, :] << 4)).reshape(nb, 128)

    out = np.empty((nb, Q4K_BYTES), dtype=np.uint8)
    out[:, 0:2] = np.ascontiguousarray(np.asarray(t.d_bits).T).reshape(nb).view(np.uint8).reshape(nb, 2)
    out[:, 2:4] = np.ascontiguousarray(np.asarray(t.dmin_bits).T).reshape(nb).view(np.uint8).reshape(nb, 2)
    out[:, 4:16] = pack_scale_min(
        np.asarray(t.sc).T.reshape(nb, 8), np.asarray(t.mn).T.reshape(nb, 8))
    out[:, 16:] = disk_qs
    return out.reshape(-1)


def q5_k_to_soa(qbytes: np.ndarray, m: int, k: int) -> QuantTensor:
    """Q5_K SoA: like q4_k (d/dmin/sc/mn + nibble-repacked qs) plus qh
    (K/8, M): byte row j of a superblock (j<32) holds the 5th bit of elems
    {32b + j} at bit position b (whole-tile shift/mask unpack lands in
    element order — see ops/mmq_q5_k.py)."""
    from .q5_k import parse_q5_k_codes

    sb = k // QK_K
    b = np.asarray(qbytes).reshape(-1).view(np.uint8)
    blocks = b.reshape(m * sb, Q5K_BYTES)
    d_bits = blocks[:, 0:2].copy().view(np.uint16).reshape(m, sb)
    dmin_bits = blocks[:, 2:4].copy().view(np.uint16).reshape(m, sb)
    sc, mn = unpack_scale_min(blocks[:, 4:16])
    codes = parse_q5_k_codes(qbytes)               # (nb, 256) in [0, 32)
    qs = _repack_nibbles_plane(codes & 0x0F).reshape(m, k // 2)
    # 5th bit in the same plane-row order as the nibbles: the kernel's
    # 8-way bitplane unpack (row b*32 + rh) must agree row-for-row with
    # the [lo; hi] nibble unpack
    elem_at_row = np.concatenate([_Q4K_PLANE_LO, _Q4K_PLANE_LO + 16])
    hib = (codes >> 4).astype(np.uint8)[:, elem_at_row]   # plane-row order
    g = hib.reshape(-1, 8, 32)                     # [plane b, rh]
    qh = np.zeros((g.shape[0], 32), np.uint8)
    for bb in range(8):
        qh |= (g[:, bb, :] << bb).astype(np.uint8)
    t = lambda a: jnp.asarray(np.ascontiguousarray(a.T))
    return QuantTensor(
        fmt="q5_k",
        d_bits=t(d_bits), dmin_bits=t(dmin_bits),
        sc=t(sc.reshape(m, sb * 8)), mn=t(mn.reshape(m, sb * 8)),
        qs=t(qs), qh=t(qh.reshape(m, k // 8)),
    )


def soa_to_q5_k(t: QuantTensor) -> np.ndarray:
    m, k = t.shape
    sb = k // QK_K
    nb = m * sb
    packed = np.asarray(t.qs).T.reshape(nb, 128)
    low = _unpack_nibbles_plane(packed)            # element order
    qh_rows = np.asarray(t.qh).T.reshape(nb, 32)
    hib_rows = np.empty((nb, QK_K), dtype=np.uint8)
    for bb in range(8):
        hib_rows[:, 32 * bb:32 * (bb + 1)] = (qh_rows >> bb) & 1
    elem_at_row = np.concatenate([_Q4K_PLANE_LO, _Q4K_PLANE_LO + 16])
    hib = np.empty_like(hib_rows)
    hib[:, elem_at_row] = hib_rows                 # back to element order
    codes = low | (hib << 4)
    disk_qh, disk_qs = pack_q5_k_codes(codes)

    out = np.empty((nb, Q5K_BYTES), dtype=np.uint8)
    out[:, 0:2] = np.ascontiguousarray(np.asarray(t.d_bits).T).reshape(nb).view(np.uint8).reshape(nb, 2)
    out[:, 2:4] = np.ascontiguousarray(np.asarray(t.dmin_bits).T).reshape(nb).view(np.uint8).reshape(nb, 2)
    out[:, 4:16] = pack_scale_min(
        np.asarray(t.sc).T.reshape(nb, 8), np.asarray(t.mn).T.reshape(nb, 8))
    out[:, 16:48] = disk_qh
    out[:, 48:] = disk_qs
    return out.reshape(-1)


def q6_k_to_soa(qbytes: np.ndarray, m: int, k: int) -> QuantTensor:
    from .q6_k import parse_q6_k

    sb = k // QK_K
    b = np.asarray(qbytes).reshape(-1).view(np.uint8)
    blocks = b.reshape(m * sb, Q6K_BYTES)
    d_bits = blocks[:, 208:210].copy().view(np.uint16).reshape(m, sb)
    _, scales, q = parse_q6_k(qbytes)  # q: (nb, 256) int8, offset -32 applied
    codes = (q.astype(np.int16) + 32).astype(np.uint8)  # back to [0, 64)
    lo = (codes[:, _Q6K_PLANE_LO] & 0x0F)
    hi = (codes[:, _Q6K_PLANE_LO + 8] & 0x0F)
    ql = (lo | (hi << 4)).reshape(m, k // 2)
    h = (codes[:, _Q6K_ELEM_AT_ROW] >> 4)   # (nb, 256) plane-row order
    qh = (h[:, 0:64] | (h[:, 64:128] << 2) | (h[:, 128:192] << 4)
          | (h[:, 192:256] << 6)).astype(np.uint8).reshape(m, k // 4)
    t = lambda a: jnp.asarray(np.ascontiguousarray(a.T))
    return QuantTensor(
        fmt="q6_k",
        d_bits=t(d_bits),
        sc=t(scales.reshape(m, sb * 16)),
        ql=t(ql), qh=t(qh),
    )


def soa_to_q6_k(t: QuantTensor) -> np.ndarray:
    m, k = t.shape
    sb = k // QK_K
    nb = m * sb
    pl_ = np.asarray(t.ql).T.reshape(nb, 128)
    ph = np.asarray(t.qh).T.reshape(nb, 64)
    low4 = np.concatenate([pl_ & 0x0F, pl_ >> 4], axis=1)  # (nb, 256) rows
    shifts = np.array([0, 2, 4, 6], dtype=np.uint8)
    hi2 = np.concatenate([(ph >> s) & 0x03 for s in shifts], axis=1)
    code_rows = low4 | (hi2 << 4)            # plane-row order
    codes = np.empty_like(code_rows)
    codes[:, _Q6K_ELEM_AT_ROW] = code_rows   # back to element order

    out = np.empty((nb, Q6K_BYTES), dtype=np.uint8)
    # GGUF on-disk packing, per 128-element half (see quant/q6_k.py docstring)
    ch = codes.reshape(nb, 2, 4, 32)  # (half, 32-slot, lane)
    out_ql = out[:, :128].reshape(nb, 2, 2, 32)
    out_ql[:, :, 0, :] = (ch[:, :, 0, :] & 0xF) | ((ch[:, :, 2, :] & 0xF) << 4)
    out_ql[:, :, 1, :] = (ch[:, :, 1, :] & 0xF) | ((ch[:, :, 3, :] & 0xF) << 4)
    out_qh = out[:, 128:192].reshape(nb, 2, 32)
    out_qh[:] = ((ch[:, :, 0, :] >> 4) | ((ch[:, :, 1, :] >> 4) << 2)
                 | ((ch[:, :, 2, :] >> 4) << 4) | ((ch[:, :, 3, :] >> 4) << 6))
    out[:, 192:208] = np.ascontiguousarray(np.asarray(t.sc).T).reshape(nb, 16).view(np.uint8)
    out[:, 208:210] = np.ascontiguousarray(np.asarray(t.d_bits).T).reshape(nb).view(np.uint8).reshape(nb, 2)
    return out.reshape(-1)


# ------------------------------------------------- legacy 32-block formats ---


def _legacy_codes_to_device(codes: np.ndarray, m: int, k: int,
                            five_bit: bool):
    """(m*k//32, 32) element-order codes -> (qs (k/2, m) nibble-repacked per
    256-group, qh (k/8, m) q5_k-style 5th bits or None). Legacy formats have
    no 256 superblock on disk, but the device layout adopts the K-quants'
    256-group repacking so the kernels reuse the same whole-tile unpacks."""
    full = codes.reshape(m, k).reshape(-1, QK_K)           # (m*k/256, 256)
    qs = _repack_nibbles(full & 0x0F).reshape(m, k // 2)
    if not five_bit:
        return qs, None
    hib = (full >> 4).astype(np.uint8).reshape(-1, 8, 32)
    qh = np.zeros((hib.shape[0], 32), np.uint8)
    for bb in range(8):
        qh |= (hib[:, bb, :] << bb).astype(np.uint8)
    return qs, qh.reshape(m, k // 8)


def _legacy_codes_from_device(t: QuantTensor, five_bit: bool) -> np.ndarray:
    """Inverse of _legacy_codes_to_device -> (m*k//32, 32) codes."""
    m, k = t.shape
    packed = np.asarray(t.qs).T.reshape(-1, 128)           # per 256-group
    codes = np.concatenate([packed & 0x0F, packed >> 4], axis=1)  # (ng, 256)
    if five_bit:
        qh = np.asarray(t.qh).T.reshape(-1, 32)
        hib = np.stack([(qh >> bb) & 1 for bb in range(8)], axis=1)
        codes = codes | (hib.reshape(-1, QK_K) << 4)
    return codes.reshape(m * (k // 32), 32).astype(np.uint8)


def _legacy_to_soa(fmt: str):
    from . import legacy as _lg

    parse = {"q4_0": _lg.parse_q4_0, "q4_1": _lg.parse_q4_1,
             "q5_0": _lg.parse_q5_0, "q5_1": _lg.parse_q5_1}[fmt]
    affine = fmt.endswith("_1")

    def fn(qbytes: np.ndarray, m: int, k: int) -> QuantTensor:
        assert k % QK_K == 0, (
            f"{fmt} device layout groups K in {QK_K}s (loader pads), got {k}")
        parsed = parse(qbytes)
        t = lambda a: jnp.asarray(np.ascontiguousarray(a.T))
        raw = np.asarray(qbytes).reshape(-1).view(np.uint8).reshape(
            m * (k // 32), _lg.BLOCK_BYTES[fmt])
        d_bits = raw[:, 0:2].copy().view(np.uint16).reshape(m, k // 32)
        dmin_bits = (t(raw[:, 2:4].copy().view(np.uint16).reshape(m, k // 32))
                     if affine else None)
        codes = parsed[-1]              # (m*k//32, 32), 4- or 5-bit
        qs, qh = _legacy_codes_to_device(codes, m, k, fmt.startswith("q5"))
        return QuantTensor(fmt=fmt, d_bits=t(d_bits), dmin_bits=dmin_bits,
                           qs=t(qs), qh=t(qh) if qh is not None else None)

    return fn


def _legacy_from_soa(fmt: str):
    from . import legacy as _lg

    affine = fmt.endswith("_1")
    five = fmt.startswith("q5")

    def fn(t: QuantTensor) -> np.ndarray:
        m, k = t.shape
        nb = m * (k // 32)
        codes = _legacy_codes_from_device(t, five)
        bb = _lg.BLOCK_BYTES[fmt]
        out = np.empty((nb, bb), np.uint8)
        out[:, 0:2] = np.ascontiguousarray(
            np.asarray(t.d_bits).T).reshape(nb).view(np.uint8).reshape(nb, 2)
        o = 2
        if affine:
            out[:, 2:4] = np.ascontiguousarray(
                np.asarray(t.dmin_bits).T).reshape(nb).view(np.uint8).reshape(nb, 2)
            o = 4
        if five:
            out[:, o:o + 4] = _lg._pack_qh(codes >> 4)
            o += 4
        out[:, o:] = _lg._pack_nibbles(codes)
        return out.reshape(-1)

    return fn


# --------------------------------------------- IQ4 codebook formats ---


def iq4_nl_to_soa(qbytes: np.ndarray, m: int, k: int) -> QuantTensor:
    """IQ4_NL: d_bits (K/32, M) u16 | qs (K/2, M) nibble-repacked table
    indices (per-256-group, same repack as the legacy 32-block formats)."""
    from . import iq4 as _iq

    assert k % QK_K == 0, (
        f"iq4_nl device layout groups K in {QK_K}s (loader pads), got {k}")
    raw = np.asarray(qbytes).reshape(-1).view(np.uint8).reshape(
        m * (k // 32), _iq.BLOCK_BYTES_NL)
    d_bits = raw[:, 0:2].copy().view(np.uint16).reshape(m, k // 32)
    _, codes = _iq.parse_iq4_nl(qbytes)
    qs, _ = _legacy_codes_to_device(codes, m, k, False)
    t = lambda a: jnp.asarray(np.ascontiguousarray(a.T))
    return QuantTensor(fmt="iq4_nl", d_bits=t(d_bits), qs=t(qs))


def soa_to_iq4_nl(t: QuantTensor) -> np.ndarray:
    from . import iq4 as _iq

    m, k = t.shape
    nb = m * (k // 32)
    codes = _legacy_codes_from_device(t, False)
    out = np.empty((nb, _iq.BLOCK_BYTES_NL), np.uint8)
    out[:, 0:2] = np.ascontiguousarray(
        np.asarray(t.d_bits).T).reshape(nb).view(np.uint8).reshape(nb, 2)
    out[:, 2:] = codes[:, :16] | (codes[:, 16:] << 4)
    return out.reshape(-1)


def iq4_xs_to_soa(qbytes: np.ndarray, m: int, k: int) -> QuantTensor:
    """IQ4_XS: d_bits (SB, M) u16 | sc (SB*8, M) i8 signed 6-bit scales
    (the -32 offset applied at load) | qs (K/2, M) repacked indices."""
    from . import iq4 as _iq

    assert k % QK_K == 0, f"iq4_xs needs K % {QK_K} == 0, got {k}"
    d, ls, codes = _iq.parse_iq4_xs(qbytes)
    sb = k // QK_K
    d_bits = np.asarray(qbytes).reshape(-1).view(np.uint8).reshape(
        m * sb, _iq.BLOCK_BYTES_XS)[:, 0:2].copy().view(np.uint16).reshape(m, sb)
    qs, _ = _legacy_codes_to_device(
        codes.reshape(m * sb * 8, 32), m, k, False)
    t = lambda a: jnp.asarray(np.ascontiguousarray(a.T))
    return QuantTensor(fmt="iq4_xs", d_bits=t(d_bits),
                       sc=t(ls.reshape(m, sb * 8)), qs=t(qs))


def soa_to_iq4_xs(t: QuantTensor) -> np.ndarray:
    from . import iq4 as _iq

    m, k = t.shape
    sb = k // QK_K
    ns = m * sb
    codes = _legacy_codes_from_device(t, False).reshape(ns, QK_K)
    ls = np.asarray(t.sc).T.reshape(ns, 8).astype(np.int16)
    lsu = (ls + 32).astype(np.uint16)
    out = np.empty((ns, _iq.BLOCK_BYTES_XS), np.uint8)
    out[:, 0:2] = np.ascontiguousarray(
        np.asarray(t.d_bits).T).reshape(ns).view(np.uint8).reshape(ns, 2)
    sh = np.zeros(ns, np.uint16)
    for ib in range(8):
        sh |= ((lsu[:, ib] >> 4) << (2 * ib)).astype(np.uint16)
    out[:, 2:4] = sh[:, None].view(np.uint8)
    lo = lsu & 0xF
    for i in range(4):
        out[:, 4 + i] = (lo[:, 2 * i] | (lo[:, 2 * i + 1] << 4)).astype(np.uint8)
    c = codes.reshape(ns, 8, 32)
    out[:, 8:] = (c[:, :, :16] | (c[:, :, 16:] << 4)).reshape(ns, 128)
    return out.reshape(-1)


TO_SOA = {"q8_0": q8_0_to_soa, "q2_k": q2_k_to_soa, "q3_k": q3_k_to_soa,
          "q4_k": q4_k_to_soa, "q5_k": q5_k_to_soa, "q6_k": q6_k_to_soa,
          "iq4_nl": iq4_nl_to_soa, "iq4_xs": iq4_xs_to_soa,
          **{f: _legacy_to_soa(f) for f in ("q4_0", "q4_1", "q5_0", "q5_1")}}
FROM_SOA = {"q8_0": soa_to_q8_0, "q2_k": soa_to_q2_k, "q3_k": soa_to_q3_k,
            "q4_k": soa_to_q4_k, "q5_k": soa_to_q5_k, "q6_k": soa_to_q6_k,
            "iq4_nl": soa_to_iq4_nl, "iq4_xs": soa_to_iq4_xs,
            **{f: _legacy_from_soa(f) for f in ("q4_0", "q4_1", "q5_0", "q5_1")}}


def to_soa(fmt: str, qbytes: np.ndarray, m: int, k: int,
           native: bool = True) -> QuantTensor:
    """GGUF block bytes -> SoA QuantTensor. The C core (csrc/gguf_soa.c)
    produces byte-identical arrays ~50x faster than the numpy transforms
    above (7B cold load: minutes -> seconds) and is parity-tested against
    them; native=False forces the numpy reference path."""
    if native and fmt in ("q8_0", "q2_k", "q3_k", "q4_k", "q5_k", "q6_k"):
        try:
            from .native import soa_arrays

            arrs = soa_arrays(fmt, qbytes, m, k)
            return QuantTensor(fmt=fmt,
                               q8_plane=(fmt == "q8_0" and q8_0_plane(k)),
                               **{f: jnp.asarray(a) for f, a in arrs.items()})
        except (OSError, ImportError):   # no toolchain: numpy fallback
            pass
    # legacy 32-block formats go through numpy: their repack is a single
    # nibble shuffle, cheap enough that the C fast path isn't needed
    return TO_SOA[fmt](qbytes, m, k)


def from_soa(t: QuantTensor) -> np.ndarray:
    return FROM_SOA[t.fmt](t)


# ------------------------------------------------------- jnp dequantize ---


def _expand_scales(s: jax.Array, factor: int) -> jax.Array:
    """(..., B) -> (..., B*factor) by repeating each column `factor` times."""
    return jnp.repeat(s, factor, axis=-1)


def _dequant_q8_0(t: QuantTensor) -> jax.Array:
    m, k = t.shape
    d = fp16_bits_to_f32(t.d_bits.T)                    # (M, K/32)
    qs = t.qs.T
    if t.q8_plane:   # invert the plane row order (see q8_0_to_soa)
        qs = qs.reshape(m, k // 256, 256)[:, :, jnp.asarray(_Q8_PLANE_INV)] \
               .reshape(m, k)
    return _expand_scales(d, 32) * qs.astype(jnp.float32)


def _unpack_nibbles_jnp(packed_t: jax.Array, sb: int) -> jax.Array:
    """(K/2, M) packed bytes -> (M, K) codes, inverting _repack_nibbles."""
    packed = packed_t.T
    m = packed.shape[0]
    v = packed.reshape(m, sb, 128)
    lo = v & jnp.uint8(0x0F)
    hi = v >> 4
    return jnp.concatenate([lo, hi], axis=-1).reshape(m, sb * QK_K)


def _dequant_q4_k(t: QuantTensor) -> jax.Array:
    m, k = t.shape
    sb = k // QK_K
    d = fp16_bits_to_f32(t.d_bits.T)                    # (M, SB)
    dmin = fp16_bits_to_f32(t.dmin_bits.T)
    scale32 = _expand_scales(d, 8) * t.sc.T.astype(jnp.float32)   # (M, SB*8)
    min32 = _expand_scales(dmin, 8) * t.mn.T.astype(jnp.float32)
    # invert the plane packing: row r of [lo;hi] holds element elem_of(r)
    elem_of = np.concatenate([_Q4K_PLANE_LO, _Q4K_PLANE_LO + 16])
    inv = np.argsort(elem_of)
    v = t.qs.T.reshape(m, sb, 128)
    planes = jnp.concatenate([v & jnp.uint8(0x0F), v >> 4], axis=-1)
    q = jnp.take(planes, jnp.asarray(inv), axis=-1).reshape(
        m, k).astype(jnp.float32)
    return _expand_scales(scale32, 32) * q - _expand_scales(min32, 32)


def _dequant_q5_k(t: QuantTensor) -> jax.Array:
    m, k = t.shape
    sb = k // QK_K
    d = fp16_bits_to_f32(t.d_bits.T)                    # (M, SB)
    dmin = fp16_bits_to_f32(t.dmin_bits.T)
    scale32 = _expand_scales(d, 8) * t.sc.T.astype(jnp.float32)
    min32 = _expand_scales(dmin, 8) * t.mn.T.astype(jnp.float32)
    v = t.qs.T.reshape(m, sb, 128)
    low4 = jnp.concatenate([v & jnp.uint8(0x0F), v >> 4], axis=-1)
    h = t.qh.T.reshape(m, sb, 32)
    hib = jnp.concatenate(
        [(h >> b) & jnp.uint8(1) for b in range(8)], axis=-1)
    rows = low4 | (hib << 4)                            # plane-row order
    elem_at_row = np.concatenate([_Q4K_PLANE_LO, _Q4K_PLANE_LO + 16])
    inv = np.argsort(elem_at_row)
    q = jnp.take(rows, jnp.asarray(inv), axis=-1).reshape(
        m, k).astype(jnp.float32)
    return _expand_scales(scale32, 32) * q - _expand_scales(min32, 32)


def _dequant_q6_k(t: QuantTensor) -> jax.Array:
    m, k = t.shape
    sb = k // QK_K
    d = fp16_bits_to_f32(t.d_bits.T)                    # (M, SB)
    scale16 = _expand_scales(d, 16) * t.sc.T.astype(jnp.float32)  # (M, SB*16)
    v = t.ql.T.reshape(m, sb, 128)
    low4 = jnp.concatenate([v & jnp.uint8(0x0F), v >> 4], axis=-1)
    h = t.qh.T.reshape(m, sb, 64)
    hi2 = jnp.concatenate(
        [(h >> s) & jnp.uint8(0x03) for s in (0, 2, 4, 6)], axis=-1)
    rows = (low4 | (hi2 << 4))                          # plane-row order
    inv = np.argsort(_Q6K_ELEM_AT_ROW)
    q = jnp.take(rows, jnp.asarray(inv), axis=-1).reshape(
        m, k).astype(jnp.int8) - jnp.int8(32)
    return _expand_scales(scale16, 16) * q.astype(jnp.float32)


def _unpack_crumbs_jnp(packed_t: jax.Array, sb: int) -> jax.Array:
    """(K/4, M) packed bytes -> (M, K) 2-bit codes, inverting _repack_crumbs."""
    packed = packed_t.T
    m = packed.shape[0]
    v = packed.reshape(m, sb, 64)
    parts = [(v >> (2 * s)) & jnp.uint8(3) for s in range(4)]
    return jnp.concatenate(parts, axis=-1).reshape(m, sb * QK_K)


def _dequant_q2_k(t: QuantTensor) -> jax.Array:
    m, k = t.shape
    sb = k // QK_K
    d = fp16_bits_to_f32(t.d_bits.T)                    # (M, SB)
    dmin = fp16_bits_to_f32(t.dmin_bits.T)
    scale16 = _expand_scales(d, 16) * t.sc.T.astype(jnp.float32)  # (M, SB*16)
    min16 = _expand_scales(dmin, 16) * t.mn.T.astype(jnp.float32)
    rows = _unpack_crumbs_jnp(t.qs, sb).reshape(m, sb, QK_K)  # plane rows
    inv = np.argsort(_Q23_PLANE_E.ravel())
    q = jnp.take(rows, jnp.asarray(inv), axis=-1).reshape(m, k) \
        .astype(jnp.float32)
    return _expand_scales(scale16, 16) * q - _expand_scales(min16, 16)


def _dequant_q3_k(t: QuantTensor) -> jax.Array:
    m, k = t.shape
    sb = k // QK_K
    d = fp16_bits_to_f32(t.d_bits.T)                    # (M, SB)
    scale16 = _expand_scales(d, 16) * t.sc.T.astype(jnp.float32)  # (M, SB*16)
    low2 = _unpack_crumbs_jnp(t.qs, sb)                 # (M, K) plane rows
    h = t.qh.T.reshape(m, sb, 32)
    hib = jnp.concatenate(
        [(h >> b) & jnp.uint8(1) for b in range(8)], axis=-1).reshape(m, k)
    # the crumb and qh plane layouts agree row-for-row (_Q3K_QH_E), so the
    # combine happens in plane-row order and one take restores element order
    rows = (low2 | (hib << 2)).reshape(m, sb, QK_K)
    inv = np.argsort(_Q23_PLANE_E.ravel())
    q = jnp.take(rows, jnp.asarray(inv), axis=-1).reshape(m, k) \
        .astype(jnp.int8) - jnp.int8(4)
    return _expand_scales(scale16, 16) * q.astype(jnp.float32)


def _dequant_legacy(t: QuantTensor) -> jax.Array:
    """Q4_0/Q4_1/Q5_0/Q5_1: per-32-block d (and fp16 min for the _1
    variants; fixed -8/-16 offset for the _0 variants)."""
    m, k = t.shape
    sb = k // QK_K
    d = fp16_bits_to_f32(t.d_bits.T)                    # (M, K/32)
    q = _unpack_nibbles_jnp(t.qs, sb)                   # (M, K) in [0,16)
    if t.fmt.startswith("q5"):
        h = t.qh.T.reshape(m, sb, 32)
        hib = jnp.concatenate(
            [(h >> b) & jnp.uint8(1) for b in range(8)], axis=-1).reshape(m, k)
        q = q | (hib << 4)
    q = q.astype(jnp.float32)
    scale = _expand_scales(d, 32)
    if t.fmt.endswith("_1"):
        mn = fp16_bits_to_f32(t.dmin_bits.T)
        return scale * q + _expand_scales(mn, 32)
    off = 8.0 if t.fmt == "q4_0" else 16.0
    return scale * (q - jnp.float32(off))


# IQ4 codebook packed into four i32 words (4 byte lanes each, little-endian)
# so the lookup is pure shift/mask vector ops instead of a 16-entry gather.
_IQ4_WORDS = None


def iq4_lookup(q: jax.Array) -> jax.Array:
    """Map i32 table indices in [0, 16) to the signed IQ4 codebook values
    (i32 in [-127, 113]). Runs on the VPU as ~9 int ops/elem; safe inside
    Pallas kernels and plain jit alike."""
    global _IQ4_WORDS
    if _IQ4_WORDS is None:
        from .iq4 import KVALUES

        kv = KVALUES.astype(np.int64) & 0xFF
        _IQ4_WORDS = tuple(
            int(kv[4 * i] | (kv[4 * i + 1] << 8) | (kv[4 * i + 2] << 16)
                | (kv[4 * i + 3] << 24)) for i in range(4))
    w = [jnp.int32(x - (1 << 32) if x >= (1 << 31) else x) for x in _IQ4_WORDS]
    shift = (q & 3) << 3
    hi = q >> 2
    word = jnp.where(hi == 0, w[0],
                     jnp.where(hi == 1, w[1],
                               jnp.where(hi == 2, w[2], w[3])))
    v = (word >> shift) & 0xFF
    return v - ((v & 0x80) << 1)                # sign-extend int8


def _dequant_iq4_nl(t: QuantTensor) -> jax.Array:
    m, k = t.shape
    d = fp16_bits_to_f32(t.d_bits.T)                    # (M, K/32)
    q = _unpack_nibbles_jnp(t.qs, k // QK_K).astype(jnp.int32)
    v = iq4_lookup(q).astype(jnp.float32)
    return _expand_scales(d, 32) * v


def _dequant_iq4_xs(t: QuantTensor) -> jax.Array:
    m, k = t.shape
    sb = k // QK_K
    d = fp16_bits_to_f32(t.d_bits.T)                    # (M, SB)
    scale32 = _expand_scales(d, 8) * t.sc.T.astype(jnp.float32)   # (M, SB*8)
    q = _unpack_nibbles_jnp(t.qs, sb).astype(jnp.int32)
    v = iq4_lookup(q).astype(jnp.float32)
    return _expand_scales(scale32, 32) * v


_DEQUANT = {"q8_0": _dequant_q8_0, "q2_k": _dequant_q2_k,
            "q3_k": _dequant_q3_k, "q4_k": _dequant_q4_k,
            "q5_k": _dequant_q5_k, "q6_k": _dequant_q6_k,
            "iq4_nl": _dequant_iq4_nl, "iq4_xs": _dequant_iq4_xs,
            **{f: _dequant_legacy for f in ("q4_0", "q4_1", "q5_0", "q5_1")}}


# ------------------------------------------------------------ quantize ---


def quantize_to_soa(x: np.ndarray, fmt: str) -> QuantTensor:
    """Quantize a float (M, K) matrix and return the device SoA layout."""
    from . import q4_k as _q4, q6_k as _q6, q8_0 as _q8

    x = np.asarray(x)
    m, k = x.shape
    if fmt == "q8_0":
        return q8_0_to_soa(_q8.quantize_q8_0(x.astype(np.float16)), m, k)
    if fmt == "q2_k":
        from . import q2_k as _q2
        return q2_k_to_soa(_q2.quantize_q2_k(x.astype(np.float32)), m, k)
    if fmt == "q3_k":
        from . import q3_k as _q3
        return q3_k_to_soa(_q3.quantize_q3_k(x.astype(np.float32)), m, k)
    if fmt == "q4_k":
        return q4_k_to_soa(_q4.quantize_q4_k(x.astype(np.float32)), m, k)
    if fmt == "q5_k":
        from . import q5_k as _q5
        return q5_k_to_soa(_q5.quantize_q5_k(x.astype(np.float32)), m, k)
    if fmt == "q6_k":
        return q6_k_to_soa(_q6.quantize_q6_k(x.astype(np.float32)), m, k)
    if fmt in ("q4_0", "q4_1", "q5_0", "q5_1"):
        from . import legacy as _lg
        quant = {"q4_0": _lg.quantize_q4_0, "q4_1": _lg.quantize_q4_1,
                 "q5_0": _lg.quantize_q5_0, "q5_1": _lg.quantize_q5_1}[fmt]
        return TO_SOA[fmt](quant(x.astype(np.float32)), m, k)
    if fmt in ("iq4_nl", "iq4_xs"):
        from . import iq4 as _iq
        quant = {"iq4_nl": _iq.quantize_iq4_nl,
                 "iq4_xs": _iq.quantize_iq4_xs}[fmt]
        return TO_SOA[fmt](quant(x.astype(np.float32)), m, k)
    raise ValueError(f"unknown format {fmt!r}")
