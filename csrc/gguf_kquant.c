/*
 * gguf_kquant.c — bit-exact GGML K-quant codec cores for the gguf_tpu framework.
 *
 * Fresh implementation of the GGUF Q4_K / Q6_K quantization algorithms
 * (behavioral spec: llama.cpp/GGML `quantize_row_q4_K_ref` /
 * `quantize_row_q6_K_ref`; the reference repo vendors the same algorithms at
 * /root/reference/utils/quantize/q4_k_ref.c:281 and q6_k_ref.c:243).
 *
 * Bit-exactness requirements (verified in tests/test_native_parity.py against
 * the reference sources compiled as an independent oracle):
 *   - float32 arithmetic only, with GGML's accumulation order in every loop
 *     (sequential ascending index) — the grid-search fits are sensitive to it.
 *   - fp16 conversions are IEEE 754 round-to-nearest-even. We use the
 *     compiler-native _Float16 when the compiler has it (gcc>=12 x86-64) and
 *     otherwise GGML's software converters; both are RNE-correct including
 *     denormals and agree bit for bit (-DGQ_SOFT_FP16 forces the software
 *     pair, which tests/test_native_parity.py checks).
 *   - nearest_int() must round half-to-even like GGML's float magic-number
 *     trick (add 2^23*1.5, reinterpret). lrintf() under the default FE_TONEAREST
 *     mode is identical for |x| <= 2^22, which the algorithm guarantees.
 *
 * Exported symbols use the `gq_` prefix and a flat little-endian byte buffer
 * ABI so they can be driven from Python via ctypes (see
 * gguf_tpu/quant/native.py).
 */

#include <stdint.h>
#include <math.h>
#include <string.h>

#define GQ_EXPORT __attribute__((visibility("default")))

#define QK_K 256          /* elements per superblock (all K-quants) */
#define Q4K_BYTES 144     /* 2(d) + 2(dmin) + 12(scales) + 128(qs) */
#define Q5K_BYTES 176     /* 2(d) + 2(dmin) + 12(scales) + 32(qh) + 128(qs) */
#define Q6K_BYTES 210     /* 128(ql) + 64(qh) + 16(scales) + 2(d)  */

static inline float clampf_min(float v, float lo) { return v < lo ? lo : v; }

static inline int imin(int a, int b) { return a < b ? a : b; }
static inline int imax(int a, int b) { return a > b ? a : b; }

/* ---------------------------------------------------------------- fp16 --- */

#if defined(__FLT16_MANT_DIG__) && !defined(GQ_SOFT_FP16)

GQ_EXPORT float gq_fp16_to_fp32(uint16_t h) {
    _Float16 v;
    memcpy(&v, &h, sizeof(v));
    return (float)v;
}

GQ_EXPORT uint16_t gq_fp32_to_fp16(float f) {
    _Float16 v = (_Float16)f; /* IEEE RNE conversion */
    uint16_t h;
    memcpy(&h, &v, sizeof(h));
    return h;
}

#else  /* no _Float16 (e.g. gcc < 12): GGML's exact software converters */

static inline uint32_t f32_bits(float f) {
    uint32_t u;
    memcpy(&u, &f, sizeof(u));
    return u;
}

static inline float bits_f32(uint32_t u) {
    float f;
    memcpy(&f, &u, sizeof(f));
    return f;
}

GQ_EXPORT float gq_fp16_to_fp32(uint16_t h) {
    const uint32_t w = (uint32_t)h << 16;
    const uint32_t sign = w & 0x80000000u;
    const uint32_t two_w = w + w;
    /* normals/inf/NaN: rebias the exponent with one float multiply */
    const float normalized = bits_f32((two_w >> 4) + (0xE0u << 23))
                             * 0x1.0p-112f;
    /* denormals: splice the mantissa next to 0.5 and subtract it */
    const float denormalized = bits_f32((two_w >> 17) | (126u << 23)) - 0.5f;
    return bits_f32(sign | (two_w < (1u << 27) ? f32_bits(denormalized)
                                                : f32_bits(normalized)));
}

GQ_EXPORT uint16_t gq_fp32_to_fp16(float f) {
    /* float adds position and round (RNE) the 11 kept mantissa bits */
    float base = (fabsf(f) * 0x1.0p+112f) * 0x1.0p-110f;
    const uint32_t w = f32_bits(f);
    const uint32_t shl1_w = w + w;
    const uint32_t sign = w & 0x80000000u;
    uint32_t bias = shl1_w & 0xFF000000u;
    if (bias < 0x71000000u) bias = 0x71000000u;
    base = bits_f32((bias >> 1) + 0x07800000u) + base;
    const uint32_t bits = f32_bits(base);
    const uint32_t nonsign = ((bits >> 13) & 0x00007C00u) + (bits & 0x00000FFFu);
    return (uint16_t)((sign >> 16) | (shl1_w > 0xFF000000u ? 0x7E00u : nonsign));
}

#endif

/* Vectorized helpers for Python-side bulk conversion. */
GQ_EXPORT void gq_fp16_to_fp32_buf(const uint16_t *h, float *f, int64_t n) {
    for (int64_t i = 0; i < n; ++i) f[i] = gq_fp16_to_fp32(h[i]);
}

GQ_EXPORT void gq_fp32_to_fp16_buf(const float *f, uint16_t *h, int64_t n) {
    for (int64_t i = 0; i < n; ++i) h[i] = gq_fp32_to_fp16(f[i]);
}

/* ------------------------------------------------------------- rounding --- */

/* Round to nearest, ties to even — equals GGML's magic-number nearest_int
 * for the |x| <= 2^22 domain used by the quantizers. */
GQ_EXPORT int gq_nearest_int(float f) {
    return (int)lrintf(f);
}

/* ---------------------------------------------------------------- Q4_K --- */
/*
 * Superblock layout (GGUF on-disk, little endian), 144 bytes / 256 elems:
 *   [d: fp16][dmin: fp16][scales: 12 bytes][qs: 128 bytes]
 * scales packs 8 six-bit sub-block scales (sc) and 8 six-bit mins (mn):
 *   byte j   (j<4): sc_j  lower 6 bits | sc_{j+4} bits 4..5 in the top 2 bits
 *   byte j+4 (j<4): mn_j  lower 6 bits | mn_{j+4} bits 4..5 in the top 2 bits
 *   byte j+8 (j<4): sc_{j+4} bits 0..3 in low nibble | mn_{j+4} bits 0..3 high
 * qs packs 256 4-bit codes: for each 64-element group g, byte 32g+l holds
 * element 64g+l in the low nibble and element 64g+32+l in the high nibble.
 * Element value: x = d*sc*q - dmin*mn  (per 32-element sub-block).
 */

static void q4k_scale_min_at(int j, const uint8_t *s, uint8_t *sc, uint8_t *mn) {
    if (j < 4) {
        *sc = s[j] & 63;
        *mn = s[j + 4] & 63;
    } else {
        *sc = (uint8_t)((s[j + 4] & 0x0F) | ((s[j - 4] >> 6) << 4));
        *mn = (uint8_t)((s[j + 4] >> 4) | ((s[j] >> 6) << 4));
    }
}

/*
 * Weighted affine grid fit: find (scale, min) minimizing
 *   sum_i w_i * (scale*L_i + min - x_i)^2,  L_i in [0, nmax].
 * Grid-searches candidate inverse scales (GGML make_qkx2_quants; Q4_K/Q5_K
 * use use_mad=0 — weighted squared error — while Q2_K uses use_mad=1,
 * weighted absolute error), refining each candidate with the weighted
 * least-squares closed form. Float op order matters: kept identical to the
 * GGML spec so quantized bytes match llama.cpp exactly.
 * Returns scale; *neg_min gets -min (>= 0).
 */
static float q4k_fit_affine(int n, int nmax, const float *x, const float *w,
                            uint8_t *L, float *neg_min, uint8_t *Ltmp,
                            float grid_lo, float grid_step, int grid_n,
                            int use_mad) {
    float vmin = x[0], vmax = x[0];
    float sum_w = w[0];
    float sum_x = sum_w * x[0];
    for (int i = 1; i < n; ++i) {
        if (x[i] < vmin) vmin = x[i];
        if (x[i] > vmax) vmax = x[i];
        sum_w += w[i];
        sum_x += w[i] * x[i];
    }
    if (vmin > 0.0f) vmin = 0.0f;
    if (vmax == vmin) {
        for (int i = 0; i < n; ++i) L[i] = 0;
        *neg_min = -vmin;
        return 0.0f;
    }

    float iscale = nmax / (vmax - vmin);
    float scale = 1.0f / iscale;
    float best_err = 0.0f;
    for (int i = 0; i < n; ++i) {
        int l = gq_nearest_int(iscale * (x[i] - vmin));
        L[i] = (uint8_t)imax(0, imin(nmax, l));
        float diff = scale * L[i] + vmin - x[i];
        diff = use_mad ? fabsf(diff) : diff * diff;
        best_err += w[i] * diff;
    }

    for (int is = 0; is <= grid_n; ++is) {
        iscale = (grid_lo + grid_step * is + nmax) / (vmax - vmin);
        float sum_l = 0.0f, sum_l2 = 0.0f, sum_xl = 0.0f;
        for (int i = 0; i < n; ++i) {
            int l = gq_nearest_int(iscale * (x[i] - vmin));
            l = imax(0, imin(nmax, l));
            Ltmp[i] = (uint8_t)l;
            sum_l += w[i] * l;
            sum_l2 += w[i] * l * l;
            sum_xl += w[i] * l * x[i];
        }
        float det = sum_w * sum_l2 - sum_l * sum_l;
        if (det > 0.0f) {
            float cand_scale = (sum_w * sum_xl - sum_x * sum_l) / det;
            float cand_min = (sum_l2 * sum_x - sum_l * sum_xl) / det;
            if (cand_min > 0.0f) {
                cand_min = 0.0f;
                cand_scale = sum_xl / sum_l2;
            }
            float err = 0.0f;
            for (int i = 0; i < n; ++i) {
                float diff = cand_scale * Ltmp[i] + cand_min - x[i];
                /* same objective as best_err: GGML's make_qkx2_quants
                   compares MAD against MAD when use_mad is set (Q2_K) */
                err += w[i] * (use_mad ? fabsf(diff) : diff * diff);
            }
            if (err < best_err) {
                memcpy(L, Ltmp, (size_t)n);
                best_err = err;
                scale = cand_scale;
                vmin = cand_min;
            }
        }
    }
    *neg_min = -vmin;
    return scale;
}

GQ_EXPORT void gq_quantize_q4_k(const float *xall, uint8_t *out, int64_t n) {
    const int64_t nblocks = n / QK_K;

#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t ib = 0; ib < nblocks; ++ib) {
        uint8_t L[QK_K];
        uint8_t Ltmp[32];
        float weights[32];
        float sub_scale[QK_K / 32];
        float sub_min[QK_K / 32];
        const float *x = xall + ib * QK_K;
        uint8_t *blk = out + ib * Q4K_BYTES;
        uint8_t *scales = blk + 4;
        uint8_t *qs = blk + 16;
        memset(scales, 0, 12);

        float max_scale = 0.0f;
        float max_min = 0.0f;
        for (int j = 0; j < QK_K / 32; ++j) {
            const float *xs = x + 32 * j;
            /* importance weights: rms(x) + |x_i| */
            float sum_x2 = 0.0f;
            for (int l = 0; l < 32; ++l) sum_x2 += xs[l] * xs[l];
            float av_x = sqrtf(sum_x2 / 32);
            for (int l = 0; l < 32; ++l) weights[l] = av_x + fabsf(xs[l]);

            sub_scale[j] = q4k_fit_affine(32, 15, xs, weights, L + 32 * j,
                                          &sub_min[j], Ltmp, -1.0f, 0.1f, 20, 0);
            if (sub_scale[j] > max_scale) max_scale = sub_scale[j];
            if (sub_min[j] > max_min) max_min = sub_min[j];
        }

        /* quantize the 8 sub-block scales/mins to 6 bits each */
        float inv_scale = max_scale > 0.0f ? 63.0f / max_scale : 0.0f;
        float inv_min = max_min > 0.0f ? 63.0f / max_min : 0.0f;
        for (int j = 0; j < QK_K / 32; ++j) {
            uint8_t ls = (uint8_t)gq_nearest_int(inv_scale * sub_scale[j]);
            uint8_t lm = (uint8_t)gq_nearest_int(inv_min * sub_min[j]);
            ls = (uint8_t)imin(63, ls);
            lm = (uint8_t)imin(63, lm);
            if (j < 4) {
                scales[j] = ls;
                scales[j + 4] = lm;
            } else {
                scales[j + 4] = (uint8_t)((ls & 0xF) | ((lm & 0xF) << 4));
                scales[j - 4] |= (uint8_t)((ls >> 4) << 6);
                scales[j] |= (uint8_t)((lm >> 4) << 6);
            }
        }
        uint16_t d_bits = gq_fp32_to_fp16(max_scale / 63.0f);
        uint16_t dmin_bits = gq_fp32_to_fp16(max_min / 63.0f);
        memcpy(blk + 0, &d_bits, 2);
        memcpy(blk + 2, &dmin_bits, 2);

        /* re-quantize L against the 6-bit-rounded scales */
        for (int j = 0; j < QK_K / 32; ++j) {
            uint8_t sc, mn;
            q4k_scale_min_at(j, scales, &sc, &mn);
            const float d = gq_fp16_to_fp32(d_bits) * sc;
            if (!d) continue;
            const float dm = gq_fp16_to_fp32(dmin_bits) * mn;
            for (int l = 0; l < 32; ++l) {
                int q = gq_nearest_int((x[32 * j + l] + dm) / d);
                L[32 * j + l] = (uint8_t)imax(0, imin(15, q));
            }
        }

        /* nibble-pack: per 64-group, byte l = elem[l] | elem[l+32]<<4 */
        for (int g = 0; g < QK_K; g += 64) {
            uint8_t *q = qs + g / 2;
            for (int l = 0; l < 32; ++l)
                q[l] = (uint8_t)(L[g + l] | (L[g + l + 32] << 4));
        }
    }
}

GQ_EXPORT void gq_dequantize_q4_k(const uint8_t *in, float *x, int64_t n) {
    const int64_t nblocks = n / QK_K;
    for (int64_t ib = 0; ib < nblocks; ++ib, x += QK_K) {
        const uint8_t *blk = in + ib * Q4K_BYTES;
        uint16_t d_bits, dmin_bits;
        memcpy(&d_bits, blk + 0, 2);
        memcpy(&dmin_bits, blk + 2, 2);
        const float d = gq_fp16_to_fp32(d_bits);
        const float dmin = gq_fp16_to_fp32(dmin_bits);
        const uint8_t *scales = blk + 4;
        const uint8_t *qs = blk + 16;
        for (int j = 0; j < QK_K / 32; ++j) {
            uint8_t sc, mn;
            q4k_scale_min_at(j, scales, &sc, &mn);
            const float dj = d * sc;
            const float mj = dmin * mn;
            /* sub-block j covers elems 32j..32j+31; locate its nibbles */
            int g = (32 * j) / 64;          /* 64-group index            */
            int hi = (32 * j) % 64 >= 32;   /* high nibble half?         */
            const uint8_t *q = qs + 32 * g;
            for (int l = 0; l < 32; ++l) {
                uint8_t nib = hi ? (q[l] >> 4) : (q[l] & 0x0F);
                x[32 * j + l] = dj * nib - mj;
            }
        }
    }
}

/* ---------------------------------------------------------------- Q5_K --- */
/*
 * Superblock layout, 176 bytes / 256 elems:
 *   [d: fp16][dmin: fp16][scales: 12 bytes][qh: 32 bytes][qs: 128 bytes]
 * Same 6-bit (sc, mn) packing as Q4_K; 5-bit codes q in [0, 32):
 *   qs byte 32g+l (per 64-group g, l<32): low 4 bits of elems 64g+l | 64g+32+l<<4
 *   qh byte l: the 5th bit of elems {64g + 32h + l} at bit position 2g+h.
 * Element value: x = d*sc*q - dmin*mn (per 32-element sub-block).
 * Behavioral spec: GGML quantize_row_q5_K_ref — identical affine grid fit as
 * Q4_K (make_qkx2_quants) but with nmax=31 and grid rmin=-0.5, rdelta=0.1,
 * nstep=15.
 */

GQ_EXPORT void gq_quantize_q5_k(const float *xall, uint8_t *out, int64_t n) {
    const int64_t nblocks = n / QK_K;

#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t ib = 0; ib < nblocks; ++ib) {
        uint8_t L[QK_K];
        uint8_t Ltmp[32];
        float weights[32];
        float sub_scale[QK_K / 32];
        float sub_min[QK_K / 32];
        const float *x = xall + ib * QK_K;
        uint8_t *blk = out + ib * Q5K_BYTES;
        uint8_t *scales = blk + 4;
        uint8_t *qh = blk + 16;
        uint8_t *qs = blk + 48;
        memset(scales, 0, 12);

        float max_scale = 0.0f;
        float max_min = 0.0f;
        for (int j = 0; j < QK_K / 32; ++j) {
            const float *xs = x + 32 * j;
            float sum_x2 = 0.0f;
            for (int l = 0; l < 32; ++l) sum_x2 += xs[l] * xs[l];
            float av_x = sqrtf(sum_x2 / 32);
            for (int l = 0; l < 32; ++l) weights[l] = av_x + fabsf(xs[l]);

            sub_scale[j] = q4k_fit_affine(32, 31, xs, weights, L + 32 * j,
                                          &sub_min[j], Ltmp, -0.5f, 0.1f, 15, 0);
            if (sub_scale[j] > max_scale) max_scale = sub_scale[j];
            if (sub_min[j] > max_min) max_min = sub_min[j];
        }

        float inv_scale = max_scale > 0.0f ? 63.0f / max_scale : 0.0f;
        float inv_min = max_min > 0.0f ? 63.0f / max_min : 0.0f;
        for (int j = 0; j < QK_K / 32; ++j) {
            uint8_t ls = (uint8_t)gq_nearest_int(inv_scale * sub_scale[j]);
            uint8_t lm = (uint8_t)gq_nearest_int(inv_min * sub_min[j]);
            ls = (uint8_t)imin(63, ls);
            lm = (uint8_t)imin(63, lm);
            if (j < 4) {
                scales[j] = ls;
                scales[j + 4] = lm;
            } else {
                scales[j + 4] = (uint8_t)((ls & 0xF) | ((lm & 0xF) << 4));
                scales[j - 4] |= (uint8_t)((ls >> 4) << 6);
                scales[j] |= (uint8_t)((lm >> 4) << 6);
            }
        }
        uint16_t d_bits = gq_fp32_to_fp16(max_scale / 63.0f);
        uint16_t dmin_bits = gq_fp32_to_fp16(max_min / 63.0f);
        memcpy(blk + 0, &d_bits, 2);
        memcpy(blk + 2, &dmin_bits, 2);

        for (int j = 0; j < QK_K / 32; ++j) {
            uint8_t sc, mn;
            q4k_scale_min_at(j, scales, &sc, &mn);
            const float d = gq_fp16_to_fp32(d_bits) * sc;
            if (!d) continue;
            const float dm = gq_fp16_to_fp32(dmin_bits) * mn;
            for (int l = 0; l < 32; ++l) {
                int q = gq_nearest_int((x[32 * j + l] + dm) / d);
                L[32 * j + l] = (uint8_t)imax(0, imin(31, q));
            }
        }

        memset(qh, 0, 32);
        uint8_t m1 = 1, m2 = 2;
        for (int g = 0; g < QK_K; g += 64) {
            uint8_t *q = qs + g / 2;
            for (int l = 0; l < 32; ++l) {
                int l1 = L[g + l];
                if (l1 > 15) { l1 -= 16; qh[l] |= m1; }
                int l2 = L[g + l + 32];
                if (l2 > 15) { l2 -= 16; qh[l] |= m2; }
                q[l] = (uint8_t)(l1 | (l2 << 4));
            }
            m1 <<= 2;
            m2 <<= 2;
        }
    }
}

GQ_EXPORT void gq_dequantize_q5_k(const uint8_t *in, float *x, int64_t n) {
    const int64_t nblocks = n / QK_K;
    for (int64_t ib = 0; ib < nblocks; ++ib, x += QK_K) {
        const uint8_t *blk = in + ib * Q5K_BYTES;
        uint16_t d_bits, dmin_bits;
        memcpy(&d_bits, blk + 0, 2);
        memcpy(&dmin_bits, blk + 2, 2);
        const float d = gq_fp16_to_fp32(d_bits);
        const float dmin = gq_fp16_to_fp32(dmin_bits);
        const uint8_t *scales = blk + 4;
        const uint8_t *qh = blk + 16;
        const uint8_t *qs = blk + 48;
        uint8_t u1 = 1, u2 = 2;
        for (int g = 0; g < QK_K; g += 64) {
            uint8_t sc, mn;
            int j = g / 32;
            q4k_scale_min_at(j, scales, &sc, &mn);
            const float d1 = d * sc;
            const float m1v = dmin * mn;
            q4k_scale_min_at(j + 1, scales, &sc, &mn);
            const float d2 = d * sc;
            const float m2v = dmin * mn;
            const uint8_t *q = qs + g / 2;
            for (int l = 0; l < 32; ++l)
                x[g + l] = d1 * ((q[l] & 0xF) + ((qh[l] & u1) ? 16 : 0)) - m1v;
            for (int l = 0; l < 32; ++l)
                x[g + 32 + l] = d2 * ((q[l] >> 4) + ((qh[l] & u2) ? 16 : 0)) - m2v;
            u1 <<= 2;
            u2 <<= 2;
        }
    }
}

/* ---------------------------------------------------------------- Q2_K --- */
/*
 * Superblock layout (GGUF on-disk), 84 bytes / 256 elems:
 *   [scales: 16 bytes][qs: 64 bytes][d: fp16][dmin: fp16]
 * 16 sub-blocks of 16 elements; scales byte j = 4-bit sc_j | 4-bit mn_j << 4.
 * qs packs 256 2-bit codes: for each 128-element half h, byte 32h+l (l<32)
 * holds elems 128h+l, +32, +64, +96 at bit positions 0, 2, 4, 6.
 * Element value: x = d*sc*q - dmin*mn  (per 16-element sub-block, q in [0,4)).
 * Behavioral spec: GGML quantize_row_q2_K_ref — the same affine grid fit as
 * Q4_K (make_qkx2_quants) with nmax=3, per-element |x| importance weights,
 * grid rmin=-0.5, rdelta=0.1, nstep=15, and the MAD (absolute error)
 * objective; sub-scales/mins quantized to 4 bits against q4scale=15.
 */

GQ_EXPORT void gq_quantize_q2_k(const float *xall, uint8_t *out, int64_t n) {
    const int64_t nblocks = n / QK_K;

#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t ib = 0; ib < nblocks; ++ib) {
        uint8_t L[QK_K];
        uint8_t Ltmp[16];
        float weights[16];
        float sub_scale[QK_K / 16];
        float sub_min[QK_K / 16];
        const float *x = xall + ib * QK_K;
        uint8_t *blk = out + ib * 84;
        uint8_t *scales = blk;
        uint8_t *qs = blk + 16;

        float max_scale = 0.0f;
        float max_min = 0.0f;
        for (int j = 0; j < QK_K / 16; ++j) {
            const float *xs = x + 16 * j;
            for (int l = 0; l < 16; ++l) weights[l] = fabsf(xs[l]);
            sub_scale[j] = q4k_fit_affine(16, 3, xs, weights, L + 16 * j,
                                          &sub_min[j], Ltmp, -0.5f, 0.1f, 15, 1);
            if (sub_scale[j] > max_scale) max_scale = sub_scale[j];
            if (sub_min[j] > max_min) max_min = sub_min[j];
        }

        const float q4scale = 15.0f;
        uint16_t d_bits, dmin_bits;
        if (max_scale > 0.0f) {
            float iscale = q4scale / max_scale;
            for (int j = 0; j < QK_K / 16; ++j)
                scales[j] = (uint8_t)gq_nearest_int(iscale * sub_scale[j]);
            d_bits = gq_fp32_to_fp16(max_scale / q4scale);
        } else {
            for (int j = 0; j < QK_K / 16; ++j) scales[j] = 0;
            d_bits = gq_fp32_to_fp16(0.0f);
        }
        if (max_min > 0.0f) {
            float iscale = q4scale / max_min;
            for (int j = 0; j < QK_K / 16; ++j)
                scales[j] |= (uint8_t)(gq_nearest_int(iscale * sub_min[j]) << 4);
            dmin_bits = gq_fp32_to_fp16(max_min / q4scale);
        } else {
            dmin_bits = gq_fp32_to_fp16(0.0f);
        }
        memcpy(blk + 80, &d_bits, 2);
        memcpy(blk + 82, &dmin_bits, 2);

        /* re-quantize L against the 4-bit-rounded scales */
        for (int j = 0; j < QK_K / 16; ++j) {
            const float d = gq_fp16_to_fp32(d_bits) * (scales[j] & 0xF);
            if (!d) continue;
            const float dm = gq_fp16_to_fp32(dmin_bits) * (scales[j] >> 4);
            for (int l = 0; l < 16; ++l) {
                int q = gq_nearest_int((x[16 * j + l] + dm) / d);
                L[16 * j + l] = (uint8_t)imax(0, imin(3, q));
            }
        }

        for (int h = 0; h < QK_K; h += 128) {
            uint8_t *q = qs + h / 4;
            for (int l = 0; l < 32; ++l)
                q[l] = (uint8_t)(L[h + l] | (L[h + l + 32] << 2) |
                                 (L[h + l + 64] << 4) | (L[h + l + 96] << 6));
        }
    }
}

GQ_EXPORT void gq_dequantize_q2_k(const uint8_t *in, float *x, int64_t n) {
    const int64_t nblocks = n / QK_K;
    for (int64_t ib = 0; ib < nblocks; ++ib, x += QK_K) {
        const uint8_t *blk = in + ib * 84;
        const uint8_t *scales = blk;
        const uint8_t *qs = blk + 16;
        uint16_t d_bits, dmin_bits;
        memcpy(&d_bits, blk + 80, 2);
        memcpy(&dmin_bits, blk + 82, 2);
        const float d = gq_fp16_to_fp32(d_bits);
        const float dmin = gq_fp16_to_fp32(dmin_bits);
        for (int h = 0; h < QK_K; h += 128) {
            const uint8_t *q = qs + h / 4;
            for (int s = 0; s < 4; ++s) {        /* 32-elem slab at shift 2s */
                for (int half = 0; half < 2; ++half) {
                    int j = (h + 32 * s + 16 * half) / 16;
                    const float dl = d * (scales[j] & 0xF);
                    const float ml = dmin * (scales[j] >> 4);
                    for (int l = 0; l < 16; ++l) {
                        int code = (q[16 * half + l] >> (2 * s)) & 3;
                        x[h + 32 * s + 16 * half + l] = dl * code - ml;
                    }
                }
            }
        }
    }
}

/* ---------------------------------------------------------------- Q3_K --- */
/*
 * Superblock layout, 110 bytes / 256 elems:
 *   [hmask: 32 bytes][qs: 64 bytes][scales: 12 bytes][d: fp16]
 * 16 sub-blocks of 16 elements with 6-bit scales sc in [0,64) packed as:
 *   byte j   (j<8): low 4 bits of sc_j | (j>=8: high nibble holds sc_{j+8}'s
 *                   low 4 bits — i.e. byte j-8's high nibble for j in 8..15)
 *   byte 8+i (i<4): top-2-bits of sc_{i}, sc_{4+i}, sc_{8+i}, sc_{12+i} at
 *                   bit positions 0, 2, 4, 6.
 * qs packs the low 2 bits exactly like Q2_K's qs; hmask byte l (l<32) holds
 * the third bit of elems {32b + l} at bit position b.
 * Element value: x = d*(sc-32)*q with q = (low2 | hbit<<2) - 4 in [-4, 4).
 * Behavioral spec: GGML quantize_row_q3_K_ref (make_q3_quants with nmax=4,
 * do_rmse=true: x^2-weighted fit with 5 rounds of coordinate descent).
 */

static float q3k_fit_signed(int n, int nmax, const float *x, int8_t *L) {
    float max = 0.0f, amax = 0.0f;
    for (int i = 0; i < n; ++i) {
        float ax = fabsf(x[i]);
        if (ax > amax) {
            amax = ax;
            max = x[i];
        }
    }
    if (amax < 1e-15f) {
        for (int i = 0; i < n; ++i) L[i] = 0;
        return 0.0f;
    }
    float iscale = -nmax / max;
    float sumlx = 0.0f, suml2 = 0.0f;
    for (int i = 0; i < n; ++i) {
        int l = gq_nearest_int(iscale * x[i]);
        l = imax(-nmax, imin(nmax - 1, l));
        L[i] = (int8_t)l;
        float w = x[i] * x[i];
        sumlx += w * x[i] * l;
        suml2 += w * l * l;
    }
    for (int itry = 0; itry < 5; ++itry) {
        int n_changed = 0;
        for (int i = 0; i < n; ++i) {
            float w = x[i] * x[i];
            float slx = sumlx - w * x[i] * L[i];
            if (slx > 0.0f) {
                float sl2 = suml2 - w * L[i] * L[i];
                int new_l = gq_nearest_int(x[i] * sl2 / slx);
                new_l = imax(-nmax, imin(nmax - 1, new_l));
                if (new_l != L[i]) {
                    slx += w * x[i] * new_l;
                    sl2 += w * new_l * new_l;
                    if (sl2 > 0.0f && slx * slx * suml2 > sumlx * sumlx * sl2) {
                        L[i] = (int8_t)new_l;
                        sumlx = slx;
                        suml2 = sl2;
                        ++n_changed;
                    }
                }
            }
        }
        if (!n_changed) break;
    }
    for (int i = 0; i < n; ++i) L[i] = (int8_t)(L[i] + nmax);
    return sumlx / suml2;
}

GQ_EXPORT void gq_quantize_q3_k(const float *xall, uint8_t *out, int64_t n) {
    const int64_t nblocks = n / QK_K;

#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t ib = 0; ib < nblocks; ++ib) {
        int8_t L[QK_K];
        float sub_scale[QK_K / 16];
        const float *x = xall + ib * QK_K;
        uint8_t *blk = out + ib * 110;
        uint8_t *hmask = blk;
        uint8_t *qs = blk + 32;
        uint8_t *scales = blk + 96;
        uint8_t *d_ptr = blk + 108;

        float max_scale = 0.0f, amax = 0.0f;
        for (int j = 0; j < QK_K / 16; ++j) {
            sub_scale[j] = q3k_fit_signed(16, 4, x + 16 * j, L + 16 * j);
            float a = fabsf(sub_scale[j]);
            if (a > amax) {
                amax = a;
                max_scale = sub_scale[j];
            }
        }

        memset(scales, 0, 12);
        uint16_t d_bits;
        if (max_scale != 0.0f) {
            float iscale = -32.0f / max_scale;
            for (int j = 0; j < QK_K / 16; ++j) {
                int l = gq_nearest_int(iscale * sub_scale[j]);
                l = imax(-32, imin(31, l)) + 32;
                if (j < 8) scales[j] |= (uint8_t)(l & 0xF);
                else scales[j - 8] |= (uint8_t)((l & 0xF) << 4);
                l >>= 4;
                scales[8 + j % 4] |= (uint8_t)(l << (2 * (j / 4)));
            }
            d_bits = gq_fp32_to_fp16(1.0f / iscale);
        } else {
            d_bits = gq_fp32_to_fp16(0.0f);
        }
        memcpy(d_ptr, &d_bits, 2);

        /* re-quantize L against the 6-bit-rounded scales */
        for (int j = 0; j < QK_K / 16; ++j) {
            int sc = j < 8 ? scales[j] & 0xF : scales[j - 8] >> 4;
            sc = (sc | (((scales[8 + j % 4] >> (2 * (j / 4))) & 3) << 4)) - 32;
            float dj = gq_fp16_to_fp32(d_bits) * sc;
            if (!dj) continue;
            for (int l = 0; l < 16; ++l) {
                int q = gq_nearest_int(x[16 * j + l] / dj);
                L[16 * j + l] = (int8_t)(imax(-4, imin(3, q)) + 4);
            }
        }

        memset(hmask, 0, 32);
        int m = 0;
        uint8_t hm = 1;
        for (int j = 0; j < QK_K; ++j) {
            if (L[j] > 3) {
                hmask[m] |= hm;
                L[j] = (int8_t)(L[j] - 4);
            }
            if (++m == QK_K / 8) {
                m = 0;
                hm <<= 1;
            }
        }
        for (int h = 0; h < QK_K; h += 128) {
            uint8_t *q = qs + h / 4;
            for (int l = 0; l < 32; ++l)
                q[l] = (uint8_t)(L[h + l] | (L[h + l + 32] << 2) |
                                 (L[h + l + 64] << 4) | (L[h + l + 96] << 6));
        }
    }
}

GQ_EXPORT void gq_dequantize_q3_k(const uint8_t *in, float *x, int64_t n) {
    const int64_t nblocks = n / QK_K;
    for (int64_t ib = 0; ib < nblocks; ++ib, x += QK_K) {
        const uint8_t *blk = in + ib * 110;
        const uint8_t *hmask = blk;
        const uint8_t *qs = blk + 32;
        const uint8_t *scales = blk + 96;
        uint16_t d_bits;
        memcpy(&d_bits, blk + 108, 2);
        const float d_all = gq_fp16_to_fp32(d_bits);

        for (int e = 0; e < QK_K; ++e) {
            int j = e / 16;
            int sc = j < 8 ? scales[j] & 0xF : scales[j - 8] >> 4;
            sc = (sc | (((scales[8 + j % 4] >> (2 * (j / 4))) & 3) << 4)) - 32;
            int low2 = (qs[(e / 128) * 32 + e % 32] >> (2 * ((e % 128) / 32))) & 3;
            int hbit = (hmask[e % 32] >> (e / 32)) & 1;
            x[e] = d_all * sc * (float)(low2 - (hbit ? 0 : 4));
        }
    }
}

/* ---------------------------------------------------------------- Q6_K --- */
/*
 * Superblock layout, 210 bytes / 256 elems:
 *   [ql: 128 bytes][qh: 64 bytes][scales: 16 x int8][d: fp16]
 * 6-bit code q in [0,64); element value x = d*scale_{i/16}*(q-32).
 * Packing is per 128-element half h (h=0,1):
 *   ql byte 64h+l (l<32)   : low nibbles of elems 128h+l    | 128h+l+64 <<4
 *   ql byte 64h+32+l (l<32): low nibbles of elems 128h+l+32 | 128h+l+96 <<4
 *   qh byte 32h+l (l<32)   : top-2-bits of elems 128h+l, +32, +64, +96 at
 *                            bit positions 0,2,4,6.
 */

/*
 * Weighted symmetric fit: x ≈ scale*(L - nmax), codes L-nmax in
 * [-nmax, nmax-1], importance weights x_i^2 (GGML make_qx_quants with
 * rmse_type=1, qw=NULL — the only configuration Q6_K uses). Searches 19
 * perturbed inverse scales around -nmax/max and keeps the weighted
 * least-squares refinement with the best objective.
 */
static float q6k_fit_symmetric(int n, int nmax, const float *x, int8_t *L) {
    float max = 0.0f, amax = 0.0f;
    for (int i = 0; i < n; ++i) {
        float ax = fabsf(x[i]);
        if (ax > amax) {
            amax = ax;
            max = x[i];
        }
    }
    if (amax < 1e-15f) {
        for (int i = 0; i < n; ++i) L[i] = 0;
        return 0.0f;
    }
    float iscale = -nmax / max;
    float sumlx = 0.0f, suml2 = 0.0f;
    for (int i = 0; i < n; ++i) {
        int l = gq_nearest_int(iscale * x[i]);
        l = imax(-nmax, imin(nmax - 1, l));
        L[i] = (int8_t)(l + nmax);
        float w = x[i] * x[i];
        sumlx += w * x[i] * l;
        suml2 += w * l * l;
    }
    float scale = suml2 ? sumlx / suml2 : 0.0f;
    float best = scale * sumlx;
    for (int is = -9; is <= 9; ++is) {
        if (is == 0) continue;
        iscale = -(nmax + 0.1f * is) / max;
        sumlx = suml2 = 0.0f;
        for (int i = 0; i < n; ++i) {
            int l = gq_nearest_int(iscale * x[i]);
            l = imax(-nmax, imin(nmax - 1, l));
            float w = x[i] * x[i];
            sumlx += w * x[i] * l;
            suml2 += w * l * l;
        }
        if (suml2 > 0.0f && sumlx * sumlx > best * suml2) {
            for (int i = 0; i < n; ++i) {
                int l = gq_nearest_int(iscale * x[i]);
                L[i] = (int8_t)(nmax + imax(-nmax, imin(nmax - 1, l)));
            }
            scale = sumlx / suml2;
            best = scale * sumlx;
        }
    }
    return scale;
}

GQ_EXPORT void gq_quantize_q6_k(const float *xall, uint8_t *out, int64_t n) {
    const int64_t nblocks = n / QK_K;

#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t ib = 0; ib < nblocks; ++ib) {
        int8_t L[QK_K];
        float sub_scale[QK_K / 16];
        const float *x = xall + ib * QK_K;
        uint8_t *blk = out + ib * Q6K_BYTES;
        uint8_t *ql = blk;
        uint8_t *qh = blk + 128;
        int8_t *scales = (int8_t *)(blk + 192);
        uint8_t *d_ptr = blk + 208;

        float max_scale = 0.0f, max_abs_scale = 0.0f;
        for (int j = 0; j < QK_K / 16; ++j) {
            sub_scale[j] = q6k_fit_symmetric(16, 32, x + 16 * j, L + 16 * j);
            float a = fabsf(sub_scale[j]);
            if (a > max_abs_scale) {
                max_abs_scale = a;
                max_scale = sub_scale[j];
            }
        }

        if (max_abs_scale < 1e-15f) {
            memset(blk, 0, Q6K_BYTES);
            uint16_t z = gq_fp32_to_fp16(0.0f);
            memcpy(d_ptr, &z, 2);
            continue;
        }

        float iscale = -128.0f / max_scale;
        uint16_t d_bits = gq_fp32_to_fp16(1.0f / iscale);
        memcpy(d_ptr, &d_bits, 2);
        for (int j = 0; j < QK_K / 16; ++j)
            scales[j] = (int8_t)imin(127, gq_nearest_int(iscale * sub_scale[j]));

        /* re-quantize against the int8-rounded scales */
        for (int j = 0; j < QK_K / 16; ++j) {
            float dj = gq_fp16_to_fp32(d_bits) * scales[j];
            if (!dj) continue;
            for (int l = 0; l < 16; ++l) {
                int q = gq_nearest_int(x[16 * j + l] / dj);
                L[16 * j + l] = (int8_t)(imax(-32, imin(31, q)) + 32);
            }
        }

        /* bit-pack per 128-element half */
        for (int h = 0; h < QK_K; h += 128) {
            uint8_t *pl = ql + h / 2;
            uint8_t *ph = qh + h / 4;
            for (int l = 0; l < 32; ++l) {
                const uint8_t a = (uint8_t)(L[h + l] & 0xF);
                const uint8_t b = (uint8_t)(L[h + l + 32] & 0xF);
                const uint8_t c = (uint8_t)(L[h + l + 64] & 0xF);
                const uint8_t e = (uint8_t)(L[h + l + 96] & 0xF);
                pl[l] = (uint8_t)(a | (c << 4));
                pl[l + 32] = (uint8_t)(b | (e << 4));
                ph[l] = (uint8_t)((L[h + l] >> 4) | ((L[h + l + 32] >> 4) << 2) |
                                  ((L[h + l + 64] >> 4) << 4) |
                                  ((L[h + l + 96] >> 4) << 6));
            }
        }
    }
}

GQ_EXPORT void gq_dequantize_q6_k(const uint8_t *in, float *x, int64_t n) {
    const int64_t nblocks = n / QK_K;
    for (int64_t ib = 0; ib < nblocks; ++ib, x += QK_K) {
        const uint8_t *blk = in + ib * Q6K_BYTES;
        const uint8_t *ql = blk;
        const uint8_t *qh = blk + 128;
        const int8_t *scales = (const int8_t *)(blk + 192);
        uint16_t d_bits;
        memcpy(&d_bits, blk + 208, 2);
        const float d = gq_fp16_to_fp32(d_bits);

        for (int h = 0; h < QK_K; h += 128) {
            const uint8_t *pl = ql + h / 2;
            const uint8_t *ph = qh + h / 4;
            for (int l = 0; l < 32; ++l) {
                int q0 = (pl[l] & 0xF) | (((ph[l] >> 0) & 3) << 4);
                int q1 = (pl[l + 32] & 0xF) | (((ph[l] >> 2) & 3) << 4);
                int q2 = (pl[l] >> 4) | (((ph[l] >> 4) & 3) << 4);
                int q3 = (pl[l + 32] >> 4) | (((ph[l] >> 6) & 3) << 4);
                x[h + l] = d * scales[(h + l) / 16] * (q0 - 32);
                x[h + l + 32] = d * scales[(h + l + 32) / 16] * (q1 - 32);
                x[h + l + 64] = d * scales[(h + l + 64) / 16] * (q2 - 32);
                x[h + l + 96] = d * scales[(h + l + 96) / 16] * (q3 - 32);
            }
        }
    }
}
