/* gguf_soa.c — native GGUF-block -> SoA device layout transforms.
 *
 * The Python/numpy transforms in gguf_tpu/quant/layouts.py define the
 * layout contract (and remain the tested reference); these C twins produce
 * byte-identical outputs ~50x faster, turning multi-minute 7B+ model cold
 * loads into seconds. Counterpart of the reference repo's pattern of
 * keeping the bit-level cores native (SURVEY.md §2 #5/#6) applied to the
 * serving data-loader.
 *
 * All outputs are K-major (K-ish dim outer, M on the fast axis):
 *   field[row][mi]  is stored at  field_out[row * m + mi]
 * Decoding is tiled: TILE columns (mi) are decoded into small contiguous
 * scratch buffers, then written out as TILE-wide row strips, so neither
 * the block reads nor the SoA writes stride cache-hostilely.
 *
 * Layout contracts (must match layouts.py exactly):
 *   q8_0:  34B block [d:u16][qs:32xi8]; d (K/32, M) u16, qs (K, M) i8
 *   q4_k: 144B block [d][dmin][scales:12B][qs:128B];
 *         d/dmin (SB, M) u16, sc/mn (SB*8, M) u8 (get_scale_min_k4),
 *         qs (K/2, M) u8 in PLANE order: byte row j packs elements
 *         (block j%8, pos j/8) and (block j%8, pos j/8 + 16)
 *   q5_k: 176B block [d][dmin][scales:12B][qh:32B][qs:128B];
 *         qs (K/2, M) u8 with byte j = elem j | elem j+128 << 4,
 *         plus qh (K/8, M): byte j bit b = hi-bit of elem 32b+j
 *   q6_k: 210B block [ql:128B][qh:64B][scales:16xi8][d:u16];
 *         d (SB, M) u16, sc (SB*16, M) i8,
 *         ql (K/2, M) like q5_k's qs, qh (K/4, M): byte j =
 *         hi2(elem j) | hi2(elem j+64)<<2 | hi2(j+128)<<4 | hi2(j+192)<<6
 *   q2_k:  84B block [scales:16B][qs:64B][d:u16][dmin:u16];
 *         d/dmin (SB, M) u16, sc/mn (SB*16, M) u8 (4-bit split), qs (K/4, M):
 *         byte j = code(elem j) | code(j+64)<<2 | code(j+128)<<4 | code(j+192)<<6
 *   q3_k: 110B block [hmask:32B][qs:64B][scales:12B][d:u16];
 *         d (SB, M) u16, sc (SB*16, M) i8 (-32 applied), qs (K/4, M) the
 *         low-2-bit plane of code+4 packed like q2_k, qh (K/8, M): byte j
 *         bit b = third bit of elem 32b+j (the on-disk hmask layout)
 */

#include <stdint.h>
#include <string.h>
#ifdef _OPENMP
#ifdef _OPENMP
#include <omp.h>
#endif
#endif

#define TILE 128

static inline uint16_t rd16(const uint8_t *p) {
    return (uint16_t)(p[0] | (p[1] << 8));
}

/* ------------------------------------------------------------------ q8_0 */

void q8_0_to_soa_c(const uint8_t *src, int64_t m, int64_t nbk,
                   uint16_t *d_out, int8_t *qs_out) {
    /* nbk = K/32 blocks per row; block (mi, bi) at src + (mi*nbk + bi)*34.
       When K %% 256 == 0 (nbk %% 8 == 0) qs rows are written in PLANE
       order — element (bi*32 + j) at row (bi/8)*256 + j*8 + (bi%%8) — the
       same deterministic rule as quant/layouts.py q8_0_plane. */
    int plane = (nbk % 8) == 0;
#ifdef _OPENMP
    #pragma omp parallel for schedule(static)
#endif
    for (int64_t bi = 0; bi < nbk; bi++) {
        for (int64_t mi0 = 0; mi0 < m; mi0 += TILE) {
            int64_t tw = m - mi0 < TILE ? m - mi0 : TILE;
            uint16_t dt[TILE];
            int8_t qt[32][TILE];
            for (int64_t t = 0; t < tw; t++) {
                const uint8_t *b = src + ((mi0 + t) * nbk + bi) * 34;
                dt[t] = rd16(b);
                for (int j = 0; j < 32; j++)
                    qt[j][t] = (int8_t)b[2 + j];
            }
            memcpy(d_out + bi * m + mi0, dt, tw * sizeof(uint16_t));
            for (int j = 0; j < 32; j++) {
                int64_t row = plane ? (bi / 8) * 256 + j * 8 + (bi % 8)
                                    : bi * 32 + j;
                memcpy(qs_out + row * m + mi0, qt[j], tw);
            }
        }
    }
}

/* ------------------------------------------------------- k-quant scales */

static inline void scale_min_k4(const uint8_t *q, uint8_t *sc, uint8_t *mn) {
    for (int j = 0; j < 4; j++) {
        sc[j] = q[j] & 63;
        mn[j] = q[j + 4] & 63;
        sc[j + 4] = (q[j + 8] & 0x0F) | ((q[j] >> 6) << 4);
        mn[j + 4] = (q[j + 8] >> 4) | ((q[j + 4] >> 6) << 4);
    }
}

/* ------------------------------------------------------------------ q4_k */

static inline uint8_t q4k_elem(const uint8_t *qs, int e) {
    /* disk: per 64-group g, byte 32g+r holds elem 64g+r (lo), 64g+32+r (hi) */
    int g = e >> 6, r = e & 63;
    uint8_t b = qs[32 * g + (r & 31)];
    return r < 32 ? (b & 0x0F) : (b >> 4);
}

void q4_k_to_soa_c(const uint8_t *src, int64_t m, int64_t sb,
                   uint16_t *d_out, uint16_t *dmin_out,
                   uint8_t *sc_out, uint8_t *mn_out, uint8_t *qs_out) {
#ifdef _OPENMP
    #pragma omp parallel for schedule(static)
#endif
    for (int64_t si = 0; si < sb; si++) {
        for (int64_t mi0 = 0; mi0 < m; mi0 += TILE) {
            int64_t tw = m - mi0 < TILE ? m - mi0 : TILE;
            uint16_t dt[TILE], dmt[TILE];
            uint8_t sct[8][TILE], mnt[8][TILE], qst[128][TILE];
            for (int64_t t = 0; t < tw; t++) {
                const uint8_t *b = src + ((mi0 + t) * sb + si) * 144;
                dt[t] = rd16(b);
                dmt[t] = rd16(b + 2);
                uint8_t sc8[8], mn8[8];
                scale_min_k4(b + 4, sc8, mn8);
                for (int j = 0; j < 8; j++) {
                    sct[j][t] = sc8[j];
                    mnt[j][t] = mn8[j];
                }
                const uint8_t *qs = b + 16;
                /* plane order: byte row j packs (block j%8, pos j/8) and
                 * (block j%8, pos j/8 + 16) — see quant/layouts.py
                 * _repack_nibbles_plane */
                for (int j = 0; j < 128; j++) {
                    int e = (j & 7) * 32 + (j >> 3);
                    qst[j][t] = (uint8_t)(q4k_elem(qs, e)
                                          | (q4k_elem(qs, e + 16) << 4));
                }
            }
            memcpy(d_out + si * m + mi0, dt, tw * sizeof(uint16_t));
            memcpy(dmin_out + si * m + mi0, dmt, tw * sizeof(uint16_t));
            for (int j = 0; j < 8; j++) {
                memcpy(sc_out + (si * 8 + j) * m + mi0, sct[j], tw);
                memcpy(mn_out + (si * 8 + j) * m + mi0, mnt[j], tw);
            }
            for (int j = 0; j < 128; j++)
                memcpy(qs_out + (si * 128 + j) * m + mi0, qst[j], tw);
        }
    }
}

/* ------------------------------------------------------------------ q5_k */

static inline uint8_t q5k_elem(const uint8_t *qh, const uint8_t *qv, int e) {
    int g = e >> 6, s = (e >> 5) & 1, l = e & 31;
    uint8_t low = s ? (qv[32 * g + l] >> 4) : (qv[32 * g + l] & 0x0F);
    uint8_t hi = (qh[l] >> (2 * g + s)) & 1;
    return (uint8_t)(low | (hi << 4));
}

void q5_k_to_soa_c(const uint8_t *src, int64_t m, int64_t sb,
                   uint16_t *d_out, uint16_t *dmin_out,
                   uint8_t *sc_out, uint8_t *mn_out,
                   uint8_t *qs_out, uint8_t *qh_out) {
#ifdef _OPENMP
    #pragma omp parallel for schedule(static)
#endif
    for (int64_t si = 0; si < sb; si++) {
        for (int64_t mi0 = 0; mi0 < m; mi0 += TILE) {
            int64_t tw = m - mi0 < TILE ? m - mi0 : TILE;
            uint16_t dt[TILE], dmt[TILE];
            uint8_t sct[8][TILE], mnt[8][TILE], qst[128][TILE], qht[32][TILE];
            for (int64_t t = 0; t < tw; t++) {
                const uint8_t *b = src + ((mi0 + t) * sb + si) * 176;
                dt[t] = rd16(b);
                dmt[t] = rd16(b + 2);
                uint8_t sc8[8], mn8[8];
                scale_min_k4(b + 4, sc8, mn8);
                for (int j = 0; j < 8; j++) {
                    sct[j][t] = sc8[j];
                    mnt[j][t] = mn8[j];
                }
                const uint8_t *qh = b + 16, *qv = b + 48;
                uint8_t code[256];
                for (int e = 0; e < 256; e++)
                    code[e] = q5k_elem(qh, qv, e);
                /* plane order (layouts.py _Q4K_PLANE_LO): qs byte row j
                 * packs (block j%8, pos j/8 and +16); qh byte row j packs
                 * the 5th bits of the elements at unpack rows b*32 + j */
                for (int j = 0; j < 128; j++) {
                    int e = (j & 7) * 32 + (j >> 3);
                    qst[j][t] = (uint8_t)((code[e] & 0x0F)
                                          | ((code[e + 16] & 0x0F) << 4));
                }
                for (int j = 0; j < 32; j++) {
                    uint8_t v = 0;
                    for (int bb = 0; bb < 8; bb++) {
                        int r = 32 * bb + j;
                        int e = r < 128
                            ? (r & 7) * 32 + (r >> 3)
                            : ((r - 128) & 7) * 32 + 16 + ((r - 128) >> 3);
                        v |= (uint8_t)((code[e] >> 4) << bb);
                    }
                    qht[j][t] = v;
                }
            }
            memcpy(d_out + si * m + mi0, dt, tw * sizeof(uint16_t));
            memcpy(dmin_out + si * m + mi0, dmt, tw * sizeof(uint16_t));
            for (int j = 0; j < 8; j++) {
                memcpy(sc_out + (si * 8 + j) * m + mi0, sct[j], tw);
                memcpy(mn_out + (si * 8 + j) * m + mi0, mnt[j], tw);
            }
            for (int j = 0; j < 128; j++)
                memcpy(qs_out + (si * 128 + j) * m + mi0, qst[j], tw);
            for (int j = 0; j < 32; j++)
                memcpy(qh_out + (si * 32 + j) * m + mi0, qht[j], tw);
        }
    }
}

/* ------------------------------------------------------------------ q2_k */

static inline uint8_t q2k_elem(const uint8_t *qs, int e) {
    /* disk: per 128-half h, byte 32h+l holds elems 128h+32s+l at shift 2s */
    int h = e >> 7, s = (e & 127) >> 5, l = e & 31;
    return (uint8_t)((qs[32 * h + l] >> (2 * s)) & 3);
}

/* q2/q3 plane order (layouts.py _Q23_PLANE_E): SoA byte row j, shift 2s
 * holds element (j%16)*16 + s*4 + j/16, so unpacked row u = s*64 + j has
 * 16-block id u%16 and the kernel's per-16 scale is a repeat-tile. */
static inline int q23_plane_elem(int s, int j) {
    return (j % 16) * 16 + s * 4 + j / 16;
}

void q2_k_to_soa_c(const uint8_t *src, int64_t m, int64_t sb,
                   uint16_t *d_out, uint16_t *dmin_out,
                   uint8_t *sc_out, uint8_t *mn_out, uint8_t *qs_out) {
#ifdef _OPENMP
    #pragma omp parallel for schedule(static)
#endif
    for (int64_t si = 0; si < sb; si++) {
        for (int64_t mi0 = 0; mi0 < m; mi0 += TILE) {
            int64_t tw = m - mi0 < TILE ? m - mi0 : TILE;
            uint16_t dt[TILE], dmt[TILE];
            uint8_t sct[16][TILE], mnt[16][TILE], qst[64][TILE];
            for (int64_t t = 0; t < tw; t++) {
                const uint8_t *b = src + ((mi0 + t) * sb + si) * 84;
                dt[t] = rd16(b + 80);
                dmt[t] = rd16(b + 82);
                for (int j = 0; j < 16; j++) {
                    sct[j][t] = (uint8_t)(b[j] & 0x0F);
                    mnt[j][t] = (uint8_t)(b[j] >> 4);
                }
                const uint8_t *qs = b + 16;
                for (int j = 0; j < 64; j++)
                    qst[j][t] = (uint8_t)(
                        q2k_elem(qs, q23_plane_elem(0, j))
                        | (q2k_elem(qs, q23_plane_elem(1, j)) << 2)
                        | (q2k_elem(qs, q23_plane_elem(2, j)) << 4)
                        | (q2k_elem(qs, q23_plane_elem(3, j)) << 6));
            }
            memcpy(d_out + si * m + mi0, dt, tw * sizeof(uint16_t));
            memcpy(dmin_out + si * m + mi0, dmt, tw * sizeof(uint16_t));
            for (int j = 0; j < 16; j++) {
                memcpy(sc_out + (si * 16 + j) * m + mi0, sct[j], tw);
                memcpy(mn_out + (si * 16 + j) * m + mi0, mnt[j], tw);
            }
            for (int j = 0; j < 64; j++)
                memcpy(qs_out + (si * 64 + j) * m + mi0, qst[j], tw);
        }
    }
}

/* ------------------------------------------------------------------ q3_k */

void q3_k_to_soa_c(const uint8_t *src, int64_t m, int64_t sb,
                   uint16_t *d_out, int8_t *sc_out,
                   uint8_t *qs_out, uint8_t *qh_out) {
#ifdef _OPENMP
    #pragma omp parallel for schedule(static)
#endif
    for (int64_t si = 0; si < sb; si++) {
        for (int64_t mi0 = 0; mi0 < m; mi0 += TILE) {
            int64_t tw = m - mi0 < TILE ? m - mi0 : TILE;
            uint16_t dt[TILE];
            int8_t sct[16][TILE];
            uint8_t qst[64][TILE], qht[32][TILE];
            for (int64_t t = 0; t < tw; t++) {
                const uint8_t *b = src + ((mi0 + t) * sb + si) * 110;
                dt[t] = rd16(b + 108);
                const uint8_t *sc = b + 96;
                for (int j = 0; j < 16; j++) {
                    int lo = j < 8 ? (sc[j] & 0x0F) : (sc[j - 8] >> 4);
                    int hi = (sc[8 + (j & 3)] >> (2 * (j >> 2))) & 3;
                    sct[j][t] = (int8_t)((lo | (hi << 4)) - 32);
                }
                /* low-2-bit plane: same on-disk packing as q2_k's qs,
                 * re-laid into the q23 plane order */
                const uint8_t *qs = b + 32;
                for (int j = 0; j < 64; j++)
                    qst[j][t] = (uint8_t)(
                        q2k_elem(qs, q23_plane_elem(0, j))
                        | (q2k_elem(qs, q23_plane_elem(1, j)) << 2)
                        | (q2k_elem(qs, q23_plane_elem(2, j)) << 4)
                        | (q2k_elem(qs, q23_plane_elem(3, j)) << 6));
                /* qh plane (layouts.py _Q3K_QH_E): byte r bit bb = high
                 * bit of the element the crumb plane pins to unpacked row
                 * bb*32 + r; disk hmask holds elem e's bit at
                 * hmask[e%32] >> (e/32) */
                for (int r = 0; r < 32; r++) {
                    uint8_t acc = 0;
                    for (int bb = 0; bb < 8; bb++) {
                        int u = bb * 32 + r;
                        int e = q23_plane_elem(u / 64, u % 64);
                        acc |= (uint8_t)(((b[e % 32] >> (e / 32)) & 1)
                                         << bb);
                    }
                    qht[r][t] = acc;
                }
            }
            memcpy(d_out + si * m + mi0, dt, tw * sizeof(uint16_t));
            for (int j = 0; j < 16; j++)
                memcpy(sc_out + (si * 16 + j) * m + mi0, sct[j], tw);
            for (int j = 0; j < 64; j++)
                memcpy(qs_out + (si * 64 + j) * m + mi0, qst[j], tw);
            for (int j = 0; j < 32; j++)
                memcpy(qh_out + (si * 32 + j) * m + mi0, qht[j], tw);
        }
    }
}

/* ------------------------------------------------------------------ q6_k */

static inline uint8_t q6k_elem(const uint8_t *ql, const uint8_t *qh, int e) {
    int h = e >> 7, j = e & 127;
    uint8_t low = j < 64 ? (ql[64 * h + j] & 0x0F) : (ql[64 * h + j - 64] >> 4);
    int sp = (e & 127) >> 5;          /* 32-slot within the half */
    uint8_t hi2 = (qh[32 * h + (e & 31)] >> (2 * sp)) & 3;
    return (uint8_t)(low | (hi2 << 4));
}

void q6_k_to_soa_c(const uint8_t *src, int64_t m, int64_t sb,
                   uint16_t *d_out, int8_t *sc_out,
                   uint8_t *ql_out, uint8_t *qh_out) {
#ifdef _OPENMP
    #pragma omp parallel for schedule(static)
#endif
    for (int64_t si = 0; si < sb; si++) {
        for (int64_t mi0 = 0; mi0 < m; mi0 += TILE) {
            int64_t tw = m - mi0 < TILE ? m - mi0 : TILE;
            uint16_t dt[TILE];
            int8_t sct[16][TILE];
            uint8_t qlt[128][TILE], qht[64][TILE];
            for (int64_t t = 0; t < tw; t++) {
                const uint8_t *b = src + ((mi0 + t) * sb + si) * 210;
                dt[t] = rd16(b + 208);
                for (int j = 0; j < 16; j++)
                    sct[j][t] = (int8_t)b[192 + j];
                const uint8_t *ql = b, *qh = b + 128;
                uint8_t code[256];
                for (int e = 0; e < 256; e++)
                    code[e] = q6k_elem(ql, qh, e);
                /* plane order (layouts.py _Q6K_PLANE_LO / _Q6K_ELEM_AT_ROW):
                 * ql byte row j packs (block j%16, pos j/16 and +8); qh
                 * byte row j packs hi-2-bits of the elements landing at
                 * unpack rows {j, 64+j, 128+j, 192+j} at bit pairs 0..6 */
                for (int j = 0; j < 128; j++) {
                    int e = (j & 15) * 16 + (j >> 4);
                    qlt[j][t] = (uint8_t)((code[e] & 0x0F)
                                          | ((code[e + 8] & 0x0F) << 4));
                }
                for (int j = 0; j < 64; j++) {
                    uint8_t v = 0;
                    for (int p = 0; p < 4; p++) {
                        int r = p * 64 + j;
                        int e = r < 128
                            ? (r & 15) * 16 + (r >> 4)
                            : (r & 15) * 16 + 8 + ((r - 128) >> 4);
                        v |= (uint8_t)((code[e] >> 4) << (2 * p));
                    }
                    qht[j][t] = v;
                }
            }
            memcpy(d_out + si * m + mi0, dt, tw * sizeof(uint16_t));
            for (int j = 0; j < 16; j++)
                memcpy(sc_out + (si * 16 + j) * m + mi0, sct[j], tw);
            for (int j = 0; j < 128; j++)
                memcpy(ql_out + (si * 128 + j) * m + mi0, qlt[j], tw);
            for (int j = 0; j < 64; j++)
                memcpy(qh_out + (si * 64 + j) * m + mi0, qht[j], tw);
        }
    }
}
