// The rolling canonical ntHash on the device, shared by K1 (sketch_idx.cu)
// and K5 (hll_update.cu). P = srol rotates a 33-bit ring in bits 0..32 and a
// 31-bit ring in bits 33..63 left by one (nthash.hpp:185-217).
//
// Both kernels take the same block tile: ROWS = 32 rows (one per lane) by a
// run of window starts, with the codes of the starts and their reach read
// once into shared memory, position-major ([position][row]), so a warp's
// lanes read 32 rows of one position at a time. On that tile:
//
// * every aligned SUB-base sub-block is hashed once (one table XOR a base,
//   tables of pre-rotated seeds), and a thread's first window is the Horner
//   sum of k / SUB sub-block hashes under P^SUB plus a direct remainder of
//   k % SUB bases: F(XY) = P^|Y| F(X) ^ F(Y), R(XY) = R(X) ^ P^|X| R(Y);
// * a roll step looks up one 36-entry table of F terms and one of R terms,
//   each indexed by the (incoming, outgoing) code pair, in place of four
//   five-way selects (nthash.hpp:242-257).
//
// Codes above 4 are not N but hash as N (seed 0), as the plain versions'
// lookup does; the tile holds min(code, 5) and the tables give code 5 code
// 4's entries. Rolling through an N is exact (N contributes seed 0 on entry
// and on exit), so validity is a running N count.
#pragma once

#include <cstdint>

typedef unsigned long long u64;

#define ROWS 32  // rows of a block tile: one per lane
#define SUB 32   // bases of a sub-block hash
#define NC 6     // table entries by code: ACGT, N, any other code

// split rotate left by one: 33-bit ring in bits 0..32, 31-bit ring in 33..63
__device__ __forceinline__ u64 srol1(u64 x) {
    u64 m = ((x & 0x8000000000000000ULL) >> 30) | ((x & 0x100000000ULL) >> 32);
    return ((x << 1) & 0xFFFFFFFDFFFFFFFFULL) | m;
}

// split rotate right by one (inverse of srol1)
__device__ __forceinline__ u64 sror1(u64 x) {
    u64 m = ((x & 0x200000000ULL) << 30) | ((x & 1ULL) << 32);
    return ((x >> 1) & 0xFFFFFFFEFFFFFFFFULL) | m;
}

// P^n: rotate each ring by n mod its width
__device__ __forceinline__ u64 srol_n(u64 x, int n) {
    const u64 m33 = (1ULL << 33) - 1, m31 = (1ULL << 31) - 1;
    int s33 = n % 33, s31 = n % 31;
    u64 lo = x & m33, hi = x >> 33;
    if (s33) lo = ((lo << s33) | (lo >> (33 - s33))) & m33;
    if (s31) hi = ((hi << s31) | (hi >> (31 - s31))) & m31;
    return (hi << 33) | lo;
}

// `seeds` below is int64 [10] on the device: seed by code, then the
// complement base's seed by code.

// The sub-block tables, [SUB][NC] each: tf = P^(SUB-1-j) seed(c), tr =
// P^j seed(comp c); filled by threads tid, tid + nthreads, ...
__device__ __forceinline__ void fill_sub_tables(u64* tf, u64* tr, const long long* seeds,
                                                int tid, int nthreads) {
    for (int i = tid; i < SUB * NC; i += nthreads) {
        const int j = i / NC, c = min(i % NC, 4);
        tf[i] = srol_n((u64)seeds[c], SUB - 1 - j);
        tr[i] = srol_n((u64)seeds[5 + c], j);
    }
}

// Entry e = ci * NC + co of one k's roll tables: F term seed(ci) ^ P^k
// seed(co), R term P^k seed(comp ci) ^ seed(comp co)
__device__ __forceinline__ void roll_entry(int e, int k, const long long* seeds, u64& f, u64& r) {
    const int ci = min(e / NC, 4), co = min(e % NC, 4);
    f = (u64)seeds[ci] ^ srol_n((u64)seeds[co], k);
    r = srol_n((u64)seeds[5 + ci], k) ^ (u64)seeds[5 + co];
}

// The code tile cs [W][ROWS] of rows row0.. and positions p_tile.., as
// min(code, 5), N outside [B, L); lanes along whichever axis is contiguous
// in memory, so the loads coalesce
__device__ __forceinline__ void load_code_tile(uint8_t* cs, const uint8_t* __restrict__ codes,
                                               long long sb, long long sl, int B, int L,
                                               int row0, int p_tile, int W, int tid,
                                               int nthreads) {
    for (int i = tid; i < W * ROWS; i += nthreads) {
        int q, r;
        if (sl == 1) q = i % W, r = i / W;
        else q = i / ROWS, r = i % ROWS;
        const int b = row0 + r, p = p_tile + q;
        unsigned c = 4;
        if (b < B && p < L) c = min((unsigned)codes[(long long)b * sb + (long long)p * sl], 5u);
        cs[q * ROWS + r] = (uint8_t)c;
    }
}

// F, R and N count of every aligned sub-block of the tile, [nsub][ROWS]
__device__ __forceinline__ void hash_sub_blocks(const uint8_t* cs, const u64* tf, const u64* tr,
                                                u64* subf, u64* subr, uint8_t* subn, int nsub,
                                                int tid, int nthreads) {
    for (int i = tid; i < nsub * ROWS; i += nthreads) {
        const uint8_t* col = cs + (i / ROWS) * SUB * ROWS + i % ROWS;
        u64 f = 0, r = 0;
        int n = 0;
#pragma unroll 8
        for (int j = 0; j < SUB; ++j) {
            const unsigned c = col[j * ROWS];
            f ^= tf[j * NC + c];
            r ^= tr[j * NC + c];
            n += c == 4;
        }
        subf[i] = f, subr[i] = r, subn[i] = (uint8_t)n;
    }
}

// The window [q0, q0 + k) of tile row `lane` (col = cs + lane), q0 a
// multiple of SUB: its F, R and N count from the sub-block hashes and a
// direct remainder of k % SUB bases
__device__ __forceinline__ void first_window(const uint8_t* col, int lane, int q0, int k,
                                             const u64* tf, const u64* tr, const u64* subf,
                                             const u64* subr, const uint8_t* subn, u64& F,
                                             u64& R, int& nn) {
    const int m = k / SUB, rem = k % SUB, blk0 = q0 / SUB;
    u64 Fz = 0;
    F = 0, R = 0, nn = 0;
    for (int j = 0; j < rem; ++j) {
        const unsigned c = col[(q0 + SUB * m + j) * ROWS];
        Fz ^= tf[(SUB - rem + j) * NC + c];
        R ^= tr[j * NC + c];
        nn += c == 4;
    }
    for (int i = 0; i < m; ++i) {
        F = srol_n(F, SUB) ^ subf[(blk0 + i) * ROWS + lane];
        nn += subn[(blk0 + i) * ROWS + lane];
    }
    F = srol_n(F, rem) ^ Fz;
    for (int i = m - 1; i >= 0; --i) R = srol_n(R, SUB) ^ subr[(blk0 + i) * ROWS + lane];
}

// Roll the window at tile position q - 1 of row col on to q, through one
// k's roll tables ft and rt
__device__ __forceinline__ void roll(const uint8_t* col, int q, int k, const u64* ft,
                                     const u64* rt, u64& F, u64& R, int& nn) {
    const unsigned co = col[(q - 1) * ROWS], ci = col[(q + k - 1) * ROWS];
    const int e = ci * NC + co;
    F = srol1(F) ^ ft[e];
    R = sror1(R ^ rt[e]);
    nn += (int)(ci == 4) - (int)(co == 4);
}
