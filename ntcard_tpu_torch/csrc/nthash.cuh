// The rolling canonical ntHash on the device. P = srol rotates a 33-bit
// ring in bits 0..32 and a 31-bit ring in bits 33..63 left by one
// (nthash.hpp:185-217). K1 (sketch_idx.cu) takes the split rotations and
// builds its own table-driven roll; K5 (hll_update.cu) also takes the code
// select and the one-base step below.
#pragma once

#include <cstdint>

typedef unsigned long long u64;

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

// 5-entry table lookup by code as a select chain (stays in registers);
// codes above 3 read entry 4 (N), as the JAX select chain does
__device__ __forceinline__ u64 pick(const u64 (&a)[5], unsigned c) {
    return c == 0 ? a[0] : c == 1 ? a[1] : c == 2 ? a[2] : c == 3 ? a[3] : a[4];
}

// Per-k seed tables in registers: seed(c), seed(comp c), and both rotated
// by P^k. `seeds` is int64 [10] on the device: seed by code, then the
// complement base's seed by code.
struct NtSeeds {
    u64 sd[5], cs[5], rf[5], rc[5];
    __device__ __forceinline__ NtSeeds(const long long* __restrict__ seeds, int k) {
#pragma unroll
        for (int c = 0; c < 5; ++c) {
            sd[c] = (u64)seeds[c];
            cs[c] = (u64)seeds[5 + c];
            rf[c] = srol_n(sd[c], k);
            rc[c] = srol_n(cs[c], k);
        }
    }
};

// Forward and reverse hash and N count of the window [p, p + k) of a row
// with element stride sl: hashed directly when `first` (nthash.hpp:220-239),
// else rolled one base on from the window at p - 1 (nthash.hpp:242-257).
// Rolling through an N is exact (N contributes seed 0 on entry and on
// exit), so the window is N-free exactly when nn is 0.
__device__ __forceinline__ void nthash_step(const uint8_t* row, long long sl, int p, int k,
                                            bool first, const NtSeeds& t, u64& F, u64& R,
                                            int& nn) {
    if (first) {
        F = 0, R = 0, nn = 0;
        for (int j = 0; j < k; ++j) {
            unsigned c = row[(long long)(p + j) * sl];
            F = srol1(F) ^ pick(t.sd, c);
            nn += c == 4;
        }
        for (int j = k - 1; j >= 0; --j) {
            unsigned c = row[(long long)(p + j) * sl];
            R = srol1(R) ^ pick(t.cs, c);
        }
        return;
    }
    unsigned co = row[(long long)(p - 1) * sl];  // leaves the window
    unsigned ci = row[(long long)(p + k - 1) * sl];  // enters it
    F = srol1(F) ^ pick(t.sd, ci) ^ pick(t.rf, co);
    R = sror1(R ^ pick(t.rc, ci) ^ pick(t.cs, co));
    nn += (int)(ci == 4) - (int)(co == 4);
}
