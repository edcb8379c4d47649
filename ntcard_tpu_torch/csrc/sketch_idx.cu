// K1: canonical ntHash, sampling and bucketing of every window of a code
// batch, for every k. Replaces the Pallas kernel
// ntcard_tpu/ops/nthash_pallas.py::sketch_idx_pallas (_sketch_kernel), and
// computes its contract exactly: [B, L] codes (0-3 ACGT, 4 N) -> [nK, B, L]
// int32 emit indices, each a table index in [0, 2^(r+1)), or S0 = 2^(r+1)
// for a valid but unsampled window, or S1 = S0 + 1 for a window that holds
// an N or starts at or past `stride`.
//
// What bounds it on an H100: the 64-bit integer work of the hash (about 20
// ALU operations per window and k) and the int32 stores of the output,
// 4 * nK bytes per code read. The TPU kernel builds every window hash from
// rotated prefix XORs with log-depth lane rolls, because the TPU has no
// 64-bit lanes and no cheap sequential loop; Hopper has native uint64 and
// independent threads, so each thread takes one row segment of SEG window
// starts, hashes the first window directly and rolls the ntHash recurrence
// (nthash.hpp:242-257) one base at a time through the rest. Rolling through
// an N is exact (N contributes seed 0 on entry and on exit), so validity is
// a running N count. Threads of a warp take neighbouring rows, so with the
// position-major [L, B] stream the main path passes (strides 1, B) every
// code load of a warp is one coalesced transaction.

#include <cstdint>
#include <cuda_runtime.h>

typedef unsigned long long u64;

#define SEG 64
#define THREADS 256

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

__global__ void __launch_bounds__(THREADS) sketch_idx_kernel(
    const uint8_t* __restrict__ codes, long long sb, long long sl, int B, int L,
    const int* __restrict__ ks, int nk, const long long* __restrict__ seeds,
    int stride, int s_bits, int r_bits, int* __restrict__ out) {
    const int nseg = (L + SEG - 1) / SEG;
    const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (tid >= (long long)B * nseg) return;
    const int b = (int)(tid % B);
    const int p0 = (int)(tid / B) * SEG;
    const int p1 = min(p0 + SEG, L);
    const int pv = max(p0, min(p1, stride));  // [p0, pv) are owned starts
    const uint8_t* row = codes + (long long)b * sb;

    u64 sd[5], cs[5];
#pragma unroll
    for (int c = 0; c < 5; ++c) {
        sd[c] = (u64)seeds[c];
        cs[c] = (u64)seeds[5 + c];
    }
    const unsigned r_buck = 1u << r_bits;
    const int sent0 = (int)(2u * r_buck), sent1 = sent0 + 1;
    const unsigned s_mask = (1u << (s_bits - 1)) - 1u;

    for (int t = 0; t < nk; ++t) {
        int* o = out + ((long long)t * B + b) * L;
        if (p0 < pv) {
            const int k = ks[t];
            u64 rf[5], rc[5];  // P^k(seed(c)) and P^k(seed(comp c))
#pragma unroll
            for (int c = 0; c < 5; ++c) {
                rf[c] = srol_n(sd[c], k);
                rc[c] = srol_n(cs[c], k);
            }
            // direct hash of the window at p0 (nthash.hpp:220-239)
            u64 F = 0, R = 0;
            int nn = 0;
            for (int j = 0; j < k; ++j) {
                unsigned c = row[(long long)(p0 + j) * sl];
                F = srol1(F) ^ pick(sd, c);
                nn += c == 4;
            }
            for (int j = k - 1; j >= 0; --j) {
                unsigned c = row[(long long)(p0 + j) * sl];
                R = srol1(R) ^ pick(cs, c);
            }
            for (int p = p0; p < pv; ++p) {
                if (p > p0) {  // roll one base: out = p-1, in = p+k-1
                    unsigned co = row[(long long)(p - 1) * sl];
                    unsigned ci = row[(long long)(p + k - 1) * sl];
                    F = srol1(F) ^ pick(sd, ci) ^ pick(rf, co);
                    R = sror1(R ^ pick(rc, ci) ^ pick(cs, co));
                    nn += (int)(ci == 4) - (int)(co == 4);
                }
                const u64 h = F < R ? F : R;
                const unsigned hi = (unsigned)(h >> 32), lo = (unsigned)h;
                const bool s0 = (hi >> (31 - s_bits)) == 1u;
                const bool s1 = (hi >> (32 - s_bits)) == s_mask;
                int idx = (int)(lo & (r_buck - 1u)) + (s1 ? (int)r_buck : 0);
                idx = (s0 || s1) ? idx : sent0;
                o[p] = nn ? sent1 : idx;
            }
        }
        for (int p = pv; p < p1; ++p) o[p] = sent1;
    }
}

// codes: uint8 [B, L] with element strides (sb, sl); ks: int32 [nk] on the
// device; seeds: int64 [10] on the device (seed by code, then the
// complement base's seed by code); out: int32 [nk, B, L] contiguous.
// Requires stride + max(ks) - 1 <= L (the wrapper checks). Returns the
// cudaError_t of the launch.
extern "C" int ntc_sketch_idx(const void* codes, long long sb, long long sl, int B, int L,
                              const void* ks, int nk, const void* seeds, int stride,
                              int s_bits, int r_bits, void* out, void* stream) {
    const long long n = (long long)B * ((L + SEG - 1) / SEG);
    if (n == 0) return 0;
    const int grid = (int)((n + THREADS - 1) / THREADS);
    sketch_idx_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)codes, sb, sl, B, L, (const int*)ks, nk, (const long long*)seeds,
        stride, s_bits, r_bits, (int*)out);
    return (int)cudaGetLastError();
}
