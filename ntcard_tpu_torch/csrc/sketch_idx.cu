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
//
// Spaced seeds (ntcard -g, a single k): each masked position p's seed
// contributions are XORed out of the window's output F and R before the
// canonical min (ntcard_tpu/ops/nthash.py:371-383), from two small strip
// tables the wrapper keeps on the device; that costs n_mask more code
// loads and table reads a window. Validity stays the full-window N count.

#include <cstdint>
#include <cuda_runtime.h>

#include "nthash.cuh"

#define SEG 64
#define THREADS 256

__global__ void __launch_bounds__(THREADS) sketch_idx_kernel(
    const uint8_t* __restrict__ codes, long long sb, long long sl, int B, int L,
    const int* __restrict__ ks, int nk, const long long* __restrict__ seeds,
    const int* __restrict__ mpos, const long long* __restrict__ mf,
    const long long* __restrict__ mr, int n_mask, int stride, int s_bits, int r_bits,
    int* __restrict__ out) {
    const int nseg = (L + SEG - 1) / SEG;
    const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (tid >= (long long)B * nseg) return;
    const int b = (int)(tid % B);
    const int p0 = (int)(tid / B) * SEG;
    const int p1 = min(p0 + SEG, L);
    const int pv = max(p0, min(p1, stride));  // [p0, pv) are owned starts
    const uint8_t* row = codes + (long long)b * sb;

    const unsigned r_buck = 1u << r_bits;
    const int sent0 = (int)(2u * r_buck), sent1 = sent0 + 1;
    const unsigned s_mask = (1u << (s_bits - 1)) - 1u;

    for (int t = 0; t < nk; ++t) {
        int* o = out + ((long long)t * B + b) * L;
        if (p0 < pv) {
            const NtSeeds seed(seeds, ks[t]);
            u64 F = 0, R = 0;
            int nn = 0;
            for (int p = p0; p < pv; ++p) {
                nthash_step(row, sl, p, ks[t], p == p0, seed, F, R, nn);
                // spaced seeds strip the masked positions from this window's
                // output only; the rolling state stays the full-k hash
                u64 f = F, r = R;
                for (int m = 0; m < n_mask; ++m) {
                    const unsigned c = min((unsigned)row[(long long)(p + mpos[m]) * sl], 4u);
                    f ^= (u64)mf[m * 5 + c];
                    r ^= (u64)mr[m * 5 + c];
                }
                const u64 h = f < r ? f : r;
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
// complement base's seed by code); spaced seeds (nk == 1 only): mpos int32
// [n_mask] masked positions, mf and mr int64 [n_mask, 5] strip tables by
// code (P^(k-1-p)(seed(c)) and P^p(seed(comp c))), all null when n_mask is
// 0; out: int32 [nk, B, L] contiguous. Requires stride + max(ks) - 1 <= L
// (the wrapper checks). Returns the cudaError_t of the launch.
extern "C" int ntc_sketch_idx(const void* codes, long long sb, long long sl, int B, int L,
                              const void* ks, int nk, const void* seeds, const void* mpos,
                              const void* mf, const void* mr, int n_mask, int stride,
                              int s_bits, int r_bits, void* out, void* stream) {
    const long long n = (long long)B * ((L + SEG - 1) / SEG);
    if (n == 0) return 0;
    const int grid = (int)((n + THREADS - 1) / THREADS);
    sketch_idx_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)codes, sb, sl, B, L, (const int*)ks, nk, (const long long*)seeds,
        (const int*)mpos, (const long long*)mf, (const long long*)mr, n_mask, stride, s_bits,
        r_bits, (int*)out);
    return (int)cudaGetLastError();
}
