// K5: nthll's HyperLogLog register update, fused with the canonical ntHash
// of every owned window of a code batch. The JAX package computes it as XLA
// code, not Pallas: ntcard_tpu/models/hll.py:27-30 (_update), the scatter
// max regs.at[reg].max(run0) over ntcard_tpu/ops/nthash.py::hll_scan. Its
// contract: [B, L] codes (0-3 ACGT, 4 N), for every N-free window starting
// at p < stride, reg = h & (2^n - 1) and run0 = clz64(h & ~(2^n - 1)) (no
// update when that value is 0), regs[reg] = max(regs[reg], run0).
//
// What bounds it on an H100: the 64-bit hash work, as in K1: it reads each
// code about twice and writes only registers. The plain version
// materialises every window's hash chain and its (reg, run0) pair
// in device memory before a scatter; here each thread takes one row
// segment of SEG window starts with K1's layout (neighbouring threads on
// neighbouring rows, so position-major code loads coalesce) and rolls the
// shared ntHash recurrence (nthash.cuh). A register only grows, so a thread
// reads it first and calls atomicMax only when run0 is larger: after
// the first batches nearly every window is settled by that read.

#include <cstdint>
#include <cuda_runtime.h>

#include "nthash.cuh"

#define SEG 64
#define THREADS 256

__global__ void __launch_bounds__(THREADS) hll_update_kernel(
    const uint8_t* __restrict__ codes, long long sb, long long sl, int B, int k,
    const long long* __restrict__ seeds, int stride, int n_bits, int* regs) {
    const int nseg = (stride + SEG - 1) / SEG;
    const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (tid >= (long long)B * nseg) return;
    const int b = (int)(tid % B);
    const int p0 = (int)(tid / B) * SEG;
    const int p1 = min(p0 + SEG, stride);  // [p0, p1) are owned starts
    const uint8_t* row = codes + (long long)b * sb;
    const u64 mask = (1ULL << n_bits) - 1ULL;

    const NtSeeds seed(seeds, k);
    u64 F = 0, R = 0;
    int nn = 0;
    for (int p = p0; p < p1; ++p) {
        nthash_step(row, sl, p, k, p == p0, seed, F, R, nn);
        const u64 h = F < R ? F : R;
        const u64 high = h & ~mask;
        if (nn || !high) continue;
        const int run0 = __clzll((long long)high);
        int* reg = regs + (h & mask);
        if (run0 > *(volatile int*)reg) atomicMax(reg, run0);
    }
}

// codes: uint8 [B, L] with element strides (sb, sl); seeds: int64 [10] on
// the device (seed by code, then the complement base's seed by code); regs:
// int32 [2^n_bits] on the device, updated in place. Requires stride + k - 1
// <= L and n_bits in [1, 31] (the wrapper checks). Returns the cudaError_t
// of the launch.
extern "C" int ntc_hll_update(const void* codes, long long sb, long long sl, int B, int k,
                              const void* seeds, int stride, int n_bits, void* regs,
                              void* stream) {
    const long long n = (long long)B * ((stride + SEG - 1) / SEG);
    if (n == 0) return 0;
    const int grid = (int)((n + THREADS - 1) / THREADS);
    hll_update_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)codes, sb, sl, B, k, (const long long*)seeds, stride, n_bits,
        (int*)regs);
    return (int)cudaGetLastError();
}
