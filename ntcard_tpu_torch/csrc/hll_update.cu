// K5: nthll's HyperLogLog register update, fused with the canonical ntHash
// of every owned window of a code batch. The JAX package computes it as XLA
// code, not Pallas: ntcard_tpu/models/hll.py:27-30 (_update), the scatter
// max regs.at[reg].max(run0) over ntcard_tpu/ops/nthash.py::hll_scan. Its
// contract: [B, L] codes (0-3 ACGT, 4 N), for every N-free window starting
// at p < stride, reg = h & (2^n - 1) and run0 = clz64(h & ~(2^n - 1)) (no
// update when that value is 0), regs[reg] = max(regs[reg], run0).
//
// What bounds it on an H100: the 64-bit hash work, as in K1: it reads each
// code once and writes only registers. The plain version materialises
// every window's hash chain and its (reg, run0) pair in device memory
// before a scatter. Here:
//
// * the hash is K1's (nthash.cuh): a block takes 32 rows (one per lane) by
//   TP window starts, reads the code tile once into shared memory, hashes
//   each 32-base sub-block once, composes each warp segment's first window
//   from them and rolls with the two 36-entry tables of this k;
// * most windows touch no register. A first launch (reg_min_kernel)
//   reduces the registers to per-block minima, and the update reduces those
//   to a floor below every register. A register only grows, so a window
//   whose run0 does not beat the floor cannot raise one: it skips the read
//   and the atomic, exactly. The others read their register and call
//   atomicMax only when run0 is larger. No state is kept between calls.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "nthash.cuh"

#define WARPS 8
#define THREADS (ROWS * WARPS)
#define SEG 32              // window starts of a thread (one warp: one segment)
#define TP (WARPS * SEG)    // window starts of a block tile
#define MIN_THREADS 256
#define MIN_BLOCKS 256      // at most this many partial minima

static_assert(SEG % SUB == 0, "segments start on sub-block boundaries");

__host__ __device__ inline int align16(int b) { return (b + 15) & ~15; }

// Byte offsets into the block's dynamic shared memory.
struct Layout {
    int tf, tr, f36, r36, subf, subr, subn, codes, total;
    int W, nsub;
    __host__ __device__ Layout(int k) {
        W = TP + k - 1;  // the tile's codes: its window starts and their reach
        nsub = W / SUB;
        int o = 0;
        tf = o, o += align16(SUB * NC * 8);
        tr = o, o += align16(SUB * NC * 8);
        f36 = o, o += align16(NC * NC * 8);
        r36 = o, o += align16(NC * NC * 8);
        subf = o, o += align16(nsub * ROWS * 8);
        subr = o, o += align16(nsub * ROWS * 8);
        subn = o, o += align16(nsub * ROWS);
        codes = o, o += align16(W * ROWS);
        total = o;
    }
};

// partial[blockIdx.x] = the least register of a grid-stride share
__global__ void __launch_bounds__(MIN_THREADS) reg_min_kernel(const int* __restrict__ regs,
                                                             long long n, int* __restrict__ partial) {
    __shared__ int wmin[MIN_THREADS / 32];
    int m = INT_MAX;
    const long long step = (long long)gridDim.x * MIN_THREADS;
#pragma unroll 4
    for (long long i = (long long)blockIdx.x * MIN_THREADS + threadIdx.x; i < n; i += step)
        m = min(m, regs[i]);
    for (int s = 16; s > 0; s >>= 1) m = min(m, __shfl_xor_sync(0xffffffffu, m, s));
    if ((threadIdx.x & 31) == 0) wmin[threadIdx.x >> 5] = m;
    __syncthreads();
    if (threadIdx.x == 0) {
        for (int w = 1; w < MIN_THREADS / 32; ++w) m = min(m, wmin[w]);
        partial[blockIdx.x] = m;
    }
}

__global__ void __launch_bounds__(THREADS, 4) hll_update_kernel(
    const uint8_t* __restrict__ codes, long long sb, long long sl, int B, int L, int k,
    const long long* __restrict__ seeds, int stride, int n_bits, int* regs,
    const int* __restrict__ partial, int n_partial) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ int floor_s;
    const Layout lay(k);
    u64* tf = (u64*)(smem + lay.tf);
    u64* tr = (u64*)(smem + lay.tr);
    u64* f36 = (u64*)(smem + lay.f36);
    u64* r36 = (u64*)(smem + lay.r36);
    u64* subf = (u64*)(smem + lay.subf);
    u64* subr = (u64*)(smem + lay.subr);
    uint8_t* subn = smem + lay.subn;
    uint8_t* cs = smem + lay.codes;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int row0 = blockIdx.y * ROWS, p_tile = blockIdx.x * TP;

    fill_sub_tables(tf, tr, seeds, threadIdx.x, THREADS);
    for (int e = threadIdx.x; e < NC * NC; e += THREADS) roll_entry(e, k, seeds, f36[e], r36[e]);
    load_code_tile(cs, codes, sb, sl, B, L, row0, p_tile, lay.W, threadIdx.x, THREADS);
    if (warp == WARPS - 1) {  // the floor: the least of the partial minima
        int m = INT_MAX;
        for (int i = lane; i < n_partial; i += 32) m = min(m, partial[i]);
        for (int s = 16; s > 0; s >>= 1) m = min(m, __shfl_xor_sync(0xffffffffu, m, s));
        if (lane == 0) floor_s = m;
    }
    __syncthreads();
    hash_sub_blocks(cs, tf, tr, subf, subr, subn, lay.nsub, threadIdx.x, THREADS);
    __syncthreads();

    const int q0 = warp * SEG, p0 = p_tile + q0;
    if (p0 >= stride) return;  // no owned window start in this warp's segment
    const int n_own = min(SEG, stride - p0);
    const int floor = floor_s;
    const uint8_t* col = cs + lane;  // this thread's row
    const u64 mask = (1ULL << n_bits) - 1ULL;
    u64 F, R;
    int nn;
    first_window(col, lane, q0, k, tf, tr, subf, subr, subn, F, R, nn);
    for (int j = 0; j < n_own; ++j) {
        if (j > 0) roll(col, q0 + j, k, f36, r36, F, R, nn);
        const u64 h = F < R ? F : R;
        const u64 high = h & ~mask;
        if (nn || !high) continue;
        const int run0 = __clzll((long long)high);
        if (run0 <= floor) continue;  // no register is below the floor
        int* reg = regs + (h & mask);
        if (run0 > *(volatile int*)reg) atomicMax(reg, run0);
    }
}

// codes: uint8 [B, L] with element strides (sb, sl); seeds: int64 [10] on
// the device (seed by code, then the complement base's seed by code); regs:
// int32 [2^n_bits] on the device, updated in place; partial: int32
// [ntc_hll_partials(n_bits)] device scratch. Requires stride + k - 1 <= L
// and n_bits in [1, 31] (the wrapper checks), and a tile that fits the
// opt-in shared memory (k up to about 5,000). Two launches: the register
// minima, then the update. Returns the cudaError_t of the first that fails.
extern "C" int ntc_hll_partials(int n_bits) {
    const long long n = 1LL << n_bits;
    const long long blocks = (n + MIN_THREADS * 16 - 1) / (MIN_THREADS * 16);
    return (int)(blocks < MIN_BLOCKS ? blocks : MIN_BLOCKS);
}

extern "C" int ntc_hll_update(const void* codes, long long sb, long long sl, int B, int L, int k,
                              const void* seeds, int stride, int n_bits, void* regs,
                              void* partial, void* stream) {
    if (B == 0 || stride == 0) return 0;
    const Layout lay(k);
    int dev = 0, smem_max = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;
    if (lay.total + 16 > smem_max) return (int)cudaErrorInvalidValue;
    if (lay.total > 47 * 1024) {  // beside the floor's static word
        err = cudaFuncSetAttribute(hll_update_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   lay.total);
        if (err != cudaSuccess) return (int)err;
    }
    const int n_partial = ntc_hll_partials(n_bits);
    reg_min_kernel<<<n_partial, MIN_THREADS, 0, (cudaStream_t)stream>>>(
        (const int*)regs, 1LL << n_bits, (int*)partial);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)((stride + TP - 1) / TP), (unsigned)((B + ROWS - 1) / ROWS));
    hll_update_kernel<<<grid, THREADS, lay.total, (cudaStream_t)stream>>>(
        (const uint8_t*)codes, sb, sl, B, L, k, (const long long*)seeds, stride, n_bits,
        (int*)regs, (const int*)partial, n_partial);
    return (int)cudaGetLastError();
}
