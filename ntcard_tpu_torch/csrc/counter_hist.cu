// K4: per-row histogram of the count table's uint16-wrapped counters,
// v & 0xFFFF, over bins [0, nbins); bin 0 counts the wrapped zeros. This is
// compEst's p[sample][v] table scan (ntcard.cpp:240-247). Replaces the Pallas
// kernel ntcard_tpu/ops/scatter_pallas.py::compact_pallas in prefilter mode
// (with the histogram ntcard_tpu/models/sketch.py::_hist_row_sparse_parts
// builds from it), and is exact for every nbins in [1, 65536]: there is no
// compaction cap and so no dense-row fallback.
//
// What bounds it on an H100: reading the table once, 4 bytes a bucket
// (1 GiB a k at the default r = 27). The JAX package routes by nbins
// (a compare-reduce for nbins <= 32, the sparse compaction for
// 32 < nbins < 65536, a full scatter at 65536, and a dense fallback when a
// row overflows the compaction cap, models/sketch.py:570-592); all of that
// works around the TPU's per-element scatter cost and its VMEM limits and is
// not ported. Here each block keeps a private histogram in shared memory
// while nbins * 4 bytes fits the opt-in limit (227 KB on an H100) and adds
// it to the output once; above that the same kernel adds into the output
// with global atomics. Zero counters, most of a sparse table, are counted
// per thread and summed across the warp with shuffles, so the hottest bin
// costs one atomic per warp.

#include <cuda_runtime.h>

#define THREADS 256
#define BLOCKS_PER_ROW_MAX 264

__global__ void __launch_bounds__(THREADS) counter_hist_kernel(
    const int* __restrict__ table, long long row_len, int nbins, int* __restrict__ out,
    int use_smem) {
    extern __shared__ int sh[];
    const int* r = table + (long long)blockIdx.y * row_len;
    int* o = out + (long long)blockIdx.y * nbins;
    int* h = use_smem ? sh : o;
    if (use_smem) {
        for (int b = threadIdx.x; b < nbins; b += blockDim.x) sh[b] = 0;
        __syncthreads();
    }
    unsigned zeros = 0;
    const long long step = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < row_len; i += step) {
        const int v = r[i] & 0xFFFF;
        if (v == 0)
            ++zeros;
        else if (v < nbins)
            atomicAdd(&h[v], 1);
    }
    for (int s = 16; s > 0; s >>= 1) zeros += __shfl_down_sync(0xffffffffu, zeros, s);
    if ((threadIdx.x & 31u) == 0 && zeros) atomicAdd(&h[0], (int)zeros);
    if (use_smem) {
        __syncthreads();
        for (int b = threadIdx.x; b < nbins; b += blockDim.x)
            if (sh[b]) atomicAdd(&o[b], sh[b]);
    }
}

// table: int32 [nrows, row_len] contiguous; out: int32 [nrows, nbins]
// zeroed; 1 <= nbins <= 65536. Returns the cudaError_t.
extern "C" int ntc_counter_hist(const void* table, long long row_len, int nrows, int nbins,
                                void* out, void* stream) {
    if (row_len == 0 || nrows == 0) return 0;
    int dev = 0, smem_max = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;
    const size_t smem = (size_t)nbins * sizeof(int);
    const int use_smem = smem <= (size_t)smem_max;
    if (use_smem && smem > 48 * 1024) {
        err = cudaFuncSetAttribute(counter_hist_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    long long bx = (row_len + THREADS * 8 - 1) / (THREADS * 8);
    long long cap = BLOCKS_PER_ROW_MAX / nrows > 0 ? BLOCKS_PER_ROW_MAX / nrows : 1;
    dim3 grid((unsigned)(bx < cap ? bx : cap), (unsigned)nrows);
    counter_hist_kernel<<<grid, THREADS, use_smem ? smem : 0, (cudaStream_t)stream>>>(
        (const int*)table, row_len, nbins, (int*)out, use_smem);
    return (int)cudaGetLastError();
}
