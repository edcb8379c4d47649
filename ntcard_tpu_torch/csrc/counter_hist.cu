// K4: per-row histogram of the count table's uint16-wrapped counters,
// v & 0xFFFF, over bins [0, nbins); bin 0 counts the wrapped zeros. This is
// compEst's p[sample][v] table scan (ntcard.cpp:240-247). Replaces the Pallas
// kernel ntcard_tpu/ops/scatter_pallas.py::compact_pallas in prefilter mode
// (with the histogram ntcard_tpu/models/sketch.py::_hist_row_sparse_parts
// builds from it), and is exact for every nbins in [1, 65536]: there is no
// compaction cap and so no dense-row fallback.
//
// What bounds it on an H100: reading the table once, 4 bytes a bucket
// (1 GiB a k at the default r = 27), so the memory needs a few MB of loads
// in flight. The JAX package routes by nbins (a compare-reduce for
// nbins <= 32, the sparse compaction for 32 < nbins < 65536, a full scatter
// at 65536, and a dense fallback when a row overflows the compaction cap,
// models/sketch.py:570-592); all of that works around the TPU's
// per-element scatter cost and its VMEM limits and is not ported. Here:
//
// * one launch covers every row (grid y), and the grid holds as many blocks
//   as fit on every SM at once for this nbins (the occupancy query; eight
//   of 256 threads, the whole SM, while the histogram takes at most 28 KB),
//   so every thread slot of the card streams;
// * each thread keeps UNROLL 16-byte loads in flight (evict-first, the
//   table is read once), with a scalar head up to the row's first 16-byte
//   boundary and a scalar tail;
// * each block keeps a private histogram of bins [0, sbins) in shared
//   memory and adds it to the output once: every bin while nbins * 4 bytes
//   fits the opt-in limit (227 KB on an H100), else as many low bins as fit,
//   with global atomics into the output for the bins above (counters are
//   mostly small, so few values reach them);
// * zero counters, most of a sparse table, are counted per thread and
//   summed across the warp with shuffles, so the hottest bin costs one
//   atomic per warp.

#include <cstdint>
#include <cuda_runtime.h>

#define THREADS 256
#define UNROLL 4

// bins [0, sbins) go to the block's shared histogram sh, bins [sbins,
// nbins) straight to the output row o; zeros are counted per thread
struct Tally {
    int nbins, sbins;
    int *sh, *o;
    unsigned zeros;
    __device__ __forceinline__ void add(int v) {
        v &= 0xFFFF;
        if (v == 0)
            ++zeros;
        else if (v < sbins)
            atomicAdd(&sh[v], 1);
        else if (v < nbins)
            atomicAdd(&o[v], 1);
    }
    __device__ __forceinline__ void add4(int4 a) {
        add(a.x);
        add(a.y);
        add(a.z);
        add(a.w);
    }
};

__global__ void __launch_bounds__(THREADS, 8) counter_hist_kernel(
    const int* __restrict__ table, long long row_len, int nbins, int sbins,
    int* __restrict__ out) {
    extern __shared__ int sh[];
    const int* r = table + (long long)blockIdx.y * row_len;
    int* o = out + (long long)blockIdx.y * nbins;
    for (int b = threadIdx.x; b < sbins; b += blockDim.x) sh[b] = 0;
    __syncthreads();
    Tally t{nbins, sbins, sh, o, 0u};
    const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long step = (long long)gridDim.x * blockDim.x;
    // scalar head up to the first 16-byte boundary, 16-byte body, scalar tail
    const long long head = min(row_len, (long long)((16 - ((uintptr_t)r & 15)) & 15) / 4);
    const long long n4 = (row_len - head) / 4;
    const long long tail = head + 4 * n4;
    if (tid < head) t.add(r[tid]);
    if (tid < row_len - tail) t.add(r[tail + tid]);
    const int4* v = (const int4*)(r + head);
    long long i = tid;
    for (; i + (UNROLL - 1) * step < n4; i += UNROLL * step) {
        int4 a[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) a[u] = __ldcs(v + i + u * step);
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) t.add4(a[u]);
    }
    for (; i < n4; i += step) t.add4(__ldcs(v + i));
    unsigned zeros = t.zeros;
    for (int s = 16; s > 0; s >>= 1) zeros += __shfl_down_sync(0xffffffffu, zeros, s);
    if ((threadIdx.x & 31u) == 0 && zeros) atomicAdd(&sh[0], (int)zeros);
    __syncthreads();
    for (int b = threadIdx.x; b < sbins; b += blockDim.x)
        if (sh[b]) atomicAdd(&o[b], sh[b]);
}

// table: int32 [nrows, row_len] contiguous; out: int32 [nrows, nbins]
// zeroed; 1 <= nbins <= 65536. Returns the cudaError_t.
extern "C" int ntc_counter_hist(const void* table, long long row_len, int nrows, int nbins,
                                void* out, void* stream) {
    if (row_len == 0 || nrows == 0) return 0;
    int dev = 0, smem_max = 0, n_sm = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    const int sbins = nbins < smem_max / (int)sizeof(int) ? nbins : smem_max / (int)sizeof(int);
    const size_t dyn = (size_t)sbins * sizeof(int);
    if (dyn > 48 * 1024) {
        err = cudaFuncSetAttribute(counter_hist_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
        if (err != cudaSuccess) return (int)err;
    }
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, counter_hist_kernel, THREADS,
                                                        dyn);
    if (err != cudaSuccess) return (int)err;
    // every block slot of the card, split over the rows, and no more blocks
    // than a row has work for
    long long bx = (long long)n_sm * (per_sm > 0 ? per_sm : 1) / nrows;
    const long long need = (row_len / 4 + THREADS * UNROLL - 1) / (THREADS * UNROLL);
    bx = bx < need ? bx : need;
    dim3 grid((unsigned)(bx > 0 ? bx : 1), (unsigned)nrows);
    counter_hist_kernel<<<grid, THREADS, dyn, (cudaStream_t)stream>>>(
        (const int*)table, row_len, nbins, sbins, (int*)out);
    return (int)cudaGetLastError();
}
