// K3: stream compaction of the emit indices in [0, sent) into an int32
// buffer of `cap` slots, plus the true count. Replaces the Pallas kernel
// ntcard_tpu/ops/scatter_pallas.py::compact_pallas in plain mode
// (_compact_kernel with _extract_multi_packed2 / _extract_multi_full). The
// result is a multiset: slot order is free, unused slots keep the caller's
// -1 fill, and when the count exceeds `cap` the buffer holds an arbitrary
// `cap` of the elements (the caller then discards it).
//
// What bounds it on an H100: reading the emit stream, 4 bytes a window; at
// the default sampling about 1% of the elements survive. The TPU kernel
// extracts survivors one by one with min-reductions over VMEM windows,
// because Mosaic has no scalar stores; here each warp takes a ballot of its
// survivors, one lane reserves that many slots with one atomicAdd on the
// device counter, and each survivor writes its own slot (rank = popcount of
// the lower lanes). Warps with no survivor skip the atomic.

#include <cuda_runtime.h>

#define THREADS 256
#define MAX_BLOCKS 2048

__global__ void __launch_bounds__(THREADS) compact_kernel(
    const int* __restrict__ idx, long long n, unsigned sent, int* __restrict__ vals, int cap,
    int* __restrict__ count) {
    const unsigned lane = threadIdx.x & 31u;
    const long long step = (long long)gridDim.x * blockDim.x;
    // `base` is uniform across the block, so every lane of a warp reaches the
    // ballot in every iteration
    for (long long base = (long long)blockIdx.x * blockDim.x; base < n; base += step) {
        const long long i = base + threadIdx.x;
        const unsigned v = i < n ? (unsigned)idx[i] : sent;
        const bool keep = v < sent;
        const unsigned mask = __ballot_sync(0xffffffffu, keep);
        if (mask == 0) continue;
        int off = 0;
        if (lane == 0) off = atomicAdd(count, __popc(mask));
        off = __shfl_sync(0xffffffffu, off, 0);
        if (keep) {
            const int slot = off + __popc(mask & ((1u << lane) - 1u));
            if (slot < cap) vals[slot] = (int)v;
        }
    }
}

// idx: int32 [n] contiguous, n < 2^31; vals: int32 [cap] pre-filled with -1;
// count: int32 [1] zeroed, receives the true survivor count. Returns the
// cudaError_t of the launch.
extern "C" int ntc_compact(const void* idx, long long n, int sent, void* vals, int cap,
                           void* count, void* stream) {
    if (n == 0) return 0;
    long long blocks = (n + THREADS - 1) / THREADS;
    const int grid = (int)(blocks < MAX_BLOCKS ? blocks : MAX_BLOCKS);
    compact_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const int*)idx, n, (unsigned)sent, (int*)vals, cap, (int*)count);
    return (int)cudaGetLastError();
}
