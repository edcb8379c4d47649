// K3: stream compaction of the emit indices in [0, sent) into an int32
// buffer of `cap` slots, plus the true count. Replaces the Pallas kernel
// ntcard_tpu/ops/scatter_pallas.py::compact_pallas in plain mode
// (_compact_kernel with _extract_multi_packed2 / _extract_multi_full). The
// result is a multiset: slot order is free, the unused slots [min(count,
// cap), cap) hold -1, and when the count exceeds `cap` the buffer holds an
// arbitrary `cap` of the elements (the caller then discards it).
//
// What bounds it on an H100: reading the emit stream, 4 bytes a window; at
// the default sampling about 1% of the elements survive. The TPU kernel
// extracts survivors one by one with min-reductions over VMEM windows,
// because Mosaic has no scalar stores. Here the cost to avoid is a single
// global counter that every warp with a survivor would hit (tens of
// thousands of atomics a batch, served one at a time at one L2 address):
//
// * a block takes a tile of 4 * TILE4 elements: each thread issues UNROLL
//   16-byte loads at once (scalar head and tail when the stream does not
//   start on a 16-byte boundary or its length is not a multiple of 4, taken
//   by tile 0), so many loads are in flight and none waits on an atomic;
// * each warp ranks its survivors by one ballot an element, the warp totals
//   go through shared memory into a block-exclusive scan, and one thread
//   reserves the tile's run with ONE atomicAdd (none for an empty tile);
// * survivors are staged in shared memory in rank order and stored as one
//   contiguous run at the reserved offset;
// * the grid holds as many blocks as fit on the card at once (the
//   occupancy query) and each loops over tiles;
// * no launch besides this one: the counter and a ticket live in a scratch
//   pair that is 0 between launches. The block that takes the last ticket
//   (after a __threadfence) reads the total, writes it out, fills [min(total,
//   cap), cap) with -1 and sets the pair back to 0.

#include <cstdint>
#include <cuda_runtime.h>

#define THREADS 256
#define WARPS (THREADS / 32)
#define UNROLL 4                     // 16-byte loads in flight a thread
#define TILE4 (THREADS * UNROLL)     // int4 of a tile
#define NE (4 * UNROLL + 1)          // elements of a thread: the body, one head/tail
#define STAGE (THREADS * NE)

__global__ void __launch_bounds__(THREADS) compact_kernel(
    const int* __restrict__ idx, long long n, long long head, long long n4, long long ntiles,
    unsigned sent, int* __restrict__ vals, int cap, int* __restrict__ count_out,
    unsigned* __restrict__ scratch) {
    __shared__ int stage[STAGE];
    __shared__ int wtot[WARPS];
    __shared__ int tile_base, tile_total;
    __shared__ bool last;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const unsigned lt = (1u << lane) - 1u;
    const int4* body = (const int4*)(idx + head);
    const long long tail = head + 4 * n4;  // first element of the scalar tail

    for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        int v[NE];
        int4 a[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const long long i = tile * TILE4 + u * THREADS + threadIdx.x;
            a[u] = i < n4 ? __ldcs(body + i) : make_int4(-1, -1, -1, -1);
        }
        // tile 0 also takes the head (threads 0-2) and the tail (threads 4-6)
        v[NE - 1] = -1;
        if (tile == 0) {
            if (threadIdx.x < head) v[NE - 1] = idx[threadIdx.x];
            const long long t = tail + threadIdx.x - 4;
            if (threadIdx.x >= 4 && t < n) v[NE - 1] = idx[t];
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            v[4 * u] = a[u].x, v[4 * u + 1] = a[u].y, v[4 * u + 2] = a[u].z, v[4 * u + 3] = a[u].w;
        }
        // the warp's survivors, one ballot an element
        int wcount = 0;
#pragma unroll
        for (int e = 0; e < NE; ++e) wcount += __popc(__ballot_sync(0xffffffffu, (unsigned)v[e] < sent));
        if (lane == 0) wtot[warp] = wcount;
        __syncthreads();
        if (threadIdx.x == 0) {
            int s = 0;
#pragma unroll
            for (int w = 0; w < WARPS; ++w) {
                const int c = wtot[w];
                wtot[w] = s;
                s += c;
            }
            tile_total = s;
            tile_base = s ? (int)atomicAdd(&scratch[0], (unsigned)s) : 0;
        }
        __syncthreads();
        // each survivor's slot in the tile: the warp's offset, the warp's
        // survivors of the earlier elements, the lower lanes' of this one
        // (the ballots again, cheaper than keeping NE ranks in registers)
        int off = wtot[warp];
#pragma unroll
        for (int e = 0; e < NE; ++e) {
            const bool keep = (unsigned)v[e] < sent;
            const unsigned m = __ballot_sync(0xffffffffu, keep);
            if (keep) stage[off + __popc(m & lt)] = v[e];
            off += __popc(m);
        }
        __syncthreads();
        const int base = tile_base, total = tile_total;
        for (int i = threadIdx.x; i < total; i += THREADS)
            if (base + i < cap) vals[base + i] = stage[i];
        __syncthreads();  // stage, wtot and the tile scalars are reused
    }

    // the last block to finish publishes the count, fills the unused slots
    // with -1 and resets the scratch pair for the next launch
    if (threadIdx.x == 0) {
        __threadfence();
        last = atomicAdd(&scratch[1], 1u) == gridDim.x - 1;
    }
    __syncthreads();
    if (!last) return;
    if (threadIdx.x == 0) {
        __threadfence();
        tile_total = (int)atomicExch(&scratch[0], 0u);  // every block's adds are in
        scratch[1] = 0;
        *count_out = tile_total;
    }
    __syncthreads();
    // cap is a multiple of 4 and vals 16-byte aligned: scalar up to the
    // first 16-byte boundary, then 16-byte stores
    const int s = min(tile_total, cap), s4 = min((s + 3) & ~3, cap);
    if (s + (int)threadIdx.x < s4) vals[s + threadIdx.x] = -1;
    for (int i = s4 / 4 + threadIdx.x; i < cap / 4; i += THREADS)
        ((int4*)vals)[i] = make_int4(-1, -1, -1, -1);
}

// idx: int32 [n] contiguous (4-byte aligned, any 16-byte offset), n < 2^31;
// vals: int32 [cap], 16-byte aligned, cap a multiple of 4, written in full
// (survivors, then -1); count: int32 [1], receives the true
// survivor count; scratch: uint32 [2] on the device, 0 before the launch
// and left 0 after it (launches that share it must be stream-ordered).
// Returns the cudaError_t of the launch.
extern "C" int ntc_compact(const void* idx, long long n, int sent, void* vals, int cap,
                           void* count, void* scratch, void* stream) {
    int dev = 0, n_sm = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, compact_kernel, THREADS, 0);
    if (err != cudaSuccess) return (int)err;
    const long long to16 = (long long)((16 - ((uintptr_t)idx & 15)) & 15) / 4;
    const long long head = n < to16 ? n : to16;
    const long long n4 = (n - head) / 4;
    long long ntiles = (n4 + TILE4 - 1) / TILE4;
    if (ntiles == 0) ntiles = 1;  // a head or tail only, or nothing: still fill and count
    long long grid = (long long)n_sm * (per_sm > 0 ? per_sm : 1);
    if (grid > ntiles) grid = ntiles;
    compact_kernel<<<(unsigned)grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const int*)idx, n, head, n4, ntiles, (unsigned)sent, (int*)vals, cap, (int*)count,
        (unsigned*)scratch);
    return (int)cudaGetLastError();
}
