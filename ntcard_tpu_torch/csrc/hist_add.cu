// K2: add every emit index in [0, sent) into an int32 count table, in place.
// Replaces the Pallas kernel ntcard_tpu/ops/scatter_pallas.py::hist_add_pallas
// (_hist_kernel + _extract_pair): its result equals a bincount of the
// non-sentinel elements, and the sentinel (dump) bin is never touched.
//
// What bounds it on an H100: reading the emit stream (4 bytes a window) and
// one global atomic per sampled element. The TPU kernel extracts the sparse
// sampled elements by iterated min-reductions because Mosaic cannot address
// single VMEM elements; Hopper can, so each thread reads its elements in a
// grid-stride loop and increments the table with atomicAdd. The r <= 16
// table (512 KB) does not fit shared memory but stays resident in the 50 MB
// L2, where the atomics resolve. Every value at or above `sent` (S0 and K1's
// S1) and every negative value is skipped, so K1's output feeds it directly.
//
// The same body serves the exact overflow path of the big-table update: with
// a `gate` pointer the kernel reads the device flag first and returns at
// once when it is 0, so a batch whose compaction overflowed is added in full
// exactly once, with no host sync.

#include <cuda_runtime.h>

#define THREADS 256
#define MAX_BLOCKS 2048

__global__ void __launch_bounds__(THREADS) table_add_kernel(
    const int* __restrict__ idx, long long n, unsigned sent, int* __restrict__ table,
    const int* __restrict__ gate) {
    if (gate != nullptr && *gate == 0) return;
    const long long step = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step) {
        const unsigned v = (unsigned)idx[i];
        if (v < sent) atomicAdd(&table[v], 1);
    }
}

// idx: int32 [n] contiguous; table: int32 [>= sent]; gate: int32 flag on
// the device, or null for an unconditional add. Returns the cudaError_t.
extern "C" int ntc_table_add(const void* idx, long long n, int sent, void* table,
                             const void* gate, void* stream) {
    if (n == 0) return 0;
    long long blocks = (n + THREADS - 1) / THREADS;
    const int grid = (int)(blocks < MAX_BLOCKS ? blocks : MAX_BLOCKS);
    table_add_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const int*)idx, n, (unsigned)sent, (int*)table, (const int*)gate);
    return (int)cudaGetLastError();
}
