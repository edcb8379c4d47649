// K1: canonical ntHash, sampling and bucketing of every window of a code
// batch, for every k. Replaces the Pallas kernel
// ntcard_tpu/ops/nthash_pallas.py::sketch_idx_pallas (_sketch_kernel), and
// computes its contract exactly: [B, L] codes (0-3 ACGT, 4 N) -> [nK, B, L]
// int32 emit indices, each a table index in [0, 2^(r+1)), or S0 = 2^(r+1)
// for a valid but unsampled window, or S1 = S0 + 1 for a window that holds
// an N or starts at or past `stride`.
//
// What bounds it on an H100: the integer work of the rolling hash and the
// emit, at least 35 int32 operations a window and k (PERF.md derives the
// count), against 4 * nK bytes of output stores a window. The TPU kernel
// builds every window hash from rotated prefix XORs because the TPU has no
// 64-bit lanes and no cheap sequential loop; here each thread rolls the
// ntHash recurrence (nthash.hpp:242-257) through SEG window starts of one
// row, on the shared tile of nthash.cuh: the block reads its [positions,
// rows] code tile once into shared memory and serves every k from it, its
// first windows come from sub-block hashes made once for all k, and a roll
// step is two lookups in 36-entry tables. Beside that, stores are
// row-contiguous: a warp's lanes are 32 rows and its threads roll in step
// along the positions, so each warp stages its [32 rows x 32 positions]
// output in shared memory (16-byte stores, conflict-free through an odd
// pitch in 16-byte units) and writes each row's 128-byte run back with
// 16-byte stores, four whole lines per warp store.
//
// Spaced seeds (ntcard -g, a single k): each masked position p's seed
// contributions are XORed out of the window's output F and R before the
// canonical min (ntcard_tpu/ops/nthash.py:371-383), from two small strip
// tables; the rolling state stays the full-k hash. Validity stays the
// full-window N count.

#include <cstdint>
#include <cuda_runtime.h>

#include "nthash.cuh"

#define WARPS 8
#define THREADS (ROWS * WARPS)
#define SEG 32                 // window starts of a thread (one warp: one segment)
#define TP (WARPS * SEG)       // window starts of a block tile
#define PITCH (SEG + 4)        // stage row pitch in int32: 16-byte units odd

static_assert(SEG % SUB == 0 && SEG % 4 == 0, "segments start on sub-block boundaries");
static_assert((PITCH / 4) % 2 == 1, "odd 16-byte pitch keeps the staging stores conflict-free");

__host__ __device__ inline int align16(int b) { return (b + 15) & ~15; }

// Byte offsets into the block's dynamic shared memory.
struct Layout {
    int tf, tr, f36, r36, mf, mr, mpos, subf, subr, stage, subn, codes, total;
    int W, nsub;
    __host__ __device__ Layout(int nk, int n_mask, int kmax) {
        W = TP + kmax - 1;  // the tile's codes: its window starts and their reach
        nsub = W / SUB;
        int o = 0;
        tf = o, o += align16(SUB * NC * 8);
        tr = o, o += align16(SUB * NC * 8);
        f36 = o, o += align16(nk * NC * NC * 8);
        r36 = o, o += align16(nk * NC * NC * 8);
        mf = o, o += align16(n_mask * NC * 8);
        mr = o, o += align16(n_mask * NC * 8);
        subf = o, o += align16(nsub * ROWS * 8);
        subr = o, o += align16(nsub * ROWS * 8);
        stage = o, o += align16(WARPS * ROWS * PITCH * 4);
        mpos = o, o += align16(n_mask * 4);
        subn = o, o += align16(nsub * ROWS);
        codes = o, o += align16(W * ROWS);
        total = o;
    }
};

__global__ void __launch_bounds__(THREADS, 3) sketch_idx_kernel(
    const uint8_t* __restrict__ codes, long long sb, long long sl, int B, int L,
    const int* __restrict__ ks, int nk, int kmax, const long long* __restrict__ seeds,
    const int* __restrict__ mpos, const long long* __restrict__ mf,
    const long long* __restrict__ mr, int n_mask, int stride, int s_bits, int r_bits,
    int* __restrict__ out) {
    extern __shared__ __align__(16) unsigned char smem[];
    const Layout lay(nk, n_mask, kmax);
    u64* tf = (u64*)(smem + lay.tf);    // [SUB][NC] P^(SUB-1-j) seed(c)
    u64* tr = (u64*)(smem + lay.tr);    // [SUB][NC] P^j seed(comp c)
    u64* f36 = (u64*)(smem + lay.f36);  // [nk][ci][co] seed(ci) ^ P^k seed(co)
    u64* r36 = (u64*)(smem + lay.r36);  // [nk][ci][co] P^k seed(comp ci) ^ seed(comp co)
    u64* smf = (u64*)(smem + lay.mf);   // [n_mask][NC] forward strip
    u64* smr = (u64*)(smem + lay.mr);   // [n_mask][NC] reverse strip
    int* smpos = (int*)(smem + lay.mpos);
    u64* subf = (u64*)(smem + lay.subf);  // [nsub][ROWS] sub-block F
    u64* subr = (u64*)(smem + lay.subr);  // [nsub][ROWS] sub-block R
    uint8_t* subn = smem + lay.subn;      // [nsub][ROWS] sub-block N count
    uint8_t* cs = smem + lay.codes;       // [W][ROWS] codes, min(code, 5)
    const int W = lay.W, nsub = lay.nsub;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int row0 = blockIdx.y * ROWS, p_tile = blockIdx.x * TP;

    // tables by code: code 5 (any code above N) takes N's entry
    fill_sub_tables(tf, tr, seeds, threadIdx.x, THREADS);
    for (int i = threadIdx.x; i < nk * NC * NC; i += THREADS)
        roll_entry(i % (NC * NC), ks[i / (NC * NC)], seeds, f36[i], r36[i]);
    for (int i = threadIdx.x; i < n_mask * NC; i += THREADS) {
        const int src = i / NC * 5 + min(i % NC, 4);
        smf[i] = (u64)mf[src];
        smr[i] = (u64)mr[src];
    }
    for (int i = threadIdx.x; i < n_mask; i += THREADS) smpos[i] = mpos[i];
    load_code_tile(cs, codes, sb, sl, B, L, row0, p_tile, W, threadIdx.x, THREADS);
    __syncthreads();
    // every aligned sub-block's F, R and N count, once for all k
    hash_sub_blocks(cs, tf, tr, subf, subr, subn, nsub, threadIdx.x, THREADS);
    __syncthreads();

    const unsigned r_buck = 1u << r_bits;
    const int sent0 = (int)(2u * r_buck), sent1 = sent0 + 1;
    const unsigned s_mask = (1u << (s_bits - 1)) - 1u;
    const int q0 = warp * SEG, p0 = p_tile + q0;
    if (p0 >= L) return;  // no window start of this warp is in the batch
    const int pv = min(stride, L);
    const uint8_t* col = cs + lane;  // this thread's row
    int* st = (int*)(smem + lay.stage) + warp * ROWS * PITCH;

    for (int t = 0; t < nk; ++t) {
        const int k = ks[t];
        if (p0 < pv) {
            // the segment's first window from sub-block hashes
            u64 F, R;
            int nn;
            first_window(col, lane, q0, k, tf, tr, subf, subr, subn, F, R, nn);

            const u64* ft = f36 + t * NC * NC;
            const u64* rt = r36 + t * NC * NC;
            for (int j0 = 0; j0 < SEG; j0 += 4) {
                int v[4];
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    const int j = j0 + u, q = q0 + j;
                    if (j > 0) roll(col, q, k, ft, rt, F, R, nn);  // one base on
                    u64 f = F, r = R;
                    for (int i = 0; i < n_mask; ++i) {
                        const unsigned c = col[(q + smpos[i]) * ROWS];
                        f ^= smf[i * NC + c];
                        r ^= smr[i * NC + c];
                    }
                    const u64 h = f < r ? f : r;
                    const unsigned hi = (unsigned)(h >> 32), lo = (unsigned)h;
                    const bool s0 = (hi >> (31 - s_bits)) == 1u;
                    const bool s1 = (hi >> (32 - s_bits)) == s_mask;
                    int idx = (int)(lo & (r_buck - 1u)) + (s1 ? (int)r_buck : 0);
                    idx = (s0 || s1) ? idx : sent0;
                    v[u] = (nn || p0 + j >= pv) ? sent1 : idx;
                }
                *(int4*)(st + lane * PITCH + j0) = make_int4(v[0], v[1], v[2], v[3]);
            }
        } else {
            for (int j0 = 0; j0 < SEG; j0 += 4)
                *(int4*)(st + lane * PITCH + j0) = make_int4(sent1, sent1, sent1, sent1);
        }
        __syncwarp();
        // each row's 32 outputs back to device memory: lanes 8i..8i+7 write
        // one row's 128 bytes, 16 bytes each
        const int ch = lane & 7;
        const int p = p0 + 4 * ch;
        for (int rr = lane >> 3; rr < ROWS; rr += 4) {
            const int b = row0 + rr;
            if (b >= B || p >= L) continue;
            const int4 w = *(const int4*)(st + rr * PITCH + 4 * ch);
            int* o = out + ((long long)t * B + b) * L + p;
            if ((L & 3) == 0) {  // p + 3 < L too, and the row start is 16-byte aligned
                *(int4*)o = w;
            } else {
                o[0] = w.x;
                if (p + 1 < L) o[1] = w.y;
                if (p + 2 < L) o[2] = w.z;
                if (p + 3 < L) o[3] = w.w;
            }
        }
        __syncwarp();
    }
}

// codes: uint8 [B, L] with element strides (sb, sl); ks: int32 [nk] on the
// device, kmax their largest; seeds: int64 [10] on the device (seed by
// code, then the complement base's seed by code); spaced seeds (nk == 1
// only): mpos int32 [n_mask] masked positions, mf and mr int64 [n_mask, 5]
// strip tables by code (P^(k-1-p)(seed(c)) and P^p(seed(comp c))), all null
// when n_mask is 0; out: int32 [nk, B, L] contiguous and 16-byte aligned.
// Requires stride + kmax - 1 <= L (the wrapper checks), and a tile that
// fits the opt-in shared memory (kmax up to about 5,000). Returns the
// cudaError_t of the launch.
extern "C" int ntc_sketch_idx(const void* codes, long long sb, long long sl, int B, int L,
                              const void* ks, int nk, int kmax, const void* seeds,
                              const void* mpos, const void* mf, const void* mr, int n_mask,
                              int stride, int s_bits, int r_bits, void* out, void* stream) {
    if (B == 0 || L == 0) return 0;
    const Layout lay(nk, n_mask, kmax);
    int dev = 0, smem_max = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;
    if (lay.total > smem_max) return (int)cudaErrorInvalidValue;
    if (lay.total > 48 * 1024) {
        err = cudaFuncSetAttribute(sketch_idx_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   lay.total);
        if (err != cudaSuccess) return (int)err;
    }
    const dim3 grid((unsigned)((L + TP - 1) / TP), (unsigned)((B + ROWS - 1) / ROWS));
    sketch_idx_kernel<<<grid, THREADS, lay.total, (cudaStream_t)stream>>>(
        (const uint8_t*)codes, sb, sl, B, L, (const int*)ks, nk, kmax, (const long long*)seeds,
        (const int*)mpos, (const long long*)mf, (const long long*)mr, n_mask, stride, s_bits,
        r_bits, (int*)out);
    return (int)cudaGetLastError();
}
