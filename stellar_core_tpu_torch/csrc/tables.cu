// K-B and K-T: the per-key window tables of the hot-key path, K-B on quads
// of lanes, K-T on pairs (ge25519_quad.cuh; bodies in verify.cuh).
//
// The resident table is (slots, 64, 16, 4, 32) bytes: each entry the
// canonical encodings of its four coordinates in the order Y-X, Y+X, 2d*T,
// 2Z (ge25519.cuh: GE_PRE_BYTES), the same bytes the plain versions read.
//
// K-B replaces tables.build_tables / _build_jit
// (stellar_core_tpu/accel/tables.py:51-106).  A block a key, a quad a
// window (256 threads).  Phase 1: warp 0 runs the key's doubling chain once
// with q_dbl, 252 doublings, and leaves S_w = 16^w A in shared memory (64
// points, 10 KiB); phase 2, after one barrier: quad w makes window w's
// multiples by 14 adds of S_w and stores its 16 entries, each lane one
// coordinate's 32 canonical bytes.  Bound: integer multiply-adds, about
// 1.07M a key, 0.002 ms for 32 keys; but the chain is 252 doublings in a
// row whatever the card, so a launch takes at least 252 latencies of one
// q_dbl (the chain floor, PERF.md), and the entries must equal the
// reference's byte for byte, which fixes that chain.  Phase 1 is the
// redesign's answer to the old one thread a (key, window), where thread w
// repeated 4w doublings of A (8,064 a key, 32x the chain).
//
// K-T replaces tables.verify_tables_forward / _verify_tables_jit
// (:109-150).  A pair of lanes a signature: lane k sums the windows w = k
// (mod 2), 64 precomputed adds of the single-thread code with no exchange,
// then one round of __shfl_xor_sync and a complete add join the two
// halves, and each lane encodes its copy (one invert, the lanes in step)
// and compares with R; lane 0 stores the verdict.  Bound: integer
// multiply-adds, about 1.2e5 a signature (0.115 ms at 16,384); each lane
// reads 64 entries of 128 bytes, which L2 serves (64 keys' tables are
// 8 MiB).  One thread a signature left one warp on each scheduler at the
// hot chunk, waiting on each add's chain of 8 dependent products; a pair
// puts two there, where the instruction rate sets the time (PERF.md).
// Four lanes a signature were measured too and lost: 138 registers admit
// 14 warps an SM, so the chunk's 2,048 warps took two waves, and the
// invert ran in all four lanes, on 8 signatures a warp.  Rows past n run
// on row n - 1 and store nothing, so every lane reaches the shuffle.
#include <cuda_runtime.h>

#include "verify.cuh"

// a quad a window; the chain: 64 points of 10 limbs in each of 4 lanes
#define KB_THREADS (4 * TABLE_NWIN)
#define KB_CHAIN_WORDS (TABLE_NWIN * FE_NLIMB * 4)
#define KT_THREADS 64   // 32 signatures

__global__ void __launch_bounds__(KB_THREADS)
build_tables_kernel(const uint8_t *__restrict__ key_xy,
                    const int32_t *__restrict__ slots, int64_t k,
                    uint8_t *__restrict__ table, int64_t nslots) {
    __shared__ uint32_t chain_words[KB_CHAIN_WORDS];
    int64_t key = blockIdx.x;
    if (key >= k) return;
    int32_t slot = slots[key];
    if (slot < 0 || slot >= nslots) return;   // the host never sends one
    // (both tests hold for the whole block: no thread misses the barrier)
    QTab chain{chain_words + q_lane(), 4};
    if (threadIdx.x < 32)
        build_chain_quad(chain, key_xy + 64 * key, threadIdx.x < 4);
    __syncthreads();
    int w = threadIdx.x >> 2;
    build_window_quad(table + (int64_t)slot * KEY_BYTES + w * WINDOW_BYTES,
                      q_tab_load(chain, w));
}

__global__ void __launch_bounds__(KT_THREADS)
verify_tables_kernel(const uint8_t *__restrict__ s,
                     const uint8_t *__restrict__ h,
                     const uint8_t *__restrict__ r,
                     const int32_t *__restrict__ slots, int64_t n,
                     const uint8_t *__restrict__ key_table, int64_t nslots,
                     const uint8_t *__restrict__ base_table,
                     uint8_t *__restrict__ out) {
    int64_t i = ((int64_t)blockIdx.x * KT_THREADS + threadIdx.x) >> 1;
    uint8_t ok = verify_tables_pair(i, n, s, h, r, slots, key_table, nslots,
                                    base_table);
    if (i < n && p_lane() == 0) out[i] = ok;
}

extern "C" int build_tables_launch(const void *key_xy, const void *slots,
                                   int64_t k, void *table, int64_t nslots,
                                   void *stream) {
    build_tables_kernel<<<(unsigned)k, KB_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t *)key_xy, (const int32_t *)slots, k,
        (uint8_t *)table, nslots);
    return (int)cudaGetLastError();
}

extern "C" int verify_tables_launch(const void *s, const void *h,
                                    const void *r, const void *slots,
                                    int64_t n, const void *key_table,
                                    int64_t nslots, const void *base_table,
                                    void *out, void *stream) {
    unsigned blocks = (unsigned)((2 * n + KT_THREADS - 1) / KT_THREADS);
    verify_tables_kernel<<<blocks, KT_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t *)s, (const uint8_t *)h, (const uint8_t *)r,
        (const int32_t *)slots, n, (const uint8_t *)key_table, nslots,
        (const uint8_t *)base_table, (uint8_t *)out);
    return (int)cudaGetLastError();
}

extern "C" const char *cuda_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
