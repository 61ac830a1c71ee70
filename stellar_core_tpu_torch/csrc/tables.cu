// K-B and K-T: the per-key window tables of the hot-key path.
//
// The resident table is (slots, 64, 16, 4, 32) bytes: each entry the
// canonical encodings of its four coordinates (ge25519.cuh: ge_pre_store),
// the same bytes the plain versions read.
//
// K-B replaces tables.build_tables / _build_jit
// (stellar_core_tpu/accel/tables.py:51-106).  One thread per (key, window)
// writes that window's 16 entries straight into the key's slot row of the
// resident table.  Bound: integer multiply-adds; thread w runs 4w doublings
// before its 14 adds, so a launch takes as long as window 63's thread, and
// the threads run 32x the doublings a sequential chain needs.
//
// K-T replaces tables.verify_tables_forward / _verify_tables_jit
// (:109-150).  One thread per signature: 64 windows of two precomputed adds
// (8 multiplies each), no doublings, then encode and compare.  Bound:
// integer multiply-adds, about 1.2e5 per signature; each signature reads
// 128 entries of 128 bytes, which L2 serves (64 keys' tables are 8 MiB).
#include <cuda_runtime.h>

#include "verify.cuh"

__global__ void build_tables_kernel(const uint8_t *__restrict__ key_xy,
                                    const int32_t *__restrict__ slots,
                                    int64_t k, uint8_t *__restrict__ table,
                                    int64_t nslots) {
    int64_t key = blockIdx.x;
    int w = threadIdx.x;
    if (key >= k) return;
    int32_t slot = slots[key];
    if (slot < 0 || slot >= nslots) return;   // the host never sends one
    build_window_one(table + (int64_t)slot * KEY_BYTES + w * WINDOW_BYTES,
                     key_xy + 64 * key, w);
}

__global__ void verify_tables_kernel(const uint8_t *__restrict__ s,
                                     const uint8_t *__restrict__ h,
                                     const uint8_t *__restrict__ r,
                                     const int32_t *__restrict__ slots,
                                     int64_t n,
                                     const uint8_t *__restrict__ key_table,
                                     int64_t nslots,
                                     const uint8_t *__restrict__ base_table,
                                     uint8_t *__restrict__ out) {
    int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    int32_t slot = slots[i];
    if (slot < 0 || slot >= nslots) {   // the host never sends one: reject
        out[i] = 0;
        return;
    }
    out[i] = verify_tables_one(s + 32 * i, h + 32 * i, r + 32 * i,
                               key_table + (int64_t)slot * KEY_BYTES,
                               base_table);
}

extern "C" int build_tables_launch(const void *key_xy, const void *slots,
                                   int64_t k, void *table, int64_t nslots,
                                   void *stream) {
    build_tables_kernel<<<(unsigned)k, TABLE_NWIN, 0, (cudaStream_t)stream>>>(
        (const uint8_t *)key_xy, (const int32_t *)slots, k,
        (uint8_t *)table, nslots);
    return (int)cudaGetLastError();
}

extern "C" int verify_tables_launch(const void *s, const void *h,
                                    const void *r, const void *slots,
                                    int64_t n, const void *key_table,
                                    int64_t nslots, const void *base_table,
                                    void *out, void *stream) {
    const int threads = 64;
    unsigned blocks = (unsigned)((n + threads - 1) / threads);
    verify_tables_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint8_t *)s, (const uint8_t *)h, (const uint8_t *)r,
        (const int32_t *)slots, n, (const uint8_t *)key_table, nslots,
        (const uint8_t *)base_table, (uint8_t *)out);
    return (int)cudaGetLastError();
}

extern "C" const char *cuda_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
