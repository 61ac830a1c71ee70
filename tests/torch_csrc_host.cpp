// Host build of the CUDA kernels' per-thread bodies
// (stellar_core_tpu_torch/csrc/verify.cuh) for tests/test_torch_csrc.py:
// each entry loops over its rows the way the kernel's threads map onto
// them in verify_generic.cu, tables.cu and fe_check.cu.
#include "verify.cuh"

extern "C" {

void host_fe_check(const uint8_t *a, const uint8_t *b, int op, int64_t n,
                   uint8_t *out) {
    for (int64_t i = 0; i < n; i++) fe_check_one(out + 32 * i, a + 32 * i, b + 32 * i, op);
}

void host_verify_generic(const uint8_t *s, const uint8_t *h, const uint8_t *r,
                         const int32_t *key_idx, int64_t n,
                         const uint8_t *keys, int64_t nk, uint8_t *out) {
    for (int64_t i = 0; i < n; i++) {
        int32_t k = key_idx[i];
        out[i] = (k < 0 || k >= nk) ? 0
                 : verify_generic_one(s + 32 * i, h + 32 * i, r + 32 * i,
                                      keys + 96 * (int64_t)k);
    }
}

void host_build_tables(const uint8_t *key_xy, const int32_t *slots, int64_t k,
                       uint8_t *table, int64_t nslots) {
    for (int64_t key = 0; key < k; key++) {
        int32_t slot = slots[key];
        if (slot < 0 || slot >= nslots) continue;
        for (int w = 0; w < TABLE_NWIN; w++)
            build_window_one(table + (int64_t)slot * KEY_BYTES + w * WINDOW_BYTES,
                             key_xy + 64 * key, w);
    }
}

void host_verify_tables(const uint8_t *s, const uint8_t *h, const uint8_t *r,
                        const int32_t *slots, int64_t n,
                        const uint8_t *key_table, int64_t nslots,
                        const uint8_t *base_table, uint8_t *out) {
    for (int64_t i = 0; i < n; i++) {
        int32_t slot = slots[i];
        out[i] = (slot < 0 || slot >= nslots) ? 0
                 : verify_tables_one(s + 32 * i, h + 32 * i, r + 32 * i,
                                     key_table + (int64_t)slot * KEY_BYTES,
                                     base_table);
    }
}

}  // extern "C"
