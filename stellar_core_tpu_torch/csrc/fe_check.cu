// Check kernels, not ports of TPU kernels.
//
// fe_check: one field op per thread on random operands, so chip_smoke.py
// can hold fe25519.cuh against the plain field version over many pairs on
// the card (verify.cuh: fe_check_one).
//
// dbl_chain: `steps` doublings of a point on a quad (verify.cuh:
// dbl_chain_quad), each row's result in precomputed form.  On one warp it
// times a chain of q_dbl, what K-B's phase 1 runs 252 of: chip_smoke.py
// measures K-B's chain floor with it.
#include <cuda_runtime.h>

#include "verify.cuh"

__global__ void fe_check_kernel(const uint8_t *__restrict__ a,
                                const uint8_t *__restrict__ b, int op,
                                int64_t n, uint8_t *__restrict__ out) {
    int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    fe_check_one(out + 32 * i, a + 32 * i, b + 32 * i, op);
}

extern "C" int fe_check_launch(const void *a, const void *b, int op,
                               int64_t n, void *out, void *stream) {
    const int threads = 128;
    unsigned blocks = (unsigned)((n + threads - 1) / threads);
    fe_check_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint8_t *)a, (const uint8_t *)b, op, n, (uint8_t *)out);
    return (int)cudaGetLastError();
}

// a warp a block: 8 rows; rows past n run row n - 1 and store nothing
__global__ void __launch_bounds__(32)
dbl_chain_kernel(const uint8_t *__restrict__ xy, int64_t n, int64_t steps,
                 uint8_t *__restrict__ out) {
    int64_t i = ((int64_t)blockIdx.x * 32 + threadIdx.x) >> 2;
    int64_t c = quad_row(i, n);
    QFe p = dbl_chain_quad(xy + 64 * c, steps);
    if (i < n) q_pre_store(out + GE_PRE_BYTES * i, p);
}

extern "C" int dbl_chain_launch(const void *xy, int64_t n, int64_t steps,
                                void *out, void *stream) {
    unsigned blocks = (unsigned)((4 * n + 31) / 32);
    dbl_chain_kernel<<<blocks, 32, 0, (cudaStream_t)stream>>>(
        (const uint8_t *)xy, n, steps, (uint8_t *)out);
    return (int)cudaGetLastError();
}

extern "C" const char *cuda_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
