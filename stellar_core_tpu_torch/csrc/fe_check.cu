// A check kernel, not a port of a TPU kernel: one field op per thread on
// random operands, so chip_smoke.py can hold fe25519.cuh against the plain
// field version over many pairs on the card (verify.cuh: fe_check_one).
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

extern "C" const char *cuda_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
