// K-G: the generic (cold-key) Ed25519 verify kernel, and K-W, its
// windows form; one thread per signature, both on verify.cuh's
// verify_joint_one.
//
// K-G replaces ed25519.verify_forward_raw / _verify_kernel_raw
// (stellar_core_tpu/accel/ed25519.py:157-184), which runs
// curve.double_scalarmult_w2 and point_encode (curve.py:125-184).
// Bound on the H100: integer multiply-adds.  Per signature: 127 steps of two
// doublings (4 squares + 4 multiplies each) and one precomputed add (8
// multiplies), the 16-entry table, and the encode's inversion; about
// 3.2e5 32-bit multiply-adds, against 97 bytes moved.  The design keeps the
// reference's wire format (raw s, h, R bytes and a key index; windows are
// derived here) and its 16-entry joint-window table, held in precomputed
// form; the table (2.5 KiB a thread) lives in local memory, which L1/L2
// serve.
//
// K-W replaces ed25519.verify_forward / _verify_kernel
// (stellar_core_tpu/accel/ed25519.py:142-154), the graft entry's step: the
// caller gives the (127, N) int32 windows, MSB first, and per signature the
// key rows of -A.  Thread i reads window t at windows[t * N + i], so a
// warp's 32 loads of a step are one coalesced 128-byte line.  Same bound as
// K-G (the same multiply-adds a signature); it moves 637 bytes a
// signature.  With a count pointer it also adds the number accepted to
// *count, one atomicAdd a warp of __popc(__ballot_sync(...)): the
// accept-count psum of __graft_entry__.dryrun_multichip (:103-106), fused.
#include <cuda_runtime.h>

#include "verify.cuh"

__global__ void verify_generic_kernel(const uint8_t *__restrict__ s,
                                      const uint8_t *__restrict__ h,
                                      const uint8_t *__restrict__ r,
                                      const int32_t *__restrict__ key_idx,
                                      int64_t n,
                                      const uint8_t *__restrict__ keys,
                                      int64_t nk, uint8_t *__restrict__ out) {
    int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    int32_t k = key_idx[i];
    if (k < 0 || k >= nk) {   // an index the host never sends: reject
        out[i] = 0;
        return;
    }
    out[i] = verify_generic_one(s + 32 * i, h + 32 * i, r + 32 * i,
                                keys + 96 * (int64_t)k);
}

extern "C" int verify_generic_launch(const void *s, const void *h,
                                     const void *r, const void *key_idx,
                                     int64_t n, const void *keys, int64_t nk,
                                     void *out, void *stream) {
    const int threads = 64;
    unsigned blocks = (unsigned)((n + threads - 1) / threads);
    verify_generic_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint8_t *)s, (const uint8_t *)h, (const uint8_t *)r,
        (const int32_t *)key_idx, n, (const uint8_t *)keys, nk,
        (uint8_t *)out);
    return (int)cudaGetLastError();
}

__global__ void verify_windows_kernel(const int32_t *__restrict__ windows,
                                      const uint8_t *__restrict__ keys,
                                      const uint8_t *__restrict__ r,
                                      int64_t n, uint8_t *__restrict__ out,
                                      int32_t *count) {
    int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    uint8_t ok = 0;
    if (i < n) {
        ok = verify_joint_one(GivenWindows{windows + i, n}, r + 32 * i,
                              keys + 96 * i);
        out[i] = ok;
    }
    // every lane of the warp reaches the ballot: no thread returned early,
    // the block is whole warps, and count is the same for the whole grid
    if (count != nullptr) {
        unsigned votes = __ballot_sync(0xffffffffu, ok);
        if ((threadIdx.x & 31) == 0 && votes != 0)
            atomicAdd(count, __popc(votes));
    }
}

extern "C" int verify_windows_launch(const void *windows, const void *keys,
                                     const void *r, int64_t n, void *out,
                                     void *count, void *stream) {
    const int threads = 64;
    unsigned blocks = (unsigned)((n + threads - 1) / threads);
    verify_windows_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int32_t *)windows, (const uint8_t *)keys, (const uint8_t *)r,
        n, (uint8_t *)out, (int32_t *)count);
    return (int)cudaGetLastError();
}

extern "C" const char *cuda_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
