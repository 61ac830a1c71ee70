// K-G: the generic (cold-key) Ed25519 verify kernel, and K-W, its
// windows form; four lanes a signature, both on verify.cuh's
// verify_joint_quad.
//
// K-G replaces ed25519.verify_forward_raw / _verify_kernel_raw
// (stellar_core_tpu/accel/ed25519.py:157-184), which runs
// curve.double_scalarmult_w2 and point_encode (curve.py:125-184).
// Bound on the H100: integer multiply-adds.  Per signature: 127 steps of two
// doublings (4 squares + 4 multiplies each) and one precomputed add (8
// multiplies), the 16-entry table, and the encode's inversion; about
// 2.8e5 32-bit multiply-adds, against 97 bytes moved: 0.14 ms for the
// 8,192-signature chunk at 132 SMs x 64 lanes x 1.98 GHz.
//
// K-W replaces ed25519.verify_forward / _verify_kernel
// (stellar_core_tpu/accel/ed25519.py:142-154), the graft entry's step: the
// caller gives the (127, N) int32 windows, MSB first, and per signature the
// key rows of -A.  The lanes of quad i read window t at windows[t * N + i],
// so a warp's loads of a step are 32 consecutive bytes.  Same bound as K-G
// (the same multiply-adds a signature); it moves 637 bytes a signature.
// With a count pointer it also adds the number accepted to *count, one
// atomicAdd a warp of __popc(__ballot_sync(...)) over lane 0 of each quad:
// the accept-count psum of __graft_entry__.dryrun_multichip (:103-106),
// fused.
//
// The design, against latency.  A signature's chain is about 3,400 field
// products in a row; one thread a signature left each product's latency
// with nothing else to issue (1.29 ms at 8,192, 9x the bound) and held the
// 2,560-byte table in local memory, read by a data-dependent index every
// step.  Here a quad of lanes works a signature (ge25519_quad.cuh): each
// lane computes one of the four independent products of a stage, so a step
// is 6 product latencies, not 24, and 8,192 signatures are 32,768 threads,
// about 8 warps on each SM.  With 8 warps an SM the card is then bound by
// the instructions a lane issues, so the stage operands are summed and
// carried in 32-bit words and each lane carries only its two operands.
// Lane k keeps coordinate k of the 16
// precomputed entries in shared memory (640 bytes a lane), laid out
// [entry][limb][thread], so a warp's load of a limb is conflict-free
// whichever windows its quads take.  A block is VQ_THREADS = 64 threads
// (16 signatures, 40 KiB of table): the 8,192 chunk is 512 blocks, at most
// four an SM, all resident at once; the admission chunk of 2,048 spreads
// over 128 SMs.  Rows past n run on row n - 1 and store nothing, so every
// lane reaches every shuffle.
#include <cuda_runtime.h>

#include "verify.cuh"

#define VQ_THREADS 64
#define VQ_MIN_BLOCKS 4
// a thread's 16 entries of 10 limbs, 4 bytes each
#define VQ_SMEM (16 * FE_NLIMB * 4 * VQ_THREADS)

__global__ void __launch_bounds__(VQ_THREADS, VQ_MIN_BLOCKS)
verify_generic_kernel(const uint8_t *__restrict__ s,
                      const uint8_t *__restrict__ h,
                      const uint8_t *__restrict__ r,
                      const int32_t *__restrict__ key_idx, int64_t n,
                      const uint8_t *__restrict__ keys, int64_t nk,
                      uint8_t *__restrict__ out) {
    extern __shared__ uint32_t tab_words[];
    QTab tab{tab_words + threadIdx.x, VQ_THREADS};
    int64_t i = ((int64_t)blockIdx.x * VQ_THREADS + threadIdx.x) >> 2;
    uint8_t ok = verify_generic_quad(i, n, s, h, r, key_idx, keys, nk, tab);
    if (i < n && q_lane() == 0) out[i] = ok;
}

// Blocks of VQ_THREADS for n signatures, the table's shared memory allowed
// and preferred over L1; 0 or the CUDA error.
static int vq_prepare(const void *kernel, int64_t n, unsigned *blocks) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, VQ_SMEM);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(kernel,
                                   cudaFuncAttributePreferredSharedMemoryCarveout,
                                   cudaSharedmemCarveoutMaxShared);
    *blocks = (unsigned)((4 * n + VQ_THREADS - 1) / VQ_THREADS);
    return (int)err;
}

extern "C" int verify_generic_launch(const void *s, const void *h,
                                     const void *r, const void *key_idx,
                                     int64_t n, const void *keys, int64_t nk,
                                     void *out, void *stream) {
    unsigned blocks;
    int err = vq_prepare((const void *)verify_generic_kernel, n, &blocks);
    if (err != 0) return err;
    verify_generic_kernel<<<blocks, VQ_THREADS, VQ_SMEM, (cudaStream_t)stream>>>(
        (const uint8_t *)s, (const uint8_t *)h, (const uint8_t *)r,
        (const int32_t *)key_idx, n, (const uint8_t *)keys, nk,
        (uint8_t *)out);
    return (int)cudaGetLastError();
}

__global__ void __launch_bounds__(VQ_THREADS, VQ_MIN_BLOCKS)
verify_windows_kernel(const int32_t *__restrict__ windows,
                      const uint8_t *__restrict__ keys,
                      const uint8_t *__restrict__ r, int64_t n,
                      uint8_t *__restrict__ out, int32_t *count) {
    extern __shared__ uint32_t tab_words[];
    QTab tab{tab_words + threadIdx.x, VQ_THREADS};
    int64_t i = ((int64_t)blockIdx.x * VQ_THREADS + threadIdx.x) >> 2;
    uint8_t ok = verify_windows_quad(i, n, windows, keys, r, tab);
    if (i < n && q_lane() == 0) out[i] = ok;
    // every lane of the warp reaches the ballot: no thread returned early,
    // the block is whole warps, and count is the same for the whole grid
    if (count != nullptr) {
        unsigned votes = __ballot_sync(0xffffffffu,
                                       quad_vote(q_lane(), i, n, ok));
        if ((threadIdx.x & 31) == 0 && votes != 0)
            atomicAdd(count, __popc(votes));
    }
}

extern "C" int verify_windows_launch(const void *windows, const void *keys,
                                     const void *r, int64_t n, void *out,
                                     void *count, void *stream) {
    unsigned blocks;
    int err = vq_prepare((const void *)verify_windows_kernel, n, &blocks);
    if (err != 0) return err;
    verify_windows_kernel<<<blocks, VQ_THREADS, VQ_SMEM, (cudaStream_t)stream>>>(
        (const int32_t *)windows, (const uint8_t *)keys, (const uint8_t *)r,
        n, (uint8_t *)out, (int32_t *)count);
    return (int)cudaGetLastError();
}

extern "C" const char *cuda_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
