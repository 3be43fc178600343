// Fused 8x8 DCT-II + quantize + zigzag for one image plane, for Hopper (sm_90a).
//
// Replaces selkies_tpu/ops/pallas_dct.py:dct8_quant_raster (the Pallas TPU
// kernel, with its zigzag wrapper dct8_quant_zigzag) followed by the int16
// cast the JPEG step applies (selkies_tpu/encoder/jpeg.py:_encode_body).
//
//   in : plane   [H, W]       f32  (H % 8 == 0, W % 8 == 0; any W, so the
//                                   544x960 chroma planes of 1080p fit)
//        recip   [nq, 8, 8]   f32  reciprocal quant tables (1/table, f32)
//        row_idx [H/8]        i32  table index of each 8-row band
//        cmat    [8, 8]       f32  the orthonormal DCT-II matrix C
//   out: coeffs  [H/8, W/8, 64] i16 round_half_even((C (X-128) C^T) * recip)
//                                   in zigzag order
//
// What bounds it on the card: memory, not arithmetic. At 1080p one frame
// moves ~8.4 MB of f32 in and ~4.2 MB of int16 out for luma (1088x1920),
// plus ~6.3 MB for the two 544x960 chroma planes: ~19 MB, ~6 us at
// 3.35 TB/s. The arithmetic is ~0.1 GFLOP per frame, negligible against
// 67 TFLOP/s of f32. So the design reads each pixel once with coalesced
// 16-byte loads, keeps the whole 8x8 block in registers through both DCT
// passes, and writes each coefficient once as int16 through a shared-memory
// tile, so the zigzag permutation costs no extra pass over device memory.
//
// Design (simple first; wgmma/TMA are later work): one thread per 8x8
// block, 64 blocks of one block row per thread block. Thread t loads its
// block's 8 rows as float4 pairs (neighbouring threads read neighbouring
// 32-byte runs of the same image row), runs the vertical pass C*X and the
// horizontal pass (.)*C^T with f32 fused multiply-adds, multiplies by the band's
// reciprocal table and rounds half to even (__float2int_rn, the rounding
// jnp.round uses — never roundf). The Pallas kernel's 128x128
// block-diagonal matmul existed only to feed the TPU's MXU; it is not
// carried over.
//
// Numerics: every 8-term sum runs in one fixed order of correctly rounded
// f32 operations (dot8 below), the order the plain PyTorch version
// (ops/dct.py:block_dct2) and XLA:CPU use, so the kernel and the plain
// version agree bit for bit except where the plain version's f64-emulated
// FMA double-rounds (vanishingly rare). The kernel is held to its plain
// version with max |diff| <= 1 and >= 99.9% equal; chip_smoke.py reports
// the observed count of differing coefficients.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlocksPerCta = 64;        // 8x8 blocks per thread block
constexpr int kOutStride = 66;           // shorts per staged block (+2 pad:
                                         // 33 words, conflict-free banks)

// kInvZigzag[r] = zigzag position of raster index r (inverse of ZIGZAG).
__device__ __constant__ int kInvZigzag[64] = {
     0,  1,  5,  6, 14, 15, 27, 28,
     2,  4,  7, 13, 16, 26, 29, 42,
     3,  8, 12, 17, 25, 30, 41, 43,
     9, 11, 18, 24, 31, 40, 44, 53,
    10, 19, 23, 32, 39, 45, 52, 54,
    20, 22, 33, 38, 46, 51, 55, 60,
    21, 34, 37, 47, 50, 56, 59, 61,
    35, 36, 48, 49, 57, 58, 62, 63,
};

// One 8-term dot product a . c, summed in the order of the plain version
// (and of XLA:CPU's f32 dot, which the JAX step runs on the CPU): four
// chains acc_m = fma(a[m+4], c[m+4], a[m]*c[m]), added as a tree. The
// explicit _rn intrinsics keep nvcc from contracting or reordering them.
__device__ __forceinline__ float dot8(float a0, float a1, float a2, float a3,
                                      float a4, float a5, float a6, float a7,
                                      const float* c) {
    const float s0 = __fmaf_rn(a4, c[4], __fmul_rn(a0, c[0]));
    const float s1 = __fmaf_rn(a5, c[5], __fmul_rn(a1, c[1]));
    const float s2 = __fmaf_rn(a6, c[6], __fmul_rn(a2, c[2]));
    const float s3 = __fmaf_rn(a7, c[7], __fmul_rn(a3, c[3]));
    return __fadd_rn(__fadd_rn(s0, s1), __fadd_rn(s2, s3));
}

__global__ void __launch_bounds__(kBlocksPerCta)
dct8_quant_zigzag_kernel(const float* __restrict__ plane,
                         const float* __restrict__ recip,
                         const int* __restrict__ row_idx,
                         const float* __restrict__ cmat,
                         int16_t* __restrict__ out,
                         int W, int nq) {
    __shared__ float sC[64];
    __shared__ float sR[64];
    __shared__ __align__(16) int16_t sOut[kBlocksPerCta * kOutStride];

    const int t = threadIdx.x;
    const int by = blockIdx.y;
    const int bxn = W >> 3;
    const int bx0 = blockIdx.x * kBlocksPerCta;

    int q = row_idx[by];
    q = q < 0 ? 0 : (q >= nq ? nq - 1 : q);   // clamp like a jnp gather
    sC[t] = cmat[t];
    sR[t] = recip[q * 64 + t];
    __syncthreads();

    const int bx = bx0 + t;
    if (bx < bxn) {
        float x[8][8];
        const float* src = plane + (size_t)(by * 8) * W + (size_t)bx * 8;
#pragma unroll
        for (int r = 0; r < 8; ++r) {
            const float4 a = *reinterpret_cast<const float4*>(src + (size_t)r * W);
            const float4 b = *reinterpret_cast<const float4*>(src + (size_t)r * W + 4);
            x[r][0] = a.x - 128.0f; x[r][1] = a.y - 128.0f;
            x[r][2] = a.z - 128.0f; x[r][3] = a.w - 128.0f;
            x[r][4] = b.x - 128.0f; x[r][5] = b.y - 128.0f;
            x[r][6] = b.z - 128.0f; x[r][7] = b.w - 128.0f;
        }
        // vertical pass, column by column: v[i][k] = sum_j C[i][j] x[j][k]
#pragma unroll
        for (int k = 0; k < 8; ++k) {
            float col[8];
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                col[i] = dot8(x[0][k], x[1][k], x[2][k], x[3][k], x[4][k],
                              x[5][k], x[6][k], x[7][k], sC + i * 8);
            }
#pragma unroll
            for (int i = 0; i < 8; ++i) x[i][k] = col[i];
        }
        // horizontal pass, row by row: y[i][l] = sum_k v[i][k] C[l][k];
        // then quantize and stage in zigzag order
        int16_t* dst = sOut + t * kOutStride;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
            for (int l = 0; l < 8; ++l) {
                const float acc = dot8(x[i][0], x[i][1], x[i][2], x[i][3],
                                       x[i][4], x[i][5], x[i][6], x[i][7],
                                       sC + l * 8);
                const int qv = __float2int_rn(__fmul_rn(acc, sR[i * 8 + l]));
                dst[kInvZigzag[i * 8 + l]] = (int16_t)qv;
            }
        }
    }
    __syncthreads();

    // coalesced store of the staged blocks: consecutive blocks of one block
    // row are contiguous in [H/8, W/8, 64], written as 32-bit pairs
    const int nvalid = min(kBlocksPerCta, bxn - bx0);
    int32_t* dst = reinterpret_cast<int32_t*>(
        out + ((size_t)by * bxn + bx0) * 64);
    for (int p = t; p < nvalid * 32; p += kBlocksPerCta) {
        const int blk = p >> 5;
        const int w = p & 31;
        dst[p] = *reinterpret_cast<const int32_t*>(
            sOut + blk * kOutStride + 2 * w);
    }
}

}  // namespace

// C interface (bound with ctypes by selkies_tpu_torch/ops/dct_quant.py).
// Launches on `stream` and returns cudaGetLastError() after the launch.
extern "C" int dct8_quant_zigzag_launch(const float* plane, const float* recip,
                                        const int* row_idx, const float* cmat,
                                        int16_t* out, int H, int W, int nq,
                                        void* stream) {
    if (H <= 0 || W <= 0 || (H & 7) || (W & 7) || nq <= 0) {
        return (int)cudaErrorInvalidValue;
    }
    const int bxn = W >> 3;
    dim3 grid((bxn + kBlocksPerCta - 1) / kBlocksPerCta, H >> 3);
    dct8_quant_zigzag_kernel<<<grid, kBlocksPerCta, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        plane, recip, row_idx, cmat, out, W, nq);
    return (int)cudaGetLastError();
}
