// Fused 8x8 DCT-II + quantize + zigzag for the planes of one frame, in one
// launch, for Hopper (sm_90a).
//
// Replaces selkies_tpu/ops/pallas_dct.py:dct8_quant_raster (the Pallas TPU
// kernel, with its zigzag wrapper dct8_quant_zigzag) followed by the int16
// cast the JPEG step applies (selkies_tpu/encoder/jpeg.py:_encode_body).
//
//   in : per plane (up to 3: Y, Cb, Cr)
//        plane   [H, W]       f32  (H % 8 == 0, W % 8 == 0, rows `pitch`
//                                   floats apart, pitch % 4 == 0)
//        recip   [nq, 8, 8]   f32  reciprocal quant tables (1/table, f32)
//        row_idx [H/8]        i32  table index of each 8-row band
//        cmat    [8, 8]       f32  the orthonormal DCT-II matrix C (all
//                                  planes; copied into the launch's
//                                  arguments)
//   out: coeffs  [H/8, W/8, 64] i16 round_half_even((C (X-128) C^T) * recip)
//                                   in zigzag order
//
// What bounds it on the card: memory, not arithmetic. At 1080p one frame
// moves ~8.4 MB of f32 in and ~4.2 MB of int16 out for luma (1088x1920),
// plus ~6.3 MB for the two 544x960 chroma planes: ~19 MB, ~6 us at
// 3.35 TB/s. The arithmetic is ~0.1 GFLOP per frame, negligible against
// 67 TFLOP/s of f32.
//
// Design. A launch per plane, with a thread per 8x8 block, gives each SM
// one block of two warps for a 1080p chroma plane: the frame's time goes
// to three small grids ramping up and draining. So:
//  * one launch per frame: the grid is a flat range of tiles, Y's first,
//    then Cb's, then Cr's; a tile is 32 consecutive 8x8 blocks of one
//    plane in raster order (so its 32 x 128 output bytes are contiguous),
//    and each plane's pointers, pitch and tile offset ride in the kernel's
//    argument struct. A plane may be a strided view (its pitch), so the
//    caller's chroma planes need no copy;
//  * eight threads per 8x8 block, 256 per thread block (eight resident
//    per SM, 2,048 threads): thread t loads column t of its block (each
//    load of a warp reads 4 blocks' rows, 32 contiguous bytes each: whole
//    sectors) and computes column t of the vertical pass; the result is
//    transposed through shared memory so thread t computes row t of the
//    horizontal pass, quantizes it with its table row (two 16-byte loads,
//    issued at the start) and stages it in zigzag order; each warp then
//    writes its 4 blocks' 512 output bytes with 16-byte stores. Only the
//    warp's own lanes share data, so __syncwarp is the only barrier;
//  * C rides in the launch's arguments, so its uniform reads are operands
//    from the constant bank, and a thread's zigzag positions come from
//    eight 64-bit literals (one per output column, a byte per row): no
//    shared table to stage, no table read whose index differs by lane.
//
// Numerics: every output comes from dot8 below in the order of the plain
// PyTorch version (ops/dct.py:block_dct2) and XLA:CPU, with correctly
// rounded f32 operations; splitting a block across threads does not change
// any output's operations or their order. The kernel is held to its plain
// version with max |diff| <= 1 and >= 99.9% equal; chip_smoke.py reports
// the observed count of differing coefficients.

#include <cuda_runtime.h>
#include <stdint.h>

// one plane of the launch; the C interface's argument type (ctypes mirrors
// it in ops/dct_quant.py), so it has external linkage
struct Plane {
    const float* plane;
    const float* recip;
    const int* row_idx;
    int16_t* out;
    int H, W, pitch, nq;
};

namespace {

constexpr int kMaxPlanes = 3;
constexpr int kBlocksPerTile = 32;
constexpr int kThreads = 8 * kBlocksPerTile;          // one row per thread
// a staged block is 8 rows of 9 floats (72 per block): element (b, j, k)
// of the warp's 4 blocks sits in bank 8b + 9j + k mod 32, so a warp's row
// writes and column reads both hit 32 different banks
constexpr int kRow = 9;
constexpr int kXStride = 8 * kRow;

// staged output block: 72 int16 (144 bytes, 16-byte aligned), so the same
// position of a warp's 4 blocks falls in 4 different banks
constexpr int kOutStride = 72;

// kZigCol[l] byte t = zigzag position of raster index t*8 + l (the inverse
// of ZIGZAG, one column of it per word; read with the unrolled l, so the
// same word for every lane)
__device__ __constant__ unsigned long long kZigCol[8] = {
    0x2315140a09030200ull, 0x242216130b080401ull, 0x30252117120c0705ull,
    0x312f262018110d06ull, 0x39322e271f19100eull, 0x3a38332d281e1a0full,
    0x3e3b37342c291d1bull, 0x3f3d3c36352b2a1cull,
};

struct Frame {
    Plane p[kMaxPlanes];
    int tile_end[kMaxPlanes];            // exclusive end of each plane's tiles
    int n_planes;
    float c[64];                         // the DCT matrix C, row-major
};

// One 8-term dot product a . c, summed in the order of the plain version
// (and of XLA:CPU's f32 dot, which the JAX step runs on the CPU): four
// chains acc_m = fma(a[m+4], c[m+4], a[m]*c[m]), added as a tree. The
// explicit _rn intrinsics keep nvcc from contracting or reordering them.
__device__ __forceinline__ float dot8(const float* a, const float* c) {
    const float s0 = __fmaf_rn(a[4], c[4], __fmul_rn(a[0], c[0]));
    const float s1 = __fmaf_rn(a[5], c[5], __fmul_rn(a[1], c[1]));
    const float s2 = __fmaf_rn(a[6], c[6], __fmul_rn(a[2], c[2]));
    const float s3 = __fmaf_rn(a[7], c[7], __fmul_rn(a[3], c[3]));
    return __fadd_rn(__fadd_rn(s0, s1), __fadd_rn(s2, s3));
}

__global__ void __launch_bounds__(kThreads)
dct8_quant_zigzag_kernel(const __grid_constant__ Frame f) {
    __shared__ float sX[kBlocksPerTile * kXStride];
    __shared__ __align__(16) int16_t sOut[kBlocksPerTile * kOutStride];

    const int tid = threadIdx.x;
    const int tb = blockIdx.x;
    const int pi = tb < f.tile_end[0] ? 0 : (tb < f.tile_end[1] ? 1 : 2);
    const Plane P = pi == 0 ? f.p[0] : (pi == 1 ? f.p[1] : f.p[2]);
    const int tile = tb - (pi == 0 ? 0 : (pi == 1 ? f.tile_end[0] : f.tile_end[1]));

    const int b = tid >> 3, t = tid & 7;
    const int bxn = P.W >> 3;
    const int n_blocks = (P.H >> 3) * bxn;
    const int blk = tile * kBlocksPerTile + b;          // raster block index
    const bool ok = blk < n_blocks;
    const int by = ok ? blk / bxn : 0, bx = ok ? blk % bxn : 0;
    float* xs = sX + b * kXStride;

    // the band's table index, then column t of the block, level-shifted
    // (a block row's 8 floats are 32 contiguous bytes across its 8 lanes)
    int q = ok ? P.row_idx[by] : 0;
    float x[8];
    const float* src = P.plane + (size_t)(by * 8) * P.pitch + bx * 8 + t;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        x[j] = ok ? __fsub_rn(src[(size_t)j * P.pitch], 128.0f) : 0.0f;
    }
    q = q < 0 ? 0 : (q >= P.nq ? P.nq - 1 : q);   // clamp like a jnp gather
    const float4 ra = *reinterpret_cast<const float4*>(P.recip + q * 64 + t * 8);
    const float4 rb = *reinterpret_cast<const float4*>(P.recip + q * 64 + t * 8 + 4);
    const float rq[8] = {ra.x, ra.y, ra.z, ra.w, rb.x, rb.y, rb.z, rb.w};
    // vertical pass, column t: v[i][t] = sum_j C[i][j] x[j][t]; transposed
    // through shared memory so thread t then holds row t of the result
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = dot8(x, f.c + i * 8);
#pragma unroll
    for (int i = 0; i < 8; ++i) xs[i * kRow + t] = v[i];
    __syncwarp();
    // horizontal pass, row t: y[t][l] = sum_k v[t][k] C[l][k]; quantize
    // with the band's table and stage in zigzag order
#pragma unroll
    for (int k = 0; k < 8; ++k) x[k] = xs[t * kRow + k];
    int16_t* dst = sOut + b * kOutStride;
#pragma unroll
    for (int l = 0; l < 8; ++l) {
        const float acc = dot8(x, f.c + l * 8);
        const int zz = (int)(kZigCol[l] >> (8 * t)) & 63;
        dst[zz] = (int16_t)__float2int_rn(__fmul_rn(acc, rq[l]));
    }
    __syncwarp();

    // the warp's 4 blocks are consecutive in [H/8, W/8, 64]: 512 bytes,
    // 16 per lane
    const int lane = tid & 31;
    const int wblk = (tid >> 5) * 4;              // first block of the warp
    const int first = tile * kBlocksPerTile + wblk;
    if (first + lane / 8 < n_blocks) {
        const uint4 val = *reinterpret_cast<const uint4*>(
            sOut + (wblk + lane / 8) * kOutStride + (lane % 8) * 8);
        *reinterpret_cast<uint4*>(P.out + (size_t)first * 64 + lane * 8) = val;
    }
}

}  // namespace

// C interface (bound with ctypes by selkies_tpu_torch/ops/dct_quant.py).
// planes[0 .. n_planes) as laid out in struct Plane; launches once on
// `stream` and returns cudaGetLastError() after the launch.
extern "C" int dct8_quant_zigzag_launch(const Plane* planes, int n_planes,
                                        const float* cmat, void* stream) {
    // cmat is host memory: the 64 floats are copied into the arguments
    if (n_planes <= 0 || n_planes > kMaxPlanes) return (int)cudaErrorInvalidValue;
    Frame f = {};
    f.n_planes = n_planes;
    int tiles = 0;
    for (int i = 0; i < n_planes; ++i) {
        const Plane& p = planes[i];
        if (p.H <= 0 || p.W <= 0 || (p.H & 7) || (p.W & 7) || p.nq <= 0
            || p.pitch < p.W || (p.pitch & 3)) {
            return (int)cudaErrorInvalidValue;
        }
        f.p[i] = p;
        const int n_blocks = (p.H >> 3) * (p.W >> 3);
        tiles += (n_blocks + kBlocksPerTile - 1) / kBlocksPerTile;
        f.tile_end[i] = tiles;
    }
    for (int i = 0; i < 64; ++i) f.c[i] = cmat[i];
    dct8_quant_zigzag_kernel<<<tiles, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(f);
    return (int)cudaGetLastError();
}
