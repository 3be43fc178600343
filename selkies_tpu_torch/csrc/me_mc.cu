// Exhaustive integer-pel motion search + motion compensation for the H.264
// P path, for Hopper (sm_90a).
//
// Replaces selkies_tpu/ops/pallas_me.py:me_mc_stripes (the Pallas TPU
// kernel _me_mc_kernel). Same function: for every 16x16 macroblock of every
// stripe, the (dy, dx) in [-search, search]^2 with the least SAD against the
// stripe's replicate-padded reference, ties to the lowest rank of the
// sorted offset table (ops/motion.py:_offsets); then the winning luma
// prediction and the §8.4.2.2.2 chroma bilinear ({0,4}/8 weights,
// +32 >> 6).
//
//   in : cur, ref          [S, h, w]      u8   (h % 16 == 0, w % 16 == 0)
//        ref_cb, ref_cr    [S, h/2, w/2]  u8
//        offsets           [n, 2]         i32  (dy, dx) in rank order
//   out: mv                [S, h/16, w/16, 2] i32
//        pred_y            [S, h, w]      u8
//        pred_cb, pred_cr  [S, h/2, w/2]  u8
//
// What bounds it on the card: operations. At 1080p (17 stripes of
// 64x1920) the search takes 625 offsets x 2,088,960 luma pixels = 1.31 G
// absolute differences and as many additions, while every input and
// output together is ~8.4 MB (~2.5 us at 3.35 TB/s). The card does four
// byte differences in one VABSDIFF4 (__vabsdiffu4) and sums four bytes in
// one IDP.4A (__dp4a against 0x01010101), so the search needs at least
// 0.65 G such instructions; at 132 SMs x 64 lanes x the SM clock that is
// the bound (chip_smoke.py computes it with the clock it read). This
// kernel issues more than those two per 4 pixel-offsets: a shared load of
// the reference word, a shared load of the current word and a funnel
// shift for the unaligned reference, so it runs well above the bound.
//
// Design (simple first; TMA staging, warp specialisation and early exit
// are later work):
//  * search pass: one thread block per (stripe, MB row, run of 8 MBs). It
//    stages the current 16x128 tile and its reference window
//    (16+2s) x (128+2s) bytes in shared memory (under 10 KB at s = 12),
//    with the source coordinates clamped to the stripe: the per-stripe
//    replicate padding of the JAX package, never reading the next stripe.
//    Each of 320 threads owns one offset at a time (625 offsets = two
//    rounds) and sums the SAD of all 8 MBs of the run for it, reading the
//    unaligned reference words with __funnelshift_r. The winner is the
//    minimum of key = (sad << 10) | rank (sad <= 65,280 and rank < 1024),
//    reduced with __reduce_min_sync and a shared-memory atomicMin: the
//    JAX kernel's rule (lower SAD, then lower rank), whatever order the
//    threads run in.
//  * prediction pass: one thread per output pixel copies luma from the
//    clamped reference at its MB's winning (dy, dx), or computes the chroma
//    bilinear with arithmetic >> and & from the clamped chroma reference.
//    The TPU kernel's whole-window roll, its f32 indicator matmul for the
//    SAD sums and its mask expansion by matmul existed only for the TPU's
//    vector and matrix units; none is carried over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMb = 16;
constexpr int kMbPerBlock = 8;
constexpr int kTileW = kMb * kMbPerBlock;            // 128 current pixels
constexpr int kThreads = 320;
constexpr int kMaxSearch = 15;                       // rank < 961 < 1024
constexpr int kWinRows = kMb + 2 * kMaxSearch;
constexpr int kWinStride = 41;                       // words per window row
static_assert(4 * kWinStride >= kTileW + 2 * kMaxSearch + 4,
              "window row must hold the funnel-shift's last word");

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void __launch_bounds__(kThreads)
me_search_kernel(const uint8_t* __restrict__ cur,
                 const uint8_t* __restrict__ ref,
                 const int* __restrict__ offsets, int n_off, int search,
                 int h, int w, int32_t* __restrict__ mv) {
    __shared__ uint32_t sCur[kMb * kTileW / 4];
    __shared__ uint32_t sRef[kWinRows * kWinStride];
    __shared__ unsigned sBest[kMbPerBlock];

    const int tid = threadIdx.x;
    const int s = blockIdx.z;
    const int mby = blockIdx.y;
    const int mb0 = blockIdx.x * kMbPerBlock;
    const int nby = h / kMb, nbx = w / kMb;
    const uint8_t* c = cur + (size_t)s * h * w;
    const uint8_t* r = ref + (size_t)s * h * w;

    uint8_t* sCurB = reinterpret_cast<uint8_t*>(sCur);
    for (int i = tid; i < kMb * kTileW; i += kThreads) {
        const int row = i / kTileW, col = i % kTileW;
        const int x = min(mb0 * kMb + col, w - 1);   // past the last MB:
        sCurB[i] = c[(size_t)(mby * kMb + row) * w + x];   // never written
    }
    uint8_t* sRefB = reinterpret_cast<uint8_t*>(sRef);
    const int win_rows = kMb + 2 * search;
    for (int i = tid; i < win_rows * 4 * kWinStride; i += kThreads) {
        const int row = i / (4 * kWinStride), col = i % (4 * kWinStride);
        const int y = clampi(mby * kMb - search + row, 0, h - 1);
        const int x = clampi(mb0 * kMb - search + col, 0, w - 1);
        sRefB[i] = r[(size_t)y * w + x];
    }
    if (tid < kMbPerBlock) sBest[tid] = 0xFFFFFFFFu;
    __syncthreads();

    unsigned best[kMbPerBlock];
#pragma unroll
    for (int m = 0; m < kMbPerBlock; ++m) best[m] = 0xFFFFFFFFu;

    for (int rank = tid; rank < n_off; rank += kThreads) {
        const int dy = offsets[2 * rank];
        const int dx = offsets[2 * rank + 1];
        const int bx = dx + search;                  // window byte column
        const unsigned shift = 8u * (bx & 3);
        unsigned sad[kMbPerBlock];
#pragma unroll
        for (int m = 0; m < kMbPerBlock; ++m) sad[m] = 0;
        for (int row = 0; row < kMb; ++row) {
            const uint32_t* rw = sRef + (row + dy + search) * kWinStride
                + (bx >> 2);
            const uint32_t* cw = sCur + row * (kTileW / 4);
            uint32_t lo = rw[0];
#pragma unroll
            for (int m = 0; m < kMbPerBlock; ++m) {
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    const uint32_t hi = rw[m * 4 + k + 1];
                    const uint32_t rv = __funnelshift_r(lo, hi, shift);
                    sad[m] = __dp4a(__vabsdiffu4(cw[m * 4 + k], rv),
                                    0x01010101u, sad[m]);
                    lo = hi;
                }
            }
        }
#pragma unroll
        for (int m = 0; m < kMbPerBlock; ++m) {
            const unsigned key = (sad[m] << 10) | (unsigned)rank;
            best[m] = min(best[m], key);
        }
    }
#pragma unroll
    for (int m = 0; m < kMbPerBlock; ++m) {
        const unsigned v = __reduce_min_sync(0xFFFFFFFFu, best[m]);
        if ((tid & 31) == 0) atomicMin(&sBest[m], v);
    }
    __syncthreads();
    if (tid < kMbPerBlock && mb0 + tid < nbx) {
        const int rank = (int)(sBest[tid] & 1023u);
        int32_t* o = mv + (((size_t)s * nby + mby) * nbx + mb0 + tid) * 2;
        o[0] = offsets[2 * rank];
        o[1] = offsets[2 * rank + 1];
    }
}

__global__ void __launch_bounds__(256)
mc_pred_kernel(const uint8_t* __restrict__ ref,
               const uint8_t* __restrict__ ref_cb,
               const uint8_t* __restrict__ ref_cr,
               const int32_t* __restrict__ mv, int S, int h, int w,
               uint8_t* __restrict__ pred_y, uint8_t* __restrict__ pred_cb,
               uint8_t* __restrict__ pred_cr) {
    const int nby = h / kMb, nbx = w / kMb;
    const int hc = h / 2, wc = w / 2;
    const size_t n_y = (size_t)S * h * w;
    const size_t n_c = (size_t)S * hc * wc;
    size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n_y) {
        const int s = (int)(i / ((size_t)h * w));
        const int rem = (int)(i % ((size_t)h * w));
        const int y = rem / w, x = rem % w;
        const int32_t* m = mv + (((size_t)s * nby + y / kMb) * nbx
                                 + x / kMb) * 2;
        const int sy = clampi(y + m[0], 0, h - 1);
        const int sx = clampi(x + m[1], 0, w - 1);
        pred_y[i] = ref[(size_t)s * h * w + (size_t)sy * w + sx];
        return;
    }
    i -= n_y;
    if (i >= 2 * n_c) return;
    const bool is_cr = i >= n_c;
    if (is_cr) i -= n_c;
    const int s = (int)(i / ((size_t)hc * wc));
    const int rem = (int)(i % ((size_t)hc * wc));
    const int yc = rem / wc, xc = rem % wc;
    const int32_t* m = mv + (((size_t)s * nby + yc / 8) * nbx + xc / 8) * 2;
    const int dy = m[0], dx = m[1];
    const int iy = dy >> 1, ix = dx >> 1;            // arithmetic shift
    const int yf = (dy & 1) * 4, xf = (dx & 1) * 4;
    const int y0 = clampi(yc + iy, 0, hc - 1), y1 = clampi(yc + iy + 1, 0, hc - 1);
    const int x0 = clampi(xc + ix, 0, wc - 1), x1 = clampi(xc + ix + 1, 0, wc - 1);
    const uint8_t* p = (is_cr ? ref_cr : ref_cb) + (size_t)s * hc * wc;
    const int tl = p[y0 * wc + x0], tr = p[y0 * wc + x1];
    const int bl = p[y1 * wc + x0], br = p[y1 * wc + x1];
    const int v = ((8 - xf) * (8 - yf) * tl + xf * (8 - yf) * tr
                   + (8 - xf) * yf * bl + xf * yf * br + 32) >> 6;
    (is_cr ? pred_cr : pred_cb)[(size_t)s * hc * wc + rem] = (uint8_t)v;
}

}  // namespace

// C interface (bound with ctypes by selkies_tpu_torch/ops/me_mc.py).
// Launches the search and the prediction pass on `stream`; returns
// cudaGetLastError() after each launch (0 when both were accepted).
extern "C" int me_mc_launch(const uint8_t* cur, const uint8_t* ref,
                            const uint8_t* ref_cb, const uint8_t* ref_cr,
                            const int* offsets, int n_off, int search,
                            int S, int h, int w, int32_t* mv,
                            uint8_t* pred_y, uint8_t* pred_cb,
                            uint8_t* pred_cr, void* stream) {
    if (S <= 0 || h <= 0 || w <= 0 || h % kMb || w % kMb || search < 0
        || search > kMaxSearch || n_off != (2 * search + 1) * (2 * search + 1)) {
        return (int)cudaErrorInvalidValue;
    }
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    dim3 grid((w / kMb + kMbPerBlock - 1) / kMbPerBlock, h / kMb, S);
    me_search_kernel<<<grid, kThreads, 0, st>>>(cur, ref, offsets, n_off,
                                                search, h, w, mv);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const size_t total = (size_t)S * h * w + 2 * (size_t)S * (h / 2) * (w / 2);
    const unsigned blocks = (unsigned)((total + 255) / 256);
    mc_pred_kernel<<<blocks, 256, 0, st>>>(ref, ref_cb, ref_cr, mv, S, h, w,
                                           pred_y, pred_cb, pred_cr);
    return (int)cudaGetLastError();
}
