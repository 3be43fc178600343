// Exhaustive integer-pel motion search + motion compensation for the H.264
// P path, for Hopper (sm_90a), in one launch.
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
//        ranks             [n, n]         i32  rank of (dy, dx) at
//                                              [dy+search, dx+search]
//        offsets           [n*n, 2]       i32  (dy, dx) in rank order
//   out: mv                [S, h/16, w/16, 2] i32
//        pred_y            [S, h, w]      u8
//        pred_cb, pred_cr  [S, h/2, w/2]  u8
//
// What bounds it on the card: operations. At 1080p (17 stripes of
// 64x1920) the search takes 625 offsets x 2,088,960 luma pixels = 1.31 G
// absolute differences and as many additions, while every input and
// output together is ~8.4 MB (~2.5 us at 3.35 TB/s). The card's byte-SIMD
// VABSDIFF4 takes the absolute differences of four byte pairs; PTX's
// vabsdiff4.add adds their sum to an accumulator as well. chip_smoke.py
// counts what ptxas made of it in this library's SASS and sets the bound
// from the fewest such instructions per 4 pixel-offsets.
//
// Design:
//  * one thread block per (stripe, MB row, run of 8 MBs); warp g takes the
//    dx values dx_base + 4g + k (k = lane / 8, dx_base = -search rounded
//    down to a multiple of 4) for MB m = lane % 8 of the run, and every dy;
//  * [register reuse] a thread holds its MB's 16x16 current pixels in 64
//    registers and keeps kChunk SAD accumulators, one per dy of a chunk.
//    It walks the kChunk + 15 window rows of the chunk; each 4-word
//    reference row it loads feeds every (current row, dy) pair that uses
//    it: 4 shared loads per 4 x (up to kChunk) x 4 byte-SIMD SADs, not
//    two loads per SAD as with a thread per offset;
//  * [no funnel shift] the reference window is kept four times in shared
//    memory, pre-shifted by 0-3 bytes; a thread's dx fixes its copy
//    (dx & 3 == k), so every load is an aligned word. The four copies'
//    planes start at word offsets congruent to 0-3 mod 32, so the 32 lanes
//    (8 MBs x 4 copies) of a warp hit 32 different banks;
//  * [16-byte staging] the window (rows clamped to the stripe, columns x0-16
//    .. x0+143) is read with 16-byte loads, and each thread writes the
//    runs it read to all four copies at once; a 16-byte run that leaves
//    the stripe (only blocks at its left or right edge have one) is
//    gathered byte by byte with clamped columns: the JAX package's
//    per-stripe replicate pad, never reading the next stripe;
//  * the winner is the minimum of key = (sad << 10) | rank (sad <= 65,280,
//    rank < 1024), reduced over a thread's dys, over the 4 lanes of an MB
//    with shuffles and over warps with a shared atomicMin: the JAX rule
//    (lower SAD, then lower rank) whatever order the threads run in;
//  * [one launch] the block then writes its MBs' luma prediction from the
//    window copy the winning dx selects, and the chroma bilinear from a
//    staged chroma window (rows clamped, columns clamped), four pixels per
//    thread. The TPU kernel's whole-window roll, its f32 indicator matmul
//    for the SAD sums and its mask expansion by matmul existed only for
//    the TPU's vector and matrix units; none is carried over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMb = 16;
constexpr int kTileMbs = 8;                          // MBs per block (lane % 8)
constexpr int kTileW = kMb * kTileMbs;               // 128 current pixels
constexpr int kMaxSearch = 15;                       // rank < 961 < 1024
constexpr int kMaxN = 2 * kMaxSearch + 1;
constexpr int kMaxWarps = 8;                         // dx groups of 4
constexpr int kChunk = 5;                            // dy accumulators
constexpr int kMaxChunks = (kMaxN + kChunk - 1) / kChunk;
constexpr int kMaxWinRows = kMaxChunks * kChunk + kMb - 1;
constexpr int kWinWords = (kTileW + 32) / 4;         // x0-16 .. x0+143
// one pre-shifted copy of the window: a multiple of 32 words plus one, so
// copy k starts at a word offset congruent to k mod 32
constexpr int kPlaneWords = (kMaxWinRows * kWinWords + 31) / 32 * 32 + 1;
// chroma window: rows yc0-8 .. yc0+15, columns xc0-16 .. xc0+79 (96 bytes):
// every tap of the bilinear for |dy|, |dx| <= 15
constexpr int kCRows = 24;
constexpr int kCWords = 24;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

// sum over the four byte pairs of |a - b|, plus c
__device__ __forceinline__ unsigned vsad4(unsigned a, unsigned b, unsigned c) {
    unsigned d;
    asm("vabsdiff4.u32.u32.u32.add %0, %1, %2, %3;"
        : "=r"(d) : "r"(a), "r"(b), "r"(c));
    return d;
}

// 16 bytes of a row from column xs on, each column clamped to [0, n)
__device__ __forceinline__ uint4 gather16(const uint8_t* row, int xs, int n) {
    uint32_t v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        uint32_t word = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
            word |= (uint32_t)row[clampi(xs + 4 * q + b, 0, n - 1)] << (8 * b);
        }
        v[q] = word;
    }
    return make_uint4(v[0], v[1], v[2], v[3]);
}

// the 4 bytes of a row from column xs on (xs % 4 == 0), clamped to [0, n)
__device__ __forceinline__ uint32_t load4(const uint8_t* row, int xs, int n) {
    if (xs >= 0 && xs + 4 <= n) return *reinterpret_cast<const uint32_t*>(row + xs);
    uint32_t word = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
        word |= (uint32_t)row[clampi(xs + b, 0, n - 1)] << (8 * b);
    }
    return word;
}

// one 16-byte run of a row: a vector load when it lies inside the row and
// `vec` says the row is 16-byte aligned, else clamped bytes
__device__ __forceinline__ uint4 load16(const uint8_t* row, int xs, int n,
                                        bool vec) {
    if (vec && xs >= 0 && xs + 16 <= n) {
        return *reinterpret_cast<const uint4*>(row + xs);
    }
    return gather16(row, xs, n);
}

__global__ void __launch_bounds__(kMaxWarps * 32)
me_mc_kernel(const uint8_t* __restrict__ cur, const uint8_t* __restrict__ ref,
             const uint8_t* __restrict__ ref_cb,
             const uint8_t* __restrict__ ref_cr,
             const int* __restrict__ ranks, const int* __restrict__ offsets,
             int search, int h, int w, int32_t* __restrict__ mv,
             uint8_t* __restrict__ pred_y, uint8_t* __restrict__ pred_cb,
             uint8_t* __restrict__ pred_cr) {
    __shared__ __align__(16) uint32_t sWin[4 * kPlaneWords];
    __shared__ __align__(16) uint32_t sChroma[2][kCRows * kCWords];
    __shared__ int sRank[kMaxN * kMaxN];
    __shared__ unsigned sBest[kTileMbs];
    __shared__ int sMv[kTileMbs][2];

    const int tid = threadIdx.x, nthreads = blockDim.x;
    const int s = blockIdx.z, mby = blockIdx.y;
    const int mb0 = blockIdx.x * kTileMbs;
    const int x0 = mb0 * kMb;
    const int nby = h / kMb, nbx = w / kMb;
    const int hc = h / 2, wc = w / 2;
    const int n = 2 * search + 1;
    const int n_chunks = (n + kChunk - 1) / kChunk;
    const int win_rows = n_chunks * kChunk + kMb - 1;
    const uint8_t* c = cur + (size_t)s * h * w;
    const uint8_t* r = ref + (size_t)s * h * w;

    for (int i = tid; i < n * n; i += nthreads) sRank[i] = ranks[i];
    if (tid < kTileMbs) sBest[tid] = 0xFFFFFFFFu;

    // luma window: word j of row i of copy k holds pixels x0-16+4j+k ..
    // +3 of stripe row mby*16 - search + i, both clamped to the stripe.
    // Each thread takes 16-byte runs of copy 0 and the word after each, and
    // writes the run to all four copies
    for (int i = tid; i < win_rows * (kWinWords / 4); i += nthreads) {
        const int row = i / (kWinWords / 4), run = i % (kWinWords / 4);
        const int y = clampi(mby * kMb - search + row, 0, h - 1);
        const uint8_t* src = r + (size_t)y * w;
        const int xs = x0 - 16 + 16 * run;
        const uint4 v = load16(src, xs, w, true);
        const uint32_t wd[5] = {v.x, v.y, v.z, v.w, load4(src, xs + 16, w)};
        uint32_t* dst = sWin + row * kWinWords + 4 * run;
        *reinterpret_cast<uint4*>(dst) = v;
#pragma unroll
        for (int copy = 1; copy < 4; ++copy) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                dst[copy * kPlaneWords + q] =
                    __funnelshift_r(wd[q], wd[q + 1], 8 * copy);
            }
        }
    }
    // chroma windows: row i holds chroma row yc0 - 8 + i, byte b column
    // xc0 - 16 + b, clamped
    const int yc0 = mby * (kMb / 2), xc0 = x0 / 2;
    const bool cvec = (wc % 16) == 0;
    for (int i = tid; i < 2 * kCRows * (kCWords / 4); i += nthreads) {
        const int p = i / (kCRows * (kCWords / 4));
        const int rem = i % (kCRows * (kCWords / 4));
        const int row = rem / (kCWords / 4), run = rem % (kCWords / 4);
        const int y = clampi(yc0 - 8 + row, 0, hc - 1);
        const uint8_t* src = (p ? ref_cr : ref_cb) + (size_t)s * hc * wc
            + (size_t)y * wc;
        *reinterpret_cast<uint4*>(&sChroma[p][row * kCWords + 4 * run]) =
            load16(src, xc0 - 16 + 16 * run, wc, cvec);
    }
    __syncthreads();

    // ---- search ---------------------------------------------------------
    const int warp = tid >> 5, lane = tid & 31;
    const int m = lane & 7, k = lane >> 3;
    const int dx = -((search + 3) & ~3) + 4 * warp + k;   // dx & 3 == k
    const bool dx_ok = dx >= -search && dx <= search;
    // past the last MB of the row: search the last one, write nothing
    const int mb_c = min(mb0 + m, nbx - 1);

    uint32_t cw[kMb][4];
    {
        const uint8_t* cp = c + (size_t)(mby * kMb) * w + mb_c * kMb;
#pragma unroll
        for (int row = 0; row < kMb; ++row) {
            const uint4 v = *reinterpret_cast<const uint4*>(cp + (size_t)row * w);
            cw[row][0] = v.x; cw[row][1] = v.y; cw[row][2] = v.z; cw[row][3] = v.w;
        }
    }
    // byte 16m + 16 + dx of a window row is byte 0 of word 4m + 4 + (dx>>2)
    // in copy dx & 3 (arithmetic >> for negative dx)
    const uint32_t* wbase = sWin + k * kPlaneWords + 4 * m + 4 + (dx >> 2);
    unsigned best = 0xFFFFFFFFu;
    for (int ch = 0; ch < n_chunks; ++ch) {
        // dy = ch*kChunk - search + d; current row r meets window row
        // ch*kChunk + r + d
        unsigned acc[kChunk];
#pragma unroll
        for (int d = 0; d < kChunk; ++d) acc[d] = 0;
        const uint32_t* rowp = wbase + ch * kChunk * kWinWords;
#pragma unroll
        for (int i = 0; i < kChunk + kMb - 1; ++i) {
            const uint32_t r0 = rowp[i * kWinWords + 0];
            const uint32_t r1 = rowp[i * kWinWords + 1];
            const uint32_t r2 = rowp[i * kWinWords + 2];
            const uint32_t r3 = rowp[i * kWinWords + 3];
#pragma unroll
            for (int d = 0; d < kChunk; ++d) {
                const int row = i - d;
                if (row >= 0 && row < kMb) {
                    acc[d] = vsad4(cw[row][0], r0, acc[d]);
                    acc[d] = vsad4(cw[row][1], r1, acc[d]);
                    acc[d] = vsad4(cw[row][2], r2, acc[d]);
                    acc[d] = vsad4(cw[row][3], r3, acc[d]);
                }
            }
        }
#pragma unroll
        for (int d = 0; d < kChunk; ++d) {
            const int dy = ch * kChunk - search + d;
            if (dx_ok && dy <= search) {
                const unsigned key = (acc[d] << 10)
                    | (unsigned)sRank[(dy + search) * n + dx + search];
                best = min(best, key);
            }
        }
    }
    best = min(best, __shfl_xor_sync(0xFFFFFFFFu, best, 8));
    best = min(best, __shfl_xor_sync(0xFFFFFFFFu, best, 16));
    if (k == 0) atomicMin(&sBest[m], best);
    __syncthreads();

    if (tid < kTileMbs) {
        const int rank = (int)(sBest[tid] & 1023u);
        sMv[tid][0] = offsets[2 * rank];
        sMv[tid][1] = offsets[2 * rank + 1];
        if (mb0 + tid < nbx) {
            int32_t* o = mv + (((size_t)s * nby + mby) * nbx + mb0 + tid) * 2;
            o[0] = sMv[tid][0];
            o[1] = sMv[tid][1];
        }
    }
    __syncthreads();

    // ---- luma prediction: 8 MBs x 16 rows x 4 words, from the window ----
    for (int i = tid; i < kTileMbs * kMb * 4; i += nthreads) {
        const int mm = i >> 6, row = (i >> 2) & 15, j = i & 3;
        if (mb0 + mm >= nbx) continue;
        const int dy = sMv[mm][0], dxm = sMv[mm][1];
        const uint32_t v = sWin[(dxm & 3) * kPlaneWords
                                + (row + dy + search) * kWinWords
                                + 4 * mm + 4 + (dxm >> 2) + j];
        *reinterpret_cast<uint32_t*>(
            pred_y + (size_t)s * h * w + (size_t)(mby * kMb + row) * w
            + x0 + mm * kMb + 4 * j) = v;
    }
    // ---- chroma prediction: 2 planes x 8 MBs x 8 rows x 2 words ---------
    for (int i = tid; i < 2 * kTileMbs * 8 * 2; i += nthreads) {
        const int p = i >> 7, mm = (i >> 4) & 7, rr = (i >> 1) & 7, jw = i & 1;
        if (mb0 + mm >= nbx) continue;
        const int dy = sMv[mm][0], dxm = sMv[mm][1];
        const int iy = dy >> 1, ix = dxm >> 1;       // arithmetic shift
        const int yf = (dy & 1) * 4, xf = (dxm & 1) * 4;
        const uint8_t* win = reinterpret_cast<const uint8_t*>(sChroma[p]);
        const uint8_t* t0 = win + (rr + 8 + iy) * (4 * kCWords)
            + mm * 8 + 4 * jw + ix + 16;
        const uint8_t* t1 = t0 + 4 * kCWords;
        uint32_t out = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int v = ((8 - xf) * (8 - yf) * t0[e] + xf * (8 - yf) * t0[e + 1]
                           + (8 - xf) * yf * t1[e] + xf * yf * t1[e + 1] + 32) >> 6;
            out |= (uint32_t)v << (8 * e);
        }
        uint8_t* dst = (p ? pred_cr : pred_cb) + (size_t)s * hc * wc
            + (size_t)(yc0 + rr) * wc + xc0 + mm * 8 + 4 * jw;
        *reinterpret_cast<uint32_t*>(dst) = out;
    }
}

}  // namespace

// C interface (bound with ctypes by selkies_tpu_torch/ops/me_mc.py).
// Launches the kernel on `stream`; returns cudaGetLastError() after the
// launch (0 when it was accepted).
extern "C" int me_mc_launch(const uint8_t* cur, const uint8_t* ref,
                            const uint8_t* ref_cb, const uint8_t* ref_cr,
                            const int* ranks, const int* offsets, int search,
                            int S, int h, int w, int32_t* mv,
                            uint8_t* pred_y, uint8_t* pred_cb,
                            uint8_t* pred_cr, void* stream) {
    if (S <= 0 || h <= 0 || w <= 0 || h % kMb || w % kMb || search < 0
        || search > kMaxSearch) {
        return (int)cudaErrorInvalidValue;
    }
    const int warps = (search + ((search + 3) & ~3)) / 4 + 1;
    dim3 grid((w / kMb + kTileMbs - 1) / kTileMbs, h / kMb, S);
    me_mc_kernel<<<grid, 32 * warps, 0, static_cast<cudaStream_t>(stream)>>>(
        cur, ref, ref_cb, ref_cr, ranks, offsets, search, h, w, mv, pred_y,
        pred_cb, pred_cr);
    return (int)cudaGetLastError();
}
