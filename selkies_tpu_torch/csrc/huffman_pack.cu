// Baseline-JPEG Huffman pack of a frame's stripes (or of N sessions'
// frames stacked on the rows), in two launches, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's packer
// (selkies_tpu/encoder/device_entropy.py:DeviceEntropyPacker.pack) is XLA
// tensor code, and so is the port's plain version
// (selkies_tpu_torch/encoder/device_entropy.py:
// DeviceEntropyPacker.pack_plain). This kernel was added because that
// tensor code, ~110 eager ops a call over int64 slot grids of [blocks, 192],
// set the JPEG lanes' device time (~4.4 ms a 1080p frame) and their memory
// peak (~6.5 GB for a lane of 8 sessions).
//
//   in : yq        [S*yrows, bx, 64]   i16  zigzag coefficients of Y
//        cbq, crq  [S*crows, cbx, 64]  i16  the same of Cb, Cr
//                                           (dct8_quant_zigzag's outputs;
//                                           S stripes, sessions stacked)
//        tables    [536] i32  (len << 16) | code: DC luma 0..11, DC chroma
//                             12..23, AC luma 24..279, AC chroma 280..535
//   out: words     [B, cap_words] u32  each session's stripe scans back to
//                             back, each from a word boundary, bits MSB
//                             first, the last byte padded with 1-bits
//                             (T.81 F.1.2.3); words past a session's last
//                             stripe are 0
//        nbytes    [S] i64    scan bytes of each stripe, padding included
//        base_words[S] i64    each stripe's first word in its session's row
//        overflow  [S] u8     a block over block_bits bits, or the stripe
//                             over 4 * stripe_words bytes: the caller codes
//                             that stripe on the host; its words are 0 here
//   scratch: blk_bits [S*bps] i32 (bits of each block), partial [S*gx] i32
//
// The outputs equal the plain version's wherever no stripe is flagged
// (nbytes, base_words and overflow everywhere; the plain version's words
// inside a flagged stripe's span are whatever its arithmetic left there).
//
// What bounds it on the card: memory. A lane tick of 8 sessions at
// 1920x1088 reads 8 x 6.27 MB of int16 coefficients and writes its word
// buffer once (8 x 1 MB, mostly the zeroed tail): ~59 MB, ~17.5 us at
// 3.35 TB/s. Its arithmetic is a few integer operations a coefficient.
//
// Design. A block's bits depend on its own coefficients and one DC value
// of its predecessor; its place in the stripe on every block before it:
//  * launch 1 (count), a thread per 8x8 block, 256 a CTA, a CTA row per
//    stripe: the thread stages its block's 128 bytes (eight 16-byte loads)
//    in a row of shared memory, notes the nonzero AC positions in a 64-bit
//    mask and adds the lengths of the block's symbols (DC difference, the
//    AC run/size codes with ZRL and EOB, the value bits), looping over the
//    set bits only: a q40 block has a handful. It writes the block's bit
//    count, and the CTA's sum as a partial of its stripe;
//  * launch 2 (emit), a CTA per stripe: a warp-shuffle scan of the counts
//    gives each thread the bit offset of its run of consecutive blocks;
//    the partials give each stripe of the session its word count, so the
//    CTA knows its stripe's first word and flags without waiting on any
//    other CTA. It zeroes its stripe's word span (the session's last
//    stripe also the row's tail), then each thread codes its blocks again
//    into a 64-bit accumulator and stores each full word. Only a thread's
//    first and last words can hold a neighbour's bits: those two are
//    combined with atomicOr, every other word is a plain store. The
//    Huffman tables live in shared memory (a lookup's index differs by
//    lane). No [blocks, slots] grid and no per-stripe word grid exist: the
//    stripe budget only sizes the output row.
// Both launches code a block with the one function code_block, so the
// counts and the emitted bits cannot disagree.

#include <cuda_runtime.h>
#include <stdint.h>

// the C interface's argument type (ctypes mirrors it in
// encoder/device_entropy.py), so it has external linkage
struct PackArgs {
    const int16_t* yq;
    const int16_t* cbq;
    const int16_t* crq;
    const int* tables;
    int* blk_bits;
    int* partial;
    unsigned* words;
    long long* nbytes;
    long long* base_words;
    unsigned char* overflow;
    int n_stripes;      // S, every session's
    int sessions;       // B: the stripes split into B rows of S / B
    int bps;            // blocks per stripe: crows * mcols * 6
    int mcols;          // MCUs across a stripe: pad_w / 16
    int yrows, crows;   // block rows of a stripe: stripe_h / 8, / 16
    int bx, cbx;        // blocks across a plane: pad_w / 8, / 16
    int stripe_words;   // V: a stripe's word budget
    int block_bits;     // 32 * block_words: a block's bit budget
    int cap_words;      // (S / B) * V: words of a session's row
};

namespace {

constexpr int kThreads = 256;
// a staged block is 66 int16 (33 words), so word i of thread t's row sits
// in bank (t + i) mod 32: a warp reading one position hits 32 banks
constexpr int kRow = 66;
constexpr int kTableSize = 536;
constexpr int kAcBase = 24;
constexpr int kMaxSessionStripes = 1024;

// ---- the block coder (both launches) ---------------------------------------

__device__ __forceinline__ int sym_len(int e) { return e >> 16; }
__device__ __forceinline__ unsigned sym_code(int e) { return (unsigned)e & 0xFFFFu; }

// magnitude category (T.81 SSSS) of |v|: its bit length, 0 for 0
__device__ __forceinline__ int category(int v) {
    return 32 - __clz(v < 0 ? -v : v);
}

// value bits (T.81 F.1.2.1): v for v > 0, else v - 1, low `size` bits
__device__ __forceinline__ unsigned value_bits(int v, int size) {
    return (unsigned)(v > 0 ? v : v - 1) & ((1u << size) - 1u);
}

// the first coefficient of block k (stream order within stripe s)
__device__ __forceinline__ const int16_t* block_ptr(const PackArgs& a, int s,
                                                    int k) {
    const int mcu = k / 6, c = k - 6 * mcu;
    const int mr = mcu / a.mcols, mc = mcu - mr * a.mcols;
    if (c < 4) {                // Y: the MCU's 2x2 blocks in raster order
        const int row = s * a.yrows + 2 * mr + (c >> 1);
        return a.yq + ((size_t)row * a.bx + 2 * mc + (c & 1)) * 64;
    }
    return (c == 4 ? a.cbq : a.crq)
        + ((size_t)(s * a.crows + mr) * a.cbx + mc) * 64;
}

// the block whose DC predicts block k's: the previous block of the same
// component in the same stripe (DC prediction restarts at each stripe,
// which is a JPEG of its own), or -1
__device__ __forceinline__ int dc_pred_block(int k) {
    const int c = k % 6;
    if (c >= 1 && c <= 3) return k - 1;
    if (k < 6) return -1;
    return c == 0 ? k - 3 : k - 6;
}

// Copies a block's 64 coefficients into `row` (shared memory) and returns
// the mask of its nonzero AC positions (bit i: zigzag position i).
__device__ __forceinline__ unsigned long long stage(const int16_t* src,
                                                   int16_t* row) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    unsigned* r32 = reinterpret_cast<unsigned*>(row);
    unsigned long long nz = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const uint4 v = __ldg(s4 + i);
        const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            r32[4 * i + j] = w[j];
            const int k = 8 * i + 2 * j;
            nz |= (unsigned long long)((w[j] & 0xFFFFu) != 0u) << k;
            nz |= (unsigned long long)((w[j] >> 16) != 0u) << (k + 1);
        }
    }
    return nz & ~1ull;
}

// Codes one staged block into `out` (anything with put(bits, len)): the
// DC difference's category code and value bits, then per nonzero AC
// coefficient its ZRLs (runs of 16 zeros), run/size code and value bits,
// then EOB unless position 63 is nonzero. The same symbols, in the same
// order, as the plain version's slot grid.
template <class Sink>
__device__ __forceinline__ void code_block(const int16_t* row,
                                           unsigned long long nz, int diff,
                                           int chroma, const int* tab,
                                           Sink& out) {
    const int dsize = category(diff);
    const int de = tab[min(chroma * 12 + dsize, 23)];
    out.put(sym_code(de), sym_len(de));
    out.put(value_bits(diff, dsize), dsize);
    const int* ac = tab + kAcBase + chroma * 256;
    const int zrl = ac[0xF0];
    int last = 0;
    while (nz) {
        const int k = __ffsll((long long)nz) - 1;
        nz &= nz - 1;
        const int z = row[k];
        int run = k - last - 1;
        for (; run >= 16; run -= 16) out.put(sym_code(zrl), sym_len(zrl));
        const int size = category(z);
        const int e = ac[((run << 4) | size) & 255];
        out.put(sym_code(e), sym_len(e));
        out.put(value_bits(z, size), size);
        last = k;
    }
    if (last != 63) out.put(sym_code(ac[0]), sym_len(ac[0]));
}

struct BitCount {
    int n = 0;
    __device__ __forceinline__ void put(unsigned, int len) { n += len; }
};

// Appends bits MSB first from bit `pos` of `row`. A symbol is at most 16
// bits, so the accumulator holds fewer than 32 pending bits before a put
// and at most one word fills per put.
struct BitWriter {
    unsigned* row;
    long long w;                // the word being filled
    unsigned long long acc = 0;
    int n;                      // pending bits in acc (its low n bits)
    bool first = true;

    __device__ BitWriter(unsigned* r, long long pos)
        : row(r), w(pos >> 5), n((int)(pos & 31)) {}

    __device__ __forceinline__ void put(unsigned bits, int len) {
        acc = (acc << len) | bits;
        n += len;
        if (n >= 32) {
            n -= 32;
            const unsigned word = (unsigned)(acc >> n);
            // the first word may hold the previous thread's last bits (the
            // pending zeros it started with leave them as they are)
            if (first) {
                atomicOr(row + w, word);
                first = false;
            } else {
                row[w] = word;
            }
            ++w;
        }
    }

    // the last, partial word, which the next thread may share
    __device__ __forceinline__ void finish() {
        if (n > 0) atomicOr(row + w, (unsigned)(acc << (32 - n)));
    }
};

// ---- the launches ----------------------------------------------------------

__device__ __forceinline__ void load_tables(const PackArgs& a, int* tab) {
    for (int i = threadIdx.x; i < kTableSize; i += kThreads) tab[i] = a.tables[i];
}

__global__ void __launch_bounds__(kThreads)
huffman_pack_count(const __grid_constant__ PackArgs a) {
    __shared__ int tab[kTableSize];
    __shared__ __align__(16) int16_t rows[kThreads * kRow];
    __shared__ int warp_sum[kThreads / 32];

    load_tables(a, tab);
    __syncthreads();
    const int s = blockIdx.y;
    const int k = blockIdx.x * kThreads + threadIdx.x;
    int bits = 0;
    if (k < a.bps) {
        int16_t* row = rows + threadIdx.x * kRow;
        const unsigned long long nz = stage(block_ptr(a, s, k), row);
        const int p = dc_pred_block(k);
        const int pred = p < 0 ? 0 : block_ptr(a, s, p)[0];
        BitCount c;
        code_block(row, nz, row[0] - pred, k % 6 >= 4, tab, c);
        bits = c.n;
        a.blk_bits[(size_t)s * a.bps + k] = bits;
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) bits += __shfl_down_sync(0xffffffffu, bits, o);
    if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = bits;
    __syncthreads();
    if (threadIdx.x == 0) {
        int t = 0;
#pragma unroll
        for (int i = 0; i < kThreads / 32; ++i) t += warp_sum[i];
        a.partial[(size_t)s * gridDim.x + blockIdx.x] = t;
    }
}

__global__ void __launch_bounds__(kThreads)
huffman_pack_emit(const __grid_constant__ PackArgs a) {
    __shared__ int tab[kTableSize];
    __shared__ __align__(16) int16_t rows[kThreads * kRow];
    __shared__ int words_of[kMaxSessionStripes];
    __shared__ int warp_tot[kThreads / 32];

    const int tid = threadIdx.x;
    const int s = blockIdx.x;
    const int fs = a.n_stripes / a.sessions;
    const int b = s / fs, j = s - b * fs;
    const int gx = (a.bps + kThreads - 1) / kThreads;
    load_tables(a, tab);
    // the words each stripe of the session takes (min(ceil(bytes / 4), V))
    for (int i = tid; i < fs; i += kThreads) {
        const int* p = a.partial + (size_t)(b * fs + i) * gx;
        long long bits = 0;
        for (int x = 0; x < gx; ++x) bits += p[x];
        const long long w = (((bits + 7) >> 3) + 3) >> 2;
        words_of[i] = (int)(w < a.stripe_words ? w : a.stripe_words);
    }
    // this thread's run of consecutive blocks and its bit offset
    const int per = (a.bps + kThreads - 1) / kThreads;
    const int lo = min(tid * per, a.bps), hi = min(lo + per, a.bps);
    const int* bb = a.blk_bits + (size_t)s * a.bps;
    int sum = 0;
    bool big = false;
    for (int k = lo; k < hi; ++k) {
        const int v = bb[k];
        sum += v;
        big |= v > a.block_bits;
    }
    const int lane = tid & 31, warp = tid >> 5;
    int inc = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += v;
    }
    if (lane == 31) warp_tot[warp] = inc;
    const bool any_big = __syncthreads_or(big);
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
        before += w < warp ? warp_tot[w] : 0;
        total += warp_tot[w];
    }
    const long long off = before + inc - sum;
    long long base = 0;
    for (int i = 0; i < j; ++i) base += words_of[i];
    const int pad = (-total) & 7;
    const long long nbytes = ((long long)total + pad) >> 3;
    const bool ovf = any_big || nbytes > 4LL * a.stripe_words;
    if (tid == 0) {
        a.nbytes[s] = nbytes;
        a.base_words[s] = base;
        a.overflow[s] = ovf ? 1 : 0;
    }
    unsigned* row_words = a.words + (size_t)b * a.cap_words;
    const long long end = j == fs - 1 ? (long long)a.cap_words
                                      : base + words_of[j];
    for (long long w = base + tid; w < end; w += kThreads) row_words[w] = 0u;
    __syncthreads();
    if (ovf || lo >= hi) return;

    BitWriter out(row_words, base * 32 + off);
    int16_t* row = rows + tid * kRow;
    for (int k = lo; k < hi; ++k) {
        const unsigned long long nz = stage(block_ptr(a, s, k), row);
        const int p = dc_pred_block(k);
        const int pred = p < 0 ? 0 : block_ptr(a, s, p)[0];
        code_block(row, nz, row[0] - pred, k % 6 >= 4, tab, out);
    }
    if (hi == a.bps) out.put(0xFFu >> (8 - pad), pad);
    out.finish();
}

}  // namespace

// C interface (bound with ctypes by selkies_tpu_torch/encoder/
// device_entropy.py). Launches count then emit on `stream` and returns
// cudaGetLastError() after each launch (the first error stops it).
extern "C" int huffman_pack_launch(const PackArgs* args, void* stream) {
    const PackArgs& a = *args;
    if (a.n_stripes <= 0 || a.sessions <= 0 || a.n_stripes % a.sessions
        || a.n_stripes / a.sessions > kMaxSessionStripes
        || a.n_stripes > 65535 || a.mcols <= 0 || a.crows <= 0
        || a.yrows != 2 * a.crows || a.bx != 2 * a.mcols
        || a.cbx != a.mcols || a.bps != a.crows * a.mcols * 6
        || a.stripe_words <= 0 || a.block_bits <= 0
        || (long long)a.cap_words
            != (long long)(a.n_stripes / a.sessions) * a.stripe_words) {
        return (int)cudaErrorInvalidValue;
    }
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int gx = (a.bps + kThreads - 1) / kThreads;
    huffman_pack_count<<<dim3(gx, a.n_stripes), kThreads, 0, st>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    huffman_pack_emit<<<a.n_stripes, kThreads, 0, st>>>(a);
    return (int)cudaGetLastError();
}
