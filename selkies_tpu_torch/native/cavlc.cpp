// H.264 Constrained-Baseline CAVLC slice coder: the PyTorch port's own copy
// of selkies_tpu/native/cavlc.cpp (the host side of the H.264 profile).
//
// Turns the device encoder's quantized level arrays + motion vectors
// (selkies_tpu_torch/encoder/h264_device.py) into Annex-B slice NAL units
// that a stock WebCodecs/ffmpeg decoder accepts. The H.264 encoder runs it
// for IDR pictures and for P stripes whose device-packed CAVLC overflowed
// (selkies_tpu_torch/encoder/h264.py); the device coder
// (encoder/device_cavlc.py) is bit-exact with it.
//
// Supported subset (by construction of the device encoder):
//   * IDR pictures: every MB its own slice, I_16x16 DC prediction,
//     chroma DC prediction (pred == 128 because all neighbors are outside
//     the slice).
//   * P pictures: one slice, P_L0_16x16 with one MV per MB (or P_Skip when
//     the spec-predicted skip MV matches and the MB has no coefficients).
//   * CAVLC per ITU-T H.264 §9.2 (tables 9-5..9-10), deblocking disabled.
//
// Built with g++ -O3 -shared -fPIC at first use (native/__init__.py).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// bit writer (RBSP), EBSP escaping happens at NAL flush

struct BitWriter {
  std::vector<uint8_t> buf;
  uint32_t acc = 0;
  int nbits = 0;

  void put(uint32_t value, int len) {
    // len <= 24 per call
    acc = (acc << len) | (value & ((len >= 32 ? 0 : (1u << len)) - 1));
    nbits += len;
    while (nbits >= 8) {
      nbits -= 8;
      buf.push_back(static_cast<uint8_t>((acc >> nbits) & 0xFF));
    }
  }
  void put_long(uint32_t value, int len) {   // len up to 32
    if (len > 16) {
      put(value >> 16, len - 16);
      put(value & 0xFFFF, 16);
    } else {
      put(value, len);
    }
  }
  void ue(uint32_t v) {
    // Exp-Golomb
    uint32_t vp1 = v + 1;
    int nb = 0;
    for (uint32_t t = vp1; t > 1; t >>= 1) nb++;
    put_long(0, nb);
    put_long(vp1, nb + 1);
  }
  void se(int32_t v) {
    uint32_t m = v <= 0 ? (uint32_t)(-2 * (int64_t)v) : (uint32_t)(2 * (int64_t)v - 1);
    ue(m);
  }
  void rbsp_trailing() {
    put(1, 1);
    if (nbits) put(0, 8 - nbits);
  }
  void reset() { buf.clear(); acc = 0; nbits = 0; }
};

// append NAL: 4-byte start code + header byte + EBSP-escaped RBSP
bool append_nal(std::vector<uint8_t>& out, int nal_ref_idc, int nal_type,
                const std::vector<uint8_t>& rbsp) {
  out.push_back(0); out.push_back(0); out.push_back(0); out.push_back(1);
  out.push_back(static_cast<uint8_t>((nal_ref_idc << 5) | nal_type));
  int zeros = 0;
  for (uint8_t b : rbsp) {
    if (zeros >= 2 && b <= 3) {
      out.push_back(3);
      zeros = 0;
    }
    out.push_back(b);
    zeros = (b == 0) ? zeros + 1 : 0;
  }
  return true;
}

// ---------------------------------------------------------------------------
// CAVLC tables (ITU-T H.264 Table 9-5): coeff_token per nC class.
// Indexed [class][totalCoeff*4 + trailingOnes] → length / bits.

const uint8_t kCoeffTokenLen[3][68] = {
    {// 0 <= nC < 2
     1, 0, 0, 0, 6, 2, 0, 0, 8, 6, 3, 0, 9, 8, 7, 5,
     10, 9, 8, 6, 11, 10, 9, 7, 13, 11, 10, 8, 13, 13, 11, 9,
     13, 13, 13, 10, 14, 14, 13, 11, 14, 14, 14, 13, 15, 15, 14, 14,
     15, 15, 15, 14, 16, 15, 15, 15, 16, 16, 16, 15, 16, 16, 16, 16,
     16, 16, 16, 16},
    {// 2 <= nC < 4
     2, 0, 0, 0, 6, 2, 0, 0, 6, 5, 3, 0, 7, 6, 6, 4,
     8, 6, 6, 4, 8, 7, 7, 5, 9, 8, 8, 6, 11, 9, 9, 6,
     11, 11, 11, 7, 12, 11, 11, 9, 12, 12, 12, 11, 12, 12, 12, 11,
     13, 13, 13, 12, 13, 13, 13, 13, 13, 14, 13, 13, 14, 14, 14, 13,
     14, 14, 14, 14},
    {// 4 <= nC < 8
     4, 0, 0, 0, 6, 4, 0, 0, 6, 5, 4, 0, 6, 5, 5, 4,
     7, 5, 5, 4, 7, 5, 5, 4, 7, 6, 6, 4, 7, 6, 6, 4,
     8, 7, 7, 5, 8, 8, 7, 6, 9, 8, 8, 7, 9, 9, 8, 8,
     9, 9, 9, 8, 10, 9, 9, 9, 10, 10, 10, 10, 10, 10, 10, 10,
     10, 10, 10, 10},
};

const uint8_t kCoeffTokenBits[3][68] = {
    {1, 0, 0, 0, 5, 1, 0, 0, 7, 4, 1, 0, 7, 6, 5, 3,
     7, 6, 5, 3, 7, 6, 5, 4, 15, 6, 5, 4, 11, 14, 5, 4,
     8, 10, 13, 4, 15, 14, 9, 4, 11, 10, 13, 12, 15, 14, 9, 12,
     11, 10, 13, 8, 15, 1, 9, 12, 11, 14, 13, 8, 7, 10, 9, 12,
     4, 6, 5, 8},
    {3, 0, 0, 0, 11, 2, 0, 0, 7, 7, 3, 0, 7, 10, 9, 5,
     7, 6, 5, 4, 4, 6, 5, 6, 7, 6, 5, 8, 15, 6, 5, 4,
     11, 14, 13, 4, 15, 10, 9, 4, 11, 14, 13, 12, 8, 10, 9, 8,
     15, 14, 13, 12, 11, 10, 9, 12, 7, 11, 6, 8, 9, 8, 10, 1,
     7, 6, 5, 4},
    {15, 0, 0, 0, 15, 14, 0, 0, 11, 15, 13, 0, 8, 12, 14, 12,
     15, 10, 11, 11, 11, 8, 9, 10, 9, 14, 13, 9, 8, 10, 9, 8,
     15, 14, 13, 13, 11, 14, 10, 12, 15, 10, 13, 12, 11, 14, 9, 12,
     8, 10, 13, 8, 13, 7, 9, 12, 9, 12, 11, 10, 5, 8, 7, 6,
     1, 4, 3, 2},
};

// chroma DC (nC == -1), 4:2:0 (maxNumCoeff 4)
const uint8_t kCoeffTokenChromaDCLen[20] = {
    2, 0, 0, 0, 6, 1, 0, 0, 6, 6, 3, 0, 6, 7, 7, 6, 6, 8, 8, 7};
const uint8_t kCoeffTokenChromaDCBits[20] = {
    1, 0, 0, 0, 7, 1, 0, 0, 4, 6, 1, 0, 3, 3, 2, 5, 2, 3, 2, 0};

// total_zeros, 4×4 blocks (Tables 9-7/9-8): [totalCoeff][totalZeros]
const uint8_t kTotalZerosLen[16][16] = {
    {0},
    {1, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9, 9},
    {3, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 6, 6, 6, 6},
    {4, 3, 3, 3, 4, 4, 3, 3, 4, 5, 5, 6, 5, 6},
    {5, 3, 4, 4, 3, 3, 3, 4, 3, 4, 5, 5, 5},
    {4, 4, 4, 3, 3, 3, 3, 3, 4, 5, 4, 5},
    {6, 5, 3, 3, 3, 3, 3, 3, 4, 3, 6},
    {6, 5, 3, 3, 3, 2, 3, 4, 3, 6},
    {6, 4, 5, 3, 2, 2, 3, 3, 6},
    {6, 6, 4, 2, 2, 3, 2, 5},
    {5, 5, 3, 2, 2, 2, 4},
    {4, 4, 3, 3, 1, 3},
    {4, 4, 2, 1, 3},
    {3, 3, 1, 2},
    {2, 2, 1},
    {1, 1},
};
const uint8_t kTotalZerosBits[16][16] = {
    {0},
    {1, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 1},
    {7, 6, 5, 4, 3, 5, 4, 3, 2, 3, 2, 3, 2, 1, 0},
    {5, 7, 6, 5, 4, 3, 4, 3, 2, 3, 2, 1, 1, 0},
    {3, 7, 5, 4, 6, 5, 4, 3, 3, 2, 2, 1, 0},
    {5, 4, 3, 7, 6, 5, 4, 3, 2, 1, 1, 0},
    {1, 1, 7, 6, 5, 4, 3, 2, 1, 1, 0},
    {1, 1, 5, 4, 3, 3, 2, 1, 1, 0},
    {1, 1, 1, 3, 3, 2, 2, 1, 0},
    {1, 0, 1, 3, 2, 1, 1, 1},
    {1, 0, 1, 3, 2, 1, 1},
    {0, 1, 1, 2, 1, 3},
    {0, 1, 1, 1, 1},
    {0, 1, 1, 1},
    {0, 1, 1},
    {0, 1},
};

// chroma DC total_zeros (Table 9-9a, 4:2:0): [totalCoeff][totalZeros]
const uint8_t kTotalZerosChromaDCLen[4][4] = {
    {0}, {1, 2, 3, 3}, {1, 2, 2, 0}, {1, 1, 0, 0}};
const uint8_t kTotalZerosChromaDCBits[4][4] = {
    {0}, {1, 1, 1, 0}, {1, 1, 0, 0}, {1, 0, 0, 0}};

// run_before (Table 9-10): [min(zerosLeft,7)][run]
const uint8_t kRunBeforeLen[8][15] = {
    {0},
    {1, 1},
    {1, 2, 2},
    {2, 2, 2, 2},
    {2, 2, 2, 3, 3},
    {2, 2, 3, 3, 3, 3},
    {2, 3, 3, 3, 3, 3, 3},
    {3, 3, 3, 3, 3, 3, 3, 4, 5, 6, 7, 8, 9, 10, 11},
};
const uint8_t kRunBeforeBits[8][15] = {
    {0},
    {1, 0},
    {1, 1, 0},
    {3, 2, 1, 0},
    {3, 2, 1, 1, 0},
    {3, 2, 3, 2, 1, 0},
    {3, 0, 1, 3, 2, 5, 4},
    {7, 6, 5, 4, 3, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1},
};

// coded_block_pattern me(v) mapping for Inter prediction (Table 9-4,
// codeNum → cbp); inverted at first use.
const uint8_t kCbpInterByCodeNum[48] = {
    0,  16, 1,  2,  4,  8,  32, 3,  5,  10, 12, 15, 47, 7,  11, 13,
    14, 6,  9,  31, 35, 37, 42, 44, 33, 34, 36, 40, 39, 43, 45, 46,
    17, 18, 20, 24, 19, 21, 26, 28, 23, 27, 29, 30, 22, 25, 38, 41};

struct CbpInverse {
  int inv[48];
  CbpInverse() {
    for (int i = 0; i < 48; i++) inv[kCbpInterByCodeNum[i]] = i;
  }
};

int cbp_inter_code_num(int cbp) {
  static const CbpInverse table;   // initialized once, thread-safe
  return table.inv[cbp];
}

const int kZigzag4[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};

// ---------------------------------------------------------------------------
// residual_block CAVLC (§9.2)
//
// coeffs: in scan order already (length n_coeff).  nC: luma/chroma-AC
// context value, or -1 for chroma DC.  Returns totalCoeff.

int write_residual_block(BitWriter& bw, const int32_t* coeffs, int n_coeff,
                         int nC) {
  int nz_pos[16];
  int total = 0;
  for (int i = 0; i < n_coeff; i++)
    if (coeffs[i]) nz_pos[total++] = i;

  // coeff_token
  int t1 = 0;
  for (int i = total - 1; i >= 0 && t1 < 3; i--) {
    int32_t v = coeffs[nz_pos[i]];
    if (v == 1 || v == -1) t1++;
    else break;
  }
  if (nC == -1) {
    bw.put(kCoeffTokenChromaDCBits[total * 4 + t1],
           kCoeffTokenChromaDCLen[total * 4 + t1]);
  } else if (nC >= 8) {
    int v = total == 0 ? 3 : ((total - 1) << 2) | t1;
    bw.put(v, 6);
  } else {
    int cls = nC < 2 ? 0 : (nC < 4 ? 1 : 2);
    bw.put(kCoeffTokenBits[cls][total * 4 + t1],
           kCoeffTokenLen[cls][total * 4 + t1]);
  }
  if (total == 0) return 0;

  // trailing-one signs (reverse scan order)
  for (int i = 0; i < t1; i++) {
    int32_t v = coeffs[nz_pos[total - 1 - i]];
    bw.put(v < 0 ? 1 : 0, 1);
  }

  // remaining levels, reverse order
  int suffix_length = (total > 10 && t1 < 3) ? 1 : 0;
  for (int i = total - 1 - t1; i >= 0; i--) {
    int32_t level = coeffs[nz_pos[i]];
    uint32_t mag = level < 0 ? -level : level;
    uint32_t level_code = (mag - 1) * 2 + (level < 0 ? 1 : 0);
    if (i == total - 1 - t1 && t1 < 3) level_code -= 2;

    if (suffix_length == 0) {
      if (level_code < 14) {
        bw.put(1, level_code + 1);                    // prefix zeros + 1
      } else if (level_code < 14 + 16) {
        bw.put(1, 15);                                // prefix 14
        bw.put(level_code - 14, 4);
      } else {
        uint32_t lc = level_code - 30;
        int prefix = 15;
        // spec extension: prefix >= 16 gives (prefix-3)-bit suffix with
        // offset (1<<(prefix-3)) - 4096
        uint32_t limit = 1u << 12;
        while (lc >= limit) {
          lc -= limit;
          prefix++;
          limit = 1u << (prefix - 3);
        }
        bw.put_long(1, prefix + 1);
        bw.put_long(lc, prefix <= 15 ? 12 : prefix - 3);
      }
    } else {
      if (level_code < (15u << suffix_length)) {
        uint32_t prefix = level_code >> suffix_length;
        bw.put_long(1, prefix + 1);
        bw.put(level_code & ((1u << suffix_length) - 1), suffix_length);
      } else {
        uint32_t lc = level_code - (15u << suffix_length);
        int prefix = 15;
        uint32_t limit = 1u << 12;
        while (lc >= limit) {
          lc -= limit;
          prefix++;
          limit = 1u << (prefix - 3);
        }
        bw.put_long(1, prefix + 1);
        bw.put_long(lc, prefix <= 15 ? 12 : prefix - 3);
      }
    }
    if (suffix_length == 0) suffix_length = 1;
    if (mag > (3u << (suffix_length - 1)) && suffix_length < 6)
      suffix_length++;
  }

  // total_zeros
  int max_coeff = (nC == -1) ? 4 : n_coeff;
  int total_zeros = nz_pos[total - 1] + 1 - total;
  if (total < max_coeff) {
    if (nC == -1) {
      bw.put(kTotalZerosChromaDCBits[total][total_zeros],
             kTotalZerosChromaDCLen[total][total_zeros]);
    } else {
      bw.put(kTotalZerosBits[total][total_zeros],
             kTotalZerosLen[total][total_zeros]);
    }
  }

  // run_before, reverse order (not for the last/lowest-frequency coeff)
  int zeros_left = total_zeros;
  for (int i = total - 1; i > 0 && zeros_left > 0; i--) {
    int run = nz_pos[i] - nz_pos[i - 1] - 1;
    int zl = zeros_left < 7 ? zeros_left : 7;
    bw.put(kRunBeforeBits[zl][run], kRunBeforeLen[zl][run]);
    zeros_left -= run;
  }
  return total;
}

// ---------------------------------------------------------------------------
// per-picture encoding state

struct PicCtx {
  int mb_w, mb_h, n_mb;
  const int32_t* mv;         // (n,2) (dy,dx)
  const int32_t* luma;       // (n,16,4,4) raster 4×4 grid within MB
  const int32_t* luma_dc;    // (n,4,4)
  const int32_t* chroma_dc;  // (n,2,2,2)
  const int32_t* chroma_ac;  // (n,2,4,4,4) raster 2×2 grid of 4×4
  // nC context: per-4×4-block totalCoeff, luma grid (mb_h*4 × mb_w*4),
  // chroma grids (mb_h*2 × mb_w*2) per component.  -1 = unavailable.
  std::vector<int8_t> nnz_luma;
  std::vector<int8_t> nnz_cb;
  std::vector<int8_t> nnz_cr;
  // slice id per MB (availability boundary)
  std::vector<int32_t> slice_of;

  void init(int w, int h) {
    mb_w = w; mb_h = h; n_mb = w * h;
    nnz_luma.assign(mb_h * 4 * mb_w * 4, -1);
    nnz_cb.assign(mb_h * 2 * mb_w * 2, -1);
    nnz_cr.assign(mb_h * 2 * mb_w * 2, -1);
    slice_of.assign(n_mb, -1);
  }

  const int32_t* luma_blk(int mb, int r, int c) const {
    return luma + ((mb * 16) + (r * 4 + c)) * 16;
  }
  const int32_t* chroma_blk(int mb, int comp, int r, int c) const {
    return chroma_ac + (((mb * 2 + comp) * 4) + (r * 2 + c)) * 16;
  }

  // nC for a luma 4×4 at global block coords (gr, gc) inside MB `mb`
  int luma_nC(int mb, int gr, int gc) const {
    int na = -1, nb = -1;
    if (gc > 0) {
      int left_mb = (gr / 4) * mb_w + (gc - 1) / 4;
      if (slice_of[left_mb] == slice_of[mb])
        na = nnz_luma[gr * mb_w * 4 + gc - 1];
    }
    if (gr > 0) {
      int top_mb = ((gr - 1) / 4) * mb_w + gc / 4;
      if (slice_of[top_mb] == slice_of[mb])
        nb = nnz_luma[(gr - 1) * mb_w * 4 + gc];
    }
    if (na >= 0 && nb >= 0) return (na + nb + 1) >> 1;
    if (na >= 0) return na;
    if (nb >= 0) return nb;
    return 0;
  }
  int chroma_nC(const std::vector<int8_t>& grid, int mb, int gr,
                int gc) const {
    int na = -1, nb = -1;
    if (gc > 0) {
      int left_mb = (gr / 2) * mb_w + (gc - 1) / 2;
      if (slice_of[left_mb] == slice_of[mb])
        na = grid[gr * mb_w * 2 + gc - 1];
    }
    if (gr > 0) {
      int top_mb = ((gr - 1) / 2) * mb_w + gc / 2;
      if (slice_of[top_mb] == slice_of[mb])
        nb = grid[(gr - 1) * mb_w * 2 + gc];
    }
    if (na >= 0 && nb >= 0) return (na + nb + 1) >> 1;
    if (na >= 0) return na;
    if (nb >= 0) return nb;
    return 0;
  }
};

// spec z-scan emission order of luma 4×4 blocks as (row, col) in the MB
const int kLumaScanRC[16][2] = {
    {0, 0}, {0, 1}, {1, 0}, {1, 1}, {0, 2}, {0, 3}, {1, 2}, {1, 3},
    {2, 0}, {2, 1}, {3, 0}, {3, 1}, {2, 2}, {2, 3}, {3, 2}, {3, 3}};

void scan_block(const int32_t* blk, int32_t* out16) {
  for (int i = 0; i < 16; i++) out16[i] = blk[kZigzag4[i]];
}

struct MbInfo {
  int cbp_luma = 0;    // 4 bits by 8×8
  int cbp_chroma = 0;  // 0/1/2
  bool any_coeff = false;
};

MbInfo analyze_mb(const PicCtx& ctx, int mb, bool intra16) {
  MbInfo info;
  for (int b = 0; b < 16; b++) {
    int r = b / 4, c = b % 4;
    const int32_t* blk = ctx.luma_blk(mb, r, c);
    bool nz = false;
    // for I16 the DC position is carried separately and blk[0] is 0
    for (int i = 0; i < 16; i++)
      if (blk[i]) { nz = true; break; }
    if (nz) info.cbp_luma |= 1 << ((r / 2) * 2 + (c / 2));
  }
  if (intra16) {
    // I_16x16 signals "any AC" as cbp 0 or 15
    info.cbp_luma = info.cbp_luma ? 15 : 0;
  }
  bool dc_nz = false, ac_nz = false;
  for (int comp = 0; comp < 2; comp++) {
    for (int i = 0; i < 4; i++)
      if (ctx.chroma_dc[(mb * 2 + comp) * 4 + i]) dc_nz = true;
    for (int b = 0; b < 4; b++) {
      const int32_t* blk = ctx.chroma_blk(mb, comp, b / 2, b % 2);
      for (int i = 0; i < 16; i++)
        if (blk[i]) { ac_nz = true; break; }
    }
  }
  info.cbp_chroma = ac_nz ? 2 : (dc_nz ? 1 : 0);
  info.any_coeff = info.cbp_luma || info.cbp_chroma;
  return info;
}

// write luma + chroma residuals for one MB and update nC grids
void write_mb_residuals(BitWriter& bw, PicCtx& ctx, int mb, bool intra16,
                        const MbInfo& info) {
  int mby = mb / ctx.mb_w, mbx = mb % ctx.mb_w;
  int32_t scanned[16];

  if (intra16) {
    // Intra16x16DCLevel: 16 coeffs, nC from block (0,0) neighbors
    const int32_t* dc = ctx.luma_dc + mb * 16;
    int32_t dcz[16];
    for (int i = 0; i < 16; i++) dcz[i] = dc[kZigzag4[i]];
    int nC = ctx.luma_nC(mb, mby * 4, mbx * 4);
    write_residual_block(bw, dcz, 16, nC);
  }

  // luma 4×4 blocks in spec scan order
  for (int s = 0; s < 16; s++) {
    int r = kLumaScanRC[s][0], c = kLumaScanRC[s][1];
    int b8 = (r / 2) * 2 + (c / 2);
    int gr = mby * 4 + r, gc = mbx * 4 + c;
    if (!(info.cbp_luma & (1 << b8))) {
      ctx.nnz_luma[gr * ctx.mb_w * 4 + gc] = 0;
      continue;
    }
    const int32_t* blk = ctx.luma_blk(mb, r, c);
    int nC = ctx.luma_nC(mb, gr, gc);
    int total;
    if (intra16) {
      // AC-only: 15 coeffs, scan positions 1..15
      for (int i = 1; i < 16; i++) scanned[i - 1] = blk[kZigzag4[i]];
      total = write_residual_block(bw, scanned, 15, nC);
    } else {
      scan_block(blk, scanned);
      total = write_residual_block(bw, scanned, 16, nC);
    }
    ctx.nnz_luma[gr * ctx.mb_w * 4 + gc] = static_cast<int8_t>(total);
  }

  // chroma DC (both components) then chroma AC
  if (info.cbp_chroma) {
    for (int comp = 0; comp < 2; comp++) {
      const int32_t* dc = ctx.chroma_dc + (mb * 2 + comp) * 4;
      // 2×2 raster order IS the chroma DC scan order
      write_residual_block(bw, dc, 4, -1);
    }
  }
  for (int comp = 0; comp < 2; comp++) {
    std::vector<int8_t>& grid = comp ? ctx.nnz_cr : ctx.nnz_cb;
    for (int b = 0; b < 4; b++) {
      int r = b / 2, c = b % 2;
      int gr = mby * 2 + r, gc = mbx * 2 + c;
      if (info.cbp_chroma != 2) {
        grid[gr * ctx.mb_w * 2 + gc] = 0;
        continue;
      }
      const int32_t* blk = ctx.chroma_blk(mb, comp, r, c);
      for (int i = 1; i < 16; i++) scanned[i - 1] = blk[kZigzag4[i]];
      int nC = ctx.chroma_nC(grid, mb, gr, gc);
      int total = write_residual_block(bw, scanned, 15, nC);
      grid[gr * ctx.mb_w * 2 + gc] = static_cast<int8_t>(total);
    }
  }
}

// median MV prediction for P_16x16 (§8.4.1.3); returns (pred_dy, pred_dx)
void mv_pred(const PicCtx& ctx, const std::vector<uint8_t>& is_coded,
             int mb, int* pred_dy, int* pred_dx, bool* a_avail_out,
             bool* b_avail_out, int* mva_out, int* mvb_out) {
  int mby = mb / ctx.mb_w, mbx = mb % ctx.mb_w;
  // availability within same slice (single slice for P pictures)
  bool a_av = mbx > 0;
  bool b_av = mby > 0;
  bool c_av = mby > 0 && mbx + 1 < ctx.mb_w;
  bool d_av = mby > 0 && mbx > 0;
  const int32_t* mv = ctx.mv;
  int a[2] = {0, 0}, b[2] = {0, 0}, c[2] = {0, 0};
  if (a_av) { a[0] = mv[(mb - 1) * 2]; a[1] = mv[(mb - 1) * 2 + 1]; }
  if (b_av) { b[0] = mv[(mb - ctx.mb_w) * 2]; b[1] = mv[(mb - ctx.mb_w) * 2 + 1]; }
  if (c_av) {
    c[0] = mv[(mb - ctx.mb_w + 1) * 2];
    c[1] = mv[(mb - ctx.mb_w + 1) * 2 + 1];
  } else if (d_av) {
    c[0] = mv[(mb - ctx.mb_w - 1) * 2];
    c[1] = mv[(mb - ctx.mb_w - 1) * 2 + 1];
    c_av = true;
  }
  if (a_avail_out) *a_avail_out = a_av;
  if (b_avail_out) *b_avail_out = b_av;
  if (mva_out) { mva_out[0] = a[0]; mva_out[1] = a[1]; }
  if (mvb_out) { mvb_out[0] = b[0]; mvb_out[1] = b[1]; }
  (void)is_coded;

  // special case: only A "usable" (B, C both unavailable) → pred = A
  if (a_av && !b_av && !c_av) {
    *pred_dy = a[0];
    *pred_dx = a[1];
    return;
  }
  // componentwise median (unavailable → 0, already initialized)
  for (int k = 0; k < 2; k++) {
    int x = a[k], y = b[k], z = c[k];
    int mx = x > y ? (x > z ? (y > z ? y : z) : x)
                   : (y > z ? (x > z ? x : z) : y);
    if (k == 0) *pred_dy = mx; else *pred_dx = mx;
  }
}

// P_Skip predicted MV (§8.4.1.1): zero if A/B unavailable or zero-MV,
// else the median prediction.
void skip_mv(const PicCtx& ctx, int mb, int* dy, int* dx) {
  bool a_av, b_av;
  int mva[2], mvb[2];
  int pdy, pdx;
  mv_pred(ctx, {}, mb, &pdy, &pdx, &a_av, &b_av, mva, mvb);
  if (!a_av || !b_av || (mva[0] == 0 && mva[1] == 0) ||
      (mvb[0] == 0 && mvb[1] == 0)) {
    *dy = 0;
    *dx = 0;
    return;
  }
  *dy = pdy;
  *dx = pdx;
}

// ---------------------------------------------------------------------------
// slice writers

void write_slice_header(BitWriter& bw, bool idr, int first_mb, int qp,
                        int frame_num, int idr_pic_id, int deblock_idc) {
  bw.ue(first_mb);
  bw.ue(idr ? 7 : 5);  // slice_type: I-all / P-all
  bw.ue(0);            // pps id
  bw.put(frame_num & 0xF, 4);
  if (idr) bw.ue(idr_pic_id);
  if (!idr) {
    bw.put(0, 1);  // num_ref_idx_active_override_flag
    bw.put(0, 1);  // ref_pic_list_modification_flag_l0
  }
  // dec_ref_pic_marking (nal_ref_idc != 0)
  if (idr) {
    bw.put(0, 1);  // no_output_of_prior_pics
    bw.put(0, 1);  // long_term_reference
  } else {
    bw.put(0, 1);  // adaptive_ref_pic_marking_mode
  }
  bw.se(qp - 26);  // slice_qp_delta (pic_init_qp = 26)
  bw.ue(deblock_idc);  // disable_deblocking_filter_idc (1 = off)
  if (deblock_idc != 1) {
    bw.se(0);  // slice_alpha_c0_offset_div2
    bw.se(0);  // slice_beta_offset_div2
  }
}

}  // namespace

extern "C" {

// Encode one picture as Annex-B slice NALs.  Returns bytes written, or -1
// on insufficient capacity.
int64_t h264_encode_picture(
    int is_idr, int mb_w, int mb_h, int qp, int frame_num, int idr_pic_id,
    const int32_t* mv, const int32_t* luma, const int32_t* luma_dc,
    const int32_t* chroma_dc, const int32_t* chroma_ac,
    uint8_t* out, int64_t cap, int deblock) {
  PicCtx ctx;
  ctx.init(mb_w, mb_h);
  ctx.mv = mv;
  ctx.luma = luma;
  ctx.luma_dc = luma_dc;
  ctx.chroma_dc = chroma_dc;
  ctx.chroma_ac = chroma_ac;

  std::vector<uint8_t> result;
  result.reserve(1 << 16);
  BitWriter bw;

  if (is_idr) {
    // one slice per MB: prediction neighbors all unavailable → pred 128
    for (int mb = 0; mb < ctx.n_mb; mb++) ctx.slice_of[mb] = mb;
    for (int mb = 0; mb < ctx.n_mb; mb++) {
      bw.reset();
      write_slice_header(bw, true, mb, qp, frame_num, idr_pic_id, 1);
      MbInfo info = analyze_mb(ctx, mb, true);
      // I_16x16: 1 + predMode(2=DC) + 4*cbp_chroma + 12*(cbp_luma==15)
      int mb_type = 1 + 2 + 4 * info.cbp_chroma +
                    (info.cbp_luma == 15 ? 12 : 0);
      bw.ue(mb_type);
      bw.ue(0);  // intra_chroma_pred_mode: DC
      bw.se(0);  // mb_qp_delta
      write_mb_residuals(bw, ctx, mb, true, info);
      bw.rbsp_trailing();
      append_nal(result, 3, 5, bw.buf);
    }
  } else {
    // single P slice
    for (int mb = 0; mb < ctx.n_mb; mb++) ctx.slice_of[mb] = 0;
    bw.reset();
    // deblock=1 → disable_deblocking_filter_idc=0: the decoder runs the
    // in-loop filter over the whole (single-slice) P picture, matching
    // the device-side filter applied to the encoder's reference planes
    // (encoder/deblock.py). IDR slices stay idc=1: per-MB slices would
    // otherwise filter across slice boundaries after decode, and intra
    // pictures are refreshed wholesale anyway.
    write_slice_header(bw, false, 0, qp, frame_num, idr_pic_id,
                       deblock ? 0 : 1);

    // decide skip per MB
    std::vector<MbInfo> infos(ctx.n_mb);
    std::vector<uint8_t> skip(ctx.n_mb, 0);
    for (int mb = 0; mb < ctx.n_mb; mb++) {
      infos[mb] = analyze_mb(ctx, mb, false);
      if (!infos[mb].any_coeff) {
        int sdy, sdx;
        skip_mv(ctx, mb, &sdy, &sdx);
        if (sdy == ctx.mv[mb * 2] && sdx == ctx.mv[mb * 2 + 1]) skip[mb] = 1;
      }
    }

    int run = 0;
    for (int mb = 0; mb < ctx.n_mb; mb++) {
      if (skip[mb]) {
        run++;
        // skipped MB: all nnz contexts go to 0
        int mby = mb / ctx.mb_w, mbx = mb % ctx.mb_w;
        for (int r = 0; r < 4; r++)
          for (int c = 0; c < 4; c++)
            ctx.nnz_luma[(mby * 4 + r) * ctx.mb_w * 4 + mbx * 4 + c] = 0;
        for (int r = 0; r < 2; r++)
          for (int c = 0; c < 2; c++) {
            ctx.nnz_cb[(mby * 2 + r) * ctx.mb_w * 2 + mbx * 2 + c] = 0;
            ctx.nnz_cr[(mby * 2 + r) * ctx.mb_w * 2 + mbx * 2 + c] = 0;
          }
        continue;
      }
      bw.ue(run);
      run = 0;
      const MbInfo& info = infos[mb];
      bw.ue(0);  // mb_type P_L0_16x16
      int pdy, pdx;
      mv_pred(ctx, skip, mb, &pdy, &pdx, nullptr, nullptr, nullptr, nullptr);
      // mvd order: x (horizontal) first.  MVs are integer-pel; the
      // bitstream carries quarter-pel units.
      bw.se(ctx.mv[mb * 2 + 1] * 4 - pdx * 4);
      bw.se(ctx.mv[mb * 2] * 4 - pdy * 4);
      bw.ue(cbp_inter_code_num(info.cbp_luma | (info.cbp_chroma << 4)));
      if (info.any_coeff) bw.se(0);  // mb_qp_delta
      write_mb_residuals(bw, ctx, mb, false, info);
    }
    if (run > 0) bw.ue(run);
    bw.rbsp_trailing();
    append_nal(result, 3, 1, bw.buf);
  }

  if (static_cast<int64_t>(result.size()) > cap) return -1;
  std::memcpy(out, result.data(), result.size());
  return static_cast<int64_t>(result.size());
}

}  // extern "C"
