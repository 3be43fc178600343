// Baseline-JPEG Huffman scan coder for 4:2:0 stripes: the PyTorch port's
// own copy of selkies_tpu/native/entropy.cpp (its 4:2:0 scan).
//
// The JPEG host rung (selkies_tpu_torch/encoder/jpeg.py, entropy="host")
// fetches each frame's zigzagged, quantized int16 coefficients from the
// device and codes every emitted stripe here. The output equals the
// port's Python coder (encoder/entropy_py.py) and the device packer
// (encoder/device_entropy.py) on the same coefficients.
//
// Built with g++ -O3 -shared -fPIC at first use (native/__init__.py) and
// bound with ctypes, which releases the GIL for the call.

#include <cstdint>
#include <cstring>

namespace {

struct BitWriter {
  uint8_t* out;
  int64_t cap;
  int64_t pos = 0;
  uint64_t acc = 0;
  int nbits = 0;
  bool overflow = false;

  inline void put_byte(uint8_t b) {
    if (pos >= cap) { overflow = true; return; }
    out[pos++] = b;
    if (b == 0xFF) {          // JPEG byte stuffing
      if (pos >= cap) { overflow = true; return; }
      out[pos++] = 0x00;
    }
  }

  inline void write(uint32_t value, int n) {
    if (n == 0) return;
    acc = (acc << n) | (value & ((1u << n) - 1u));
    nbits += n;
    while (nbits >= 8) {
      nbits -= 8;
      put_byte((uint8_t)((acc >> nbits) & 0xFF));
    }
    acc &= (1ull << nbits) - 1ull;
  }

  inline void flush() {
    if (nbits) {
      int pad = 8 - nbits;
      write((1u << pad) - 1u, pad);  // pad with 1-bits (T.81 F.1.2.3)
    }
  }
};

struct HuffLut {
  const uint32_t* code;  // [256]
  const uint8_t* len;    // [256]
};

// Magnitude category: number of bits in |v| (T.81 F.1.2.1).
inline int cat(int v) {
  unsigned a = (unsigned)(v < 0 ? -v : v);
  if (a == 0) return 0;
  return 32 - __builtin_clz(a);
}

// Encode one zigzagged 64-coeff block; returns the block's DC value.
inline int encode_block(BitWriter& bw, const int16_t* zz, int pred_dc,
                        const HuffLut& dc, const HuffLut& ac) {
  int dcv = zz[0];
  int diff = dcv - pred_dc;
  int size = cat(diff);
  bw.write(dc.code[size], dc.len[size]);
  if (size) bw.write((uint32_t)(diff > 0 ? diff : diff + (1 << size) - 1), size);

  int run = 0;
  for (int k = 1; k < 64; ++k) {
    int v = zz[k];
    if (v == 0) { ++run; continue; }
    while (run >= 16) {
      bw.write(ac.code[0xF0], ac.len[0xF0]);  // ZRL
      run -= 16;
    }
    int s = cat(v);
    int sym = (run << 4) | s;
    bw.write(ac.code[sym], ac.len[sym]);
    bw.write((uint32_t)(v > 0 ? v : v + (1 << s) - 1), s);
    run = 0;
  }
  if (run) bw.write(ac.code[0x00], ac.len[0x00]);  // EOB
  return dcv;
}

}  // namespace

extern "C" {

// 4:2:0 interleaved scan: MCU = 4 Y blocks (2x2) + Cb + Cr.
// y:  [by,  bx,  64] int16 (by, bx even), cb/cr: [by/2, bx/2, 64].
// Returns bytes written, or -1 on output overflow.
int64_t jpeg_encode_scan_420(
    const int16_t* y, const int16_t* cb, const int16_t* cr,
    int by, int bx,
    const uint32_t* dc_l_code, const uint8_t* dc_l_len,
    const uint32_t* ac_l_code, const uint8_t* ac_l_len,
    const uint32_t* dc_c_code, const uint8_t* dc_c_len,
    const uint32_t* ac_c_code, const uint8_t* ac_c_len,
    uint8_t* out, int64_t out_capacity) {
  BitWriter bw{out, out_capacity};
  HuffLut dcl{dc_l_code, dc_l_len}, acl{ac_l_code, ac_l_len};
  HuffLut dcc{dc_c_code, dc_c_len}, acc_{ac_c_code, ac_c_len};
  int pred_y = 0, pred_cb = 0, pred_cr = 0;
  int cbx = bx / 2;
  for (int mr = 0; mr < by / 2; ++mr) {
    for (int mc = 0; mc < bx / 2; ++mc) {
      for (int dy2 = 0; dy2 < 2; ++dy2)
        for (int dx2 = 0; dx2 < 2; ++dx2)
          pred_y = encode_block(
              bw, y + (((int64_t)(2 * mr + dy2) * bx + (2 * mc + dx2)) << 6),
              pred_y, dcl, acl);
      pred_cb = encode_block(bw, cb + (((int64_t)mr * cbx + mc) << 6),
                             pred_cb, dcc, acc_);
      pred_cr = encode_block(bw, cr + (((int64_t)mr * cbx + mc) << 6),
                             pred_cr, dcc, acc_);
      if (bw.overflow) return -1;
    }
  }
  bw.flush();
  return bw.overflow ? -1 : bw.pos;
}

}  // extern "C"
