"""Device-side baseline-JPEG Huffman packing: the Hopper kernel and its
plain PyTorch version.

Counterpart of ``selkies_tpu/encoder/device_entropy.py``, whose packer is
XLA tensor code, not Pallas: no TPU kernel stands behind it. On the card
:meth:`DeviceEntropyPacker.pack` launches ``csrc/huffman_pack.cu`` (CUDA
C++ for sm_90a, built by nvcc at first use and bound with ctypes; its
source says what bounds it and how its design follows): two launches a
call, counted in ``huffman_pack.launches`` and by device in
``huffman_pack.launches_by_device``. CPU tensors take the plain version,
:meth:`DeviceEntropyPacker.pack_plain`; a CUDA tensor launches the kernel
or raises, with no fallback from one to the other.

The plain version is PyTorch tensor code in PyTorch's idiom — integer
gathers, ``cumsum``, ``cummax``, ``scatter_add``/``scatter_reduce`` —
where the TPU version had to avoid gathers with one-hot matmuls, and it
computes the magnitude category with integer ops (``bucketize`` against
powers of two) instead of ``floor(log2(.))``, which the card does not
promise to round exactly.

The plain version's output is bit-exact with the JAX packer — the same
``(words, nbytes, base, overflow)``, overflowed stripes' words included —
because it keeps the same data-parallel formulation:

  1. symbols live in a [M, 192] per-block slot grid (DC code, DC bits, and
     per-AC-coefficient {ZRL-pair, ZRL+code, value-bits} triples);
  2. slots pack into ≤ W per-block words (sums into the word each slot
     starts in and the next; bits never overlap inside a block that fits,
     and a block that does not fit flags its stripe);
  3. block base offsets are a per-stripe cumsum over block bit totals, and
     each output word is a difference of two running sums whose bounds
     come from a scatter-max + cummax over the block start words;
  4. stripes are padded with 1-bits to byte alignment (T.81 F.1.2.3) and
     compacted back-to-back at word granularity, so the host fetches one
     dense buffer.

All uint32 arithmetic of the reference runs here in int64 and is masked to
32 bits where the reference would wrap; the packed words are returned as
int32 holding the same bit patterns (view them as uint32 on the host).
The kernel's output equals the plain version's except inside the word
span of a flagged stripe (its words are 0 there).

Overflow containment: a block whose bitstream exceeds ``32*block_words``
bits, or a stripe exceeding ``max_stripe_bytes``, flags its stripe; flagged
stripes are host-coded by the caller (encoder/jpeg.py
``_scans_from_packed``) with :mod:`.entropy_py`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from .jpeg_tables import std_tables

_M32 = 0xFFFFFFFF


# --------------------------------------------------------------------------
# Static geometry (numpy; identical to the JAX package's)


@functools.lru_cache(maxsize=32)
def scan_geometry(pad_h: int, pad_w: int, stripe_h: int):
    """Static scan-order arrays for a 4:2:0 frame geometry.

    Returns (perm, is_chroma, dc_prev_idx, blocks_per_stripe):
      perm[M]        — index into concat(Y, Cb, Cr) flattened block arrays,
                       in MCU-interleaved stripe-major order;
      is_chroma[M]   — Huffman table selector per block;
      dc_prev_idx[M] — stream index of the DC predecessor (same component,
                       same stripe) or -1 at each stripe/component start.
    """
    by, bx = pad_h // 8, pad_w // 8
    cby, cbx = pad_h // 16, pad_w // 16
    s_cnt = pad_h // stripe_h
    yrows, crows = stripe_h // 8, stripe_h // 16
    mcols = pad_w // 16

    perm = []
    is_chroma = []
    dc_prev = []
    last = {}
    y_base, cb_base, cr_base = 0, by * bx, by * bx + cby * cbx
    for s in range(s_cnt):
        last.clear()  # DC prediction resets per stripe (independent JPEGs)
        for mr in range(crows):
            for mc in range(mcols):
                for dy in (0, 1):
                    for dx in (0, 1):
                        perm.append(
                            y_base + (s * yrows + 2 * mr + dy) * bx + (2 * mc + dx))
                        is_chroma.append(0)
                        i = len(perm) - 1
                        dc_prev.append(last.get("y", -1))
                        last["y"] = i
                for base, key in ((cb_base, "cb"), (cr_base, "cr")):
                    perm.append(base + (s * crows + mr) * cbx + mc)
                    is_chroma.append(1)
                    i = len(perm) - 1
                    dc_prev.append(last.get(key, -1))
                    last[key] = i
    blocks_per_stripe = crows * mcols * 6
    return (
        np.asarray(perm, np.int32),
        np.asarray(is_chroma, np.int32),
        np.asarray(dc_prev, np.int32),
        blocks_per_stripe,
    )


_POW2 = np.array([1 << k for k in range(16)], np.int64)


def bitlen(a: torch.Tensor, pow2: "torch.Tensor | None" = None) -> torch.Tensor:
    """Magnitude category of |a| (T.81 SSSS): bit length of |a|, 0 for 0.

    Integer-exact: the count of powers of two ≤ |a| (``bucketize``), never
    a floating-point log. ``pow2`` is the boundary tensor already on
    ``a``'s device (the packer keeps one, so no per-frame upload)."""
    if pow2 is None:
        pow2 = torch.from_numpy(_POW2).to(a.device)
    return torch.bucketize(a.abs(), pow2.to(a.dtype), right=True).to(torch.int64)


def _vbits(v: torch.Tensor, size: torch.Tensor) -> torch.Tensor:
    """Value bits: v for v>0 else ones'-complement (T.81 F.1.2.1)."""
    raw = torch.where(v > 0, v, v + (1 << size) - 1)
    return raw & ((1 << size) - 1)


def _shl32(x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """uint32 ``x << n`` (bits past 32 dropped), n in [0, 31]."""
    return (x << n) & _M32


def _gather_fill(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``take_along_axis`` on dim 1 with the reference's out-of-range
    semantics: an index in [-n, 0) counts from the end, any other index
    outside [0, n) yields the uint32 fill 0xFFFFFFFF. Only a stripe that
    overflowed its word budget reaches such indices; its words are then
    still bit-exact with the reference's."""
    n = arr.shape[1]
    idx = torch.where(idx < 0, idx + n, idx)
    ok = (idx >= 0) & (idx < n)
    got = torch.gather(arr, 1, idx.clamp(0, n - 1))
    return torch.where(ok, got, torch.full_like(got, _M32))


def _packed_tables() -> Tuple[np.ndarray, ...]:
    """Code/length lookup tables of the standard Huffman tables."""
    dc_l, ac_l, dc_c, ac_c = std_tables()
    dc_code = np.concatenate([dc_l.code_arr[:12], dc_c.code_arr[:12]]).astype(np.int64)
    dc_len = np.concatenate([dc_l.len_arr[:12], dc_c.len_arr[:12]]).astype(np.int64)
    ac_code = np.concatenate([ac_l.code_arr, ac_c.code_arr]).astype(np.int64)
    ac_len = np.concatenate([ac_l.len_arr, ac_c.len_arr]).astype(np.int64)
    return dc_code, dc_len, ac_code, ac_len


def _kernel_tables() -> np.ndarray:
    """The kernel's table: ``(len << 16) | code`` of DC luma (0..11), DC
    chroma (12..23), AC luma (24..279) and AC chroma (280..535) symbols."""
    dc_code, dc_len, ac_code, ac_len = _packed_tables()
    return np.concatenate([(dc_len << 16) | dc_code,
                           (ac_len << 16) | ac_code]).astype(np.int32)


class DeviceEntropyPacker:
    """Per-geometry entropy pack on a device: coefficients → packed scans.

    ``pack(yq, cbq, crq)`` returns:
      words  [cap_words] int32 — all stripes' scans compacted back-to-back
             (each stripe starts word-aligned; bits are MSB-first, so bytes
             come from big-endian u32 serialization of the bit patterns);
      nbytes [S] int64         — scan byte count per stripe (incl. padding);
      base_words [S] int64     — word offset of each stripe in ``words``;
      overflow [S] bool        — stripe unusable (host-code it instead).

    ``sessions=N`` packs N sessions' frames stacked on the rows (``pad_h``
    is then N times one frame's): every stripe is coded on its own (DC
    prediction resets per stripe), and each session's stripes compact on
    their own, so ``words`` is ``[N, cap_words]`` with ``cap_words`` one
    session's, and ``base_words`` counts from the start of its session's
    row — row n is the buffer session n alone would give.
    """

    #: slot grid per block: 2 DC slots + 63 × (ZRL-pair, ZRL+code, value) + pad
    SLOTS = 192

    def __init__(
        self,
        pad_h: int,
        pad_w: int,
        stripe_h: int,
        max_stripe_bytes: int = 1 << 15,
        block_words: int = 56,
        device=None,
        sessions: int = 1,
    ) -> None:
        from .._device import resolve_device

        dev = resolve_device(device)
        self.device = dev
        perm, is_chroma, dc_prev, bps = scan_geometry(pad_h, pad_w, stripe_h)
        self.pad_w, self.stripe_h = pad_w, stripe_h
        self.n_stripes = pad_h // stripe_h
        self.sessions = int(sessions)
        if self.n_stripes % self.sessions:
            raise ValueError(f"{self.n_stripes} stripes do not split into "
                             f"{self.sessions} sessions")
        self.blocks_per_stripe = bps
        self.max_stripe_words = max_stripe_bytes // 4
        self.block_words = block_words
        self.cap_words = (self.n_stripes // self.sessions) \
            * self.max_stripe_words

        _, ac_l, _, ac_c = std_tables()
        self._zrl = (int(ac_l.code_arr[0xF0]), int(ac_c.code_arr[0xF0]),
                     int(ac_l.len_arr[0xF0]), int(ac_c.len_arr[0xF0]))
        self._eob = (int(ac_l.code_arr[0x00]), int(ac_c.code_arr[0x00]),
                     int(ac_l.len_arr[0x00]), int(ac_c.len_arr[0x00]))
        self._perm = torch.from_numpy(perm.astype(np.int64)).to(dev)
        self._chroma = torch.from_numpy(is_chroma.astype(np.int64)).to(dev)
        self._prev = torch.from_numpy(dc_prev.astype(np.int64)).to(dev)
        self._tables = tuple(torch.from_numpy(t).to(dev)
                             for t in _packed_tables())
        self._pow2 = torch.from_numpy(_POW2).to(dev)
        #: the kernel's (len << 16) | code table (csrc/huffman_pack.cu)
        self._kernel_tables = torch.from_numpy(_kernel_tables()).to(dev)

    def pack(self, yq: torch.Tensor, cbq: torch.Tensor, crq: torch.Tensor):
        """The packed scans of zigzag planes ``yq`` [S*stripe_h/8,
        pad_w/8, 64], ``cbq``/``crq`` [S*stripe_h/16, pad_w/16, 64]:
        :func:`huffman_pack` (the kernel on the card, the plain version on
        the CPU)."""
        return huffman_pack(self, yq, cbq, crq)

    def pack_plain(self, yq: torch.Tensor, cbq: torch.Tensor,
                   crq: torch.Tensor):
        """The plain version of :meth:`pack`, on any device: the JAX
        packer's formulation, bit-exact with it."""
        S = self.n_stripes
        V = self.max_stripe_words
        W = self.block_words
        bps = self.blocks_per_stripe
        dev = yq.device
        chroma = self._chroma                               # [M]
        M = chroma.shape[0]
        dc_code_t, dc_len_t, ac_code_t, ac_len_t = self._tables
        zc_l, zc_c, zl_l, zl_c = self._zrl
        ec_l, ec_c, el_l, el_c = self._eob

        allb = torch.cat([yq.reshape(-1, 64), cbq.reshape(-1, 64),
                          crq.reshape(-1, 64)]).to(torch.int64)
        stream = allb.index_select(0, self._perm)           # [M, 64]

        # ---- DC symbols (per block) ---------------------------------------
        dc = stream[:, 0]
        pred = torch.where(self._prev < 0, torch.zeros_like(dc),
                           dc[self._prev.clamp(min=0)])
        diff = dc - pred
        dsize = bitlen(diff, self._pow2)                                # ≤ 11
        dci = chroma * 12 + dsize
        dcode = dc_code_t[dci]
        dlen = dc_len_t[dci]
        dc_b = torch.stack([dcode, _vbits(diff, dsize)], dim=1)    # [M, 2]
        dc_l_ = torch.stack([dlen, dsize], dim=1)

        # ---- AC symbols [M, 63] -------------------------------------------
        z = stream[:, 1:]
        nzm = z != 0
        posk = torch.arange(1, 64, dtype=torch.int64, device=dev)[None, :]
        p = torch.where(nzm, posk, torch.zeros_like(z))
        m_incl = torch.cummax(p, dim=1).values
        prev_excl = torch.cat(
            [torch.zeros((M, 1), dtype=torch.int64, device=dev),
             m_incl[:, :-1]], dim=1)
        run = posk - prev_excl - 1
        size = bitlen(z, self._pow2)                                    # ≤ 10
        rem = run & 15
        nzrl = run >> 4                                     # 0..3

        idx = chroma[:, None] * 256 + ((rem << 4) | size)
        acode = ac_code_t[idx]
        alen = ac_len_t[idx]

        is_c = (chroma == 1)[:, None]
        zc = torch.where(is_c, zc_c, zc_l)                  # [M, 1]
        zl = torch.where(is_c, zl_c, zl_l)
        zero = torch.zeros_like(z)

        # slot 0: first two ZRLs; slot 1: third ZRL ∥ code; slot 2: value
        s0b = torch.where(nzrl >= 2, _shl32(zc, zl) | zc,
                          torch.where(nzrl >= 1, zc.expand_as(z), zero))
        s0l = torch.where(nzm, torch.clamp(nzrl, max=2) * zl, zero)
        s1b = torch.where(nzrl >= 3, _shl32(zc, alen) | acode, acode)
        s1l = torch.where(nzm, alen + torch.where(nzrl >= 3, zl, zero), zero)
        s2b = _vbits(z, size)
        s2l = torch.where(nzm, size, zero)

        # EOB folds into coefficient 63's (ZRL∥code) slot when the block
        # doesn't end in a nonzero coefficient.
        eob_on = m_incl[:, -1] != 63
        ec = torch.where(chroma == 1, ec_c, ec_l)
        el = torch.where(chroma == 1, el_c, el_l)
        zm = torch.zeros_like(ec)
        s1b[:, 62] = torch.where(nzm[:, 62], s1b[:, 62],
                                 torch.where(eob_on, ec, zm))
        s1l[:, 62] = torch.where(nzm[:, 62], s1l[:, 62],
                                 torch.where(eob_on, el, zm))

        # ---- [M, 192] slot grid (emission order; last slot is padding) ----
        ac_b = torch.stack([s0b, s1b, s2b], dim=2).reshape(M, 189)
        ac_l2 = torch.stack([s0l, s1l, s2l], dim=2).reshape(M, 189)
        pad1 = torch.zeros((M, 1), dtype=torch.int64, device=dev)
        bits = torch.cat([dc_b, ac_b, pad1], dim=1)
        lens = torch.cat([dc_l_, ac_l2, pad1], dim=1)

        # ---- intra-block pack into ≤W words --------------------------------
        cum = torch.cumsum(lens, dim=1)
        off = cum - lens                                    # [M, SLOTS]
        Lb = cum[:, -1]                                     # [M] ≥ 6
        blk_ovf = Lb > 32 * W

        j0 = torch.clamp(off >> 5, max=W - 1)
        pos = off & 31
        sh = 32 - pos - lens
        safe = torch.where(lens > 0, bits, torch.zeros_like(bits))
        c0 = torch.where(sh >= 0, _shl32(safe, sh.clamp(0, 31)),
                         safe >> (-sh).clamp(0, 31))
        c1 = torch.where(sh < 0, _shl32(safe, (32 + sh).clamp(0, 31)),
                         torch.zeros_like(safe))
        j1 = torch.clamp(j0 + 1, max=W - 1)
        rowb = torch.arange(M, dtype=torch.int64, device=dev)[:, None] * W
        words_blk = torch.zeros(M * W, dtype=torch.int64, device=dev)
        words_blk.scatter_add_(0, (rowb + j0).reshape(-1), c0.reshape(-1))
        words_blk.scatter_add_(0, (rowb + j1).reshape(-1), c1.reshape(-1))
        words_blk = words_blk & _M32                        # [M*W] u32

        # ---- block bases within stripe --------------------------------------
        Lb2 = Lb.reshape(S, bps)
        cumb = torch.cumsum(Lb2, dim=1)
        base = cumb - Lb2                                   # [S, bps] bits
        t_bits = cumb[:, -1]
        pad = (-t_bits) % 8
        t_bytes = (t_bits + pad) // 8

        g0 = base >> 5                                      # [S, bps]
        r = base & 31
        e = (base + Lb2 - 1) >> 5                           # last word touched

        # ---- globalize block words (analytic indices) -----------------------
        v = words_blk.reshape(S, bps, W)
        r3 = r[..., None]
        u0 = v >> r3
        u1 = torch.where(r3 == 0, torch.zeros_like(v),
                         _shl32(v, (32 - r3).clamp(0, 31)))
        cs0 = torch.cumsum(u0.reshape(S, bps * W), dim=1) & _M32
        cs1 = torch.cumsum(u1.reshape(S, bps * W), dim=1) & _M32

        # boundary block per output word: last block with g0 ≤ w
        g0c = g0.clamp(0, V - 1)
        bidx = torch.arange(bps, dtype=torch.int64, device=dev)
        lastblk = torch.zeros((S, V), dtype=torch.int64, device=dev)
        lastblk.scatter_reduce_(1, g0c, bidx.expand(S, bps), reduce="amax",
                                include_self=True)
        lastblk = torch.cummax(lastblk, dim=1).values

        g0k = g0.clamp(0, (1 << 15) - 1)
        e1k = (e + 1).clamp(0, (1 << 15) - 1)
        w_ar = torch.arange(V, dtype=torch.int64, device=dev)[None, :]

        g0b = torch.gather(g0k, 1, lastblk)                 # [S, V]
        e1b = torch.gather(e1k, 1, lastblk)                 # e + 1
        jstar = torch.where(e1b <= w_ar, W - 1,
                            torch.clamp(w_ar - g0b, max=W - 1))
        s_at0 = _gather_fill(cs0, lastblk * W + jstar)
        word0 = (s_at0 - torch.nn.functional.pad(s_at0[:, :-1], (1, 0))) & _M32

        # stream-1 boundary: last block with g0 ≤ w-1 (shift by one word)
        lastblk1 = torch.nn.functional.pad(lastblk[:, :-1], (1, 0))
        g0b1 = torch.gather(g0k, 1, lastblk1)
        e1b1 = torch.gather(e1k, 1, lastblk1)
        jstar1 = torch.where(e1b1 + 1 <= w_ar, W - 1,
                             torch.clamp(w_ar - 1 - g0b1, 0, W - 1))
        s_at1 = _gather_fill(cs1, lastblk1 * W + jstar1)
        s_at1 = torch.where(w_ar == 0, torch.zeros_like(s_at1), s_at1)
        word1 = (s_at1 - torch.nn.functional.pad(s_at1[:, :-1], (1, 0))) & _M32

        words_stripe = (word0 + word1) & _M32               # [S, V]

        # ---- stripe byte-alignment padding (1-bits) -------------------------
        mask = (1 << pad) - 1
        ppos = t_bits & 31
        psh = 32 - ppos - pad
        pw = (t_bits >> 5).clamp(0, V - 1)
        pc0 = torch.where(psh >= 0, _shl32(mask, psh.clamp(0, 31)),
                          mask >> (-psh).clamp(0, 31))
        pc1 = torch.where(psh < 0, _shl32(mask, (32 + psh).clamp(0, 31)),
                          torch.zeros_like(mask))
        srow = torch.arange(S, dtype=torch.int64, device=dev) * V
        flat = words_stripe.reshape(-1).clone()
        flat.scatter_add_(0, srow + pw, pc0)
        flat.scatter_add_(0, srow + (pw + 1).clamp(0, V - 1), pc1)
        flat = flat & _M32

        # ---- compaction (each session's stripes back-to-back, word
        # aligned) ------------------------------------------------------------
        B = self.sessions
        fs = S // B
        wc = torch.clamp((t_bytes + 3) // 4, max=V).reshape(B, fs)
        base_words = torch.cumsum(wc, dim=1) - wc
        j = torch.arange(self.cap_words, dtype=torch.int64,
                         device=dev).repeat(B, 1)
        sidx = (torch.searchsorted(base_words, j, right=True) - 1) \
            .clamp(0, fs - 1)
        src = sidx * V + (j - base_words.gather(1, sidx)).clamp(0, V - 1)
        valid = j < (base_words[:, -1] + wc[:, -1])[:, None]
        compacted = torch.where(valid, flat.reshape(B, fs * V).gather(1, src),
                                torch.zeros_like(src))
        # uint32 bit patterns → int32
        compacted = torch.where(compacted >= (1 << 31),
                                compacted - (1 << 32), compacted).to(torch.int32)

        stripe_overflow = (t_bytes > V * 4) | blk_ovf.reshape(S, bps).any(dim=1)
        base_words = base_words.reshape(-1)
        if B == 1:
            compacted = compacted[0]
        return compacted, t_bytes, base_words, stripe_overflow

    def bucket_words(self, total_words: int) -> int:
        """Power-of-two fetch size for a packed-word count (bounds how far a
        prefix read can reach; same ladder as the JAX package)."""
        n = 1024
        while n < total_words:
            n <<= 1
        return min(n, self.cap_words)


class _PackArgs(ctypes.Structure):
    """``struct PackArgs`` of csrc/huffman_pack.cu."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "yq", "cbq", "crq", "tables", "blk_bits", "partial", "words",
        "nbytes", "base_words", "overflow")] + [
        (name, ctypes.c_int) for name in (
            "n_stripes", "sessions", "bps", "mcols", "yrows", "crows", "bx",
            "cbx", "stripe_words", "block_bits", "cap_words")]


#: threads of a CTA of the kernel's count launch (kThreads)
_COUNT_THREADS = 256


@functools.lru_cache(maxsize=None)
def _library():
    from .._build import load_library

    fn = load_library("huffman_pack").huffman_pack_launch
    fn.argtypes = [ctypes.POINTER(_PackArgs), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_planes(p: DeviceEntropyPacker, yq, cbq, crq) -> None:
    """The kernel takes the planes as ``dct8_quant_zigzag`` leaves them:
    int16, contiguous, 16-byte aligned, on one device, of the packer's
    geometry."""
    S, bx, cbx = p.n_stripes, p.pad_w // 8, p.pad_w // 16
    want = {"yq": (S * p.stripe_h // 8, bx, 64),
            "cbq": (S * p.stripe_h // 16, cbx, 64),
            "crq": (S * p.stripe_h // 16, cbx, 64)}
    for name, t in (("yq", yq), ("cbq", cbq), ("crq", crq)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be {list(want[name])}, got "
                             f"{list(t.shape)}")
        if t.dtype != torch.int16:
            raise TypeError(f"{name} must be int16, got {t.dtype}")
        if t.device != yq.device:
            raise ValueError(f"{name} is on {t.device}, yq on {yq.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _pack_args(p: DeviceEntropyPacker, yq, cbq, crq, out) -> _PackArgs:
    """The kernel's arguments for one call (``out``: the outputs and
    scratch tensors, as :func:`huffman_pack` allocates them)."""
    words, nbytes, base, ovf, blk_bits, partial = out
    a = _PackArgs()
    (a.yq, a.cbq, a.crq, a.tables, a.blk_bits, a.partial, a.words, a.nbytes,
     a.base_words, a.overflow) = (t.data_ptr() for t in (
         yq, cbq, crq, p._kernel_tables, blk_bits, partial, words, nbytes,
         base, ovf))
    a.n_stripes, a.sessions = p.n_stripes, p.sessions
    a.bps, a.mcols = p.blocks_per_stripe, p.pad_w // 16
    a.yrows, a.crows = p.stripe_h // 8, p.stripe_h // 16
    a.bx, a.cbx = p.pad_w // 8, p.pad_w // 16
    a.stripe_words, a.block_bits = p.max_stripe_words, 32 * p.block_words
    a.cap_words = p.cap_words
    return a


def _pack_outputs(p: DeviceEntropyPacker, dev):
    """Outputs and scratch of one call: words [B, cap_words] i32, nbytes
    and base_words [S] i64, overflow [S] bool; block bit counts [S*bps] and
    the count launch's partial sums [S*gx] i32. The kernel writes every
    element, so none is zeroed here."""
    S, bps = p.n_stripes, p.blocks_per_stripe
    gx = -(-bps // _COUNT_THREADS)
    return (torch.empty((p.sessions, p.cap_words), dtype=torch.int32,
                        device=dev),
            torch.empty(S, dtype=torch.int64, device=dev),
            torch.empty(S, dtype=torch.int64, device=dev),
            torch.empty(S, dtype=torch.bool, device=dev),
            torch.empty(S * bps, dtype=torch.int32, device=dev),
            torch.empty(S * gx, dtype=torch.int32, device=dev))


def huffman_pack(packer: DeviceEntropyPacker, yq: torch.Tensor,
                 cbq: torch.Tensor, crq: torch.Tensor):
    """``packer``'s ``(words, nbytes, base_words, overflow)`` of the zigzag
    planes. CPU tensors go through :meth:`DeviceEntropyPacker.pack_plain`;
    CUDA tensors launch ``csrc/huffman_pack.cu`` twice (count, emit) on the
    planes' device's current stream, or raise. The outputs equal the plain
    version's, except that a flagged stripe's words are 0."""
    dev = yq.device
    if dev.type == "cpu":
        return packer.pack_plain(yq, cbq, crq)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _check_planes(packer, yq, cbq, crq)
    if packer._kernel_tables.device != dev:
        raise ValueError(f"the packer's tables are on "
                         f"{packer._kernel_tables.device}, the planes on {dev}")
    major, minor = torch.cuda.get_device_capability(dev)
    if (major, minor) != (9, 0):
        raise RuntimeError(f"huffman_pack.cu is built for sm_90a; device "
                           f"{dev} is sm_{major}{minor}")
    fn = _library()
    # the launch goes to the current device's context: make the planes'
    # device current, whichever device the caller had current
    with torch.cuda.device(dev):
        out = _pack_outputs(packer, dev)
        args = _pack_args(packer, yq, cbq, crq, out)
        err = fn(ctypes.byref(args), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"huffman_pack launch failed on {dev}: "
                           f"CUDA error {err}")
    huffman_pack.launches += 2
    by_dev = huffman_pack.launches_by_device
    by_dev[str(dev)] = by_dev.get(str(dev), 0) + 2
    words, nbytes, base, ovf = out[:4]
    return (words[0] if packer.sessions == 1 else words), nbytes, base, ovf


#: kernel launches since the last reset, two a call (plain-version calls
#: do not count), in total and by device ("cuda:0": n)
huffman_pack.launches = 0
huffman_pack.launches_by_device = {}


def stuff_bytes(scan: bytes) -> bytes:
    """JPEG byte stuffing (0xFF → 0xFF 0x00) over a scan, vectorized."""
    arr = np.frombuffer(scan, dtype=np.uint8)
    idx = np.flatnonzero(arr == 0xFF)
    if idx.size == 0:
        return scan
    return np.insert(arr, idx + 1, 0).tobytes()


def words_to_stripe_bytes(
    words: np.ndarray, base_words: np.ndarray, nbytes: np.ndarray
) -> Tuple[bytes, ...]:
    """Split the compacted word buffer into per-stripe scan byte strings.

    ``words`` holds u32 bit patterns (int32 or uint32 numpy arrays both
    serialize to the same big-endian bytes)."""
    be = words.view(np.uint32).astype(">u4").tobytes()
    out = []
    for s in range(len(nbytes)):
        start = int(base_words[s]) * 4
        out.append(be[start:start + int(nbytes[s])])
    return tuple(out)
