"""The port's Huffman packer against the JAX DeviceEntropyPacker.

Same coefficients in, bit-exact ``(words, nbytes, base, overflow)`` out —
overflowed stripes' words included — and every non-overflowed stripe's
unstuffed scan equals the port's host coder (entropy_py)."""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from selkies_tpu.encoder import device_entropy as jde
from selkies_tpu.encoder.jpeg import _encode_body
from selkies_tpu.ops.quant import quality_scaled_tables
from selkies_tpu_torch.encoder import device_entropy as tde
from selkies_tpu_torch.encoder import entropy_py

H, W, SH = 128, 256, 64


def _coeffs(kind, seed, q, pq, qsel):
    """Coefficients the JAX step computes for a synthetic frame."""
    rng = np.random.default_rng(seed)
    if kind == "noise":
        f = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
        f[:SH] = rng.integers(0, 256, 3, dtype=np.uint8)   # one flat stripe
    else:
        from selkies_tpu.capture.synthetic import SyntheticSource

        f = SyntheticSource(W, H, pattern=kind, seed=seed).next_frame()
    ly, lc = quality_scaled_tables(q)
    py, pc = quality_scaled_tables(pq)
    qy = jnp.asarray(np.stack([ly, py]), jnp.float32)
    qc = jnp.asarray(np.stack([lc, pc]), jnp.float32)
    yq, cbq, crq, _, _ = _encode_body(
        jnp.asarray(f), jnp.zeros((H, W, 3), jnp.uint8), qy, qc,
        jnp.asarray(qsel, jnp.int32), stripe_h=SH)
    return tuple(np.asarray(a) for a in (yq, cbq, crq))


CASES = [
    # kind, seed, q, pq, qsel, block_words, max_stripe_bytes
    ("desktop", 0, 40, 90, (0, 0), 16, 1 << 14),
    ("desktop", 1, 40, 90, (1, 1), 56, 1 << 15),
    ("motion", 2, 75, 90, (0, 1), 16, 1 << 14),
    ("noise", 3, 40, 90, (0, 0), 16, 1 << 14),
    # block overflow: noise at q100 needs far more than 16 words per block
    ("noise", 4, 40, 100, (1, 1), 16, 1 << 14),
    # stripe overflow at a small per-stripe byte budget
    ("noise", 5, 40, 90, (0, 1), 56, 1 << 10),
]


def _pack_both(yq, cbq, crq, bw, msb):
    jp = jde.DeviceEntropyPacker(H, W, SH, block_words=bw, max_stripe_bytes=msb)
    want = tuple(np.asarray(a) for a in jp.pack(yq, cbq, crq))
    tp = tde.DeviceEntropyPacker(H, W, SH, block_words=bw,
                                 max_stripe_bytes=msb, device="cpu")
    got = tuple(t.numpy() for t in tp.pack(*(torch.from_numpy(a.copy())
                                             for a in (yq, cbq, crq))))
    return want, got, tp


@pytest.mark.parametrize("kind,seed,q,pq,qsel,bw,msb", CASES)
def test_packer_bit_exact(kind, seed, q, pq, qsel, bw, msb):
    yq, cbq, crq = _coeffs(kind, seed, q, pq, qsel)
    (jw, jn, jb, jo), (tw, tn, tb, to), _ = _pack_both(yq, cbq, crq, bw, msb)
    assert tw.dtype == np.int32 and tw.shape == jw.shape
    assert np.array_equal(tw.view(np.uint32), jw)
    assert np.array_equal(tn, jn)
    assert np.array_equal(tb, jb)
    assert np.array_equal(to, jo)


def test_overflow_cases_do_overflow():
    """The overflow cases above really exercise both overflow kinds."""
    yq, cbq, crq = _coeffs("noise", 4, 40, 100, (1, 1))
    _, (_, _, _, ovf), _ = _pack_both(yq, cbq, crq, 16, 1 << 14)
    assert ovf[1] and not ovf[0]
    yq, cbq, crq = _coeffs("noise", 5, 40, 90, (0, 1))
    _, (_, tn, _, ovf), _ = _pack_both(yq, cbq, crq, 56, 1 << 10)
    assert ovf[1] and tn[1] > (1 << 10)


@pytest.mark.parametrize("kind,seed,q,pq,qsel,bw,msb", CASES)
def test_unstuffed_scans_equal_entropy_py(kind, seed, q, pq, qsel, bw, msb):
    yq, cbq, crq = _coeffs(kind, seed, q, pq, qsel)
    _, (tw, tn, tb, to), tp = _pack_both(yq, cbq, crq, bw, msb)
    raw = tde.words_to_stripe_bytes(tw, tb, tn)
    yrows, crows = SH // 8, SH // 16
    for s in range(H // SH):
        if to[s]:
            continue
        want = entropy_py.encode_scan_420(
            yq[s * yrows:(s + 1) * yrows], cbq[s * crows:(s + 1) * crows],
            crq[s * crows:(s + 1) * crows])
        assert tde.stuff_bytes(raw[s]) == want


def test_scan_geometry_is_the_same():
    for geom in ((128, 256, 64), (1088, 1920, 64), (64, 48, 16)):
        for a, b in zip(jde.scan_geometry(*geom), tde.scan_geometry(*geom)):
            assert np.array_equal(np.asarray(a), np.asarray(b))


def test_bitlen_is_integer_exact():
    v = torch.arange(-4096, 4097)
    want = torch.tensor([abs(int(x)).bit_length() for x in v])
    assert torch.equal(tde.bitlen(v), want)


def test_stuffing_and_word_split():
    assert tde.stuff_bytes(b"\x12\xff\x34\xff") == b"\x12\xff\x00\x34\xff\x00"
    words = np.array([0x11223344, 0xAABBCCDD, 0xFFFFFFFF], np.uint32)
    parts = tde.words_to_stripe_bytes(words.view(np.int32), np.array([0, 2]),
                                      np.array([5, 3]))
    assert parts == (b"\x11\x22\x33\x44\xaa", b"\xff\xff\xff")
