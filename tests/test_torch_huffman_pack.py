"""The Huffman pack's wrapper and the stripe budget, on the CPU.

The kernel (``csrc/huffman_pack.cu``) runs only on a card, where
``tests/test_torch_cuda.py`` holds it against the plain version; here the
wrapper must hand CPU tensors to the plain version (which
``tests/test_torch_device_entropy.py`` holds bit-exact with the JAX
packer), describe the geometry to the kernel as its C interface checks it,
and every caller must size its stripes with ``max_stripe_bytes``.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from selkies_tpu_torch.encoder import device_entropy as de
from selkies_tpu_torch.encoder.jpeg import (BLOCK_WORDS, JpegStripeEncoder,
                                            encode_body, max_stripe_bytes)
from selkies_tpu_torch.parallel import mesh as tmesh

CU = Path(de.__file__).resolve().parent.parent / "csrc" / "huffman_pack.cu"


@pytest.mark.parametrize("stripe_h,pad_w,want", [
    (64, 256, 1 << 14),       # the small test shapes keep the JAX budget
    (16, 64, 1 << 14),
    (64, 512, 1 << 14),       # 4 bits a pixel meets 16 KB here
    (64, 1376, 44032),        # 1366x768
    (64, 1920, 61440),        # the lanes' 1080p stripe
    (64, 2560, 81920),
    (64, 3840, 122880),       # a 3840-wide SFE band
    (64, 7680, (1 << 17) - 4),  # the plain packer's 15-bit word index
])
def test_stripe_budget_follows_the_stripe_shape(stripe_h, pad_w, want):
    assert max_stripe_bytes(stripe_h, pad_w) == want
    assert max_stripe_bytes(stripe_h, pad_w) % 4 == 0


def test_solo_and_lane_packers_take_the_budget_of_their_stripes():
    enc = JpegStripeEncoder(1920, 1080, device="cpu")
    assert enc._packer.max_stripe_words * 4 == 61440
    assert enc._packer.block_words == BLOCK_WORDS
    lane = tmesh.MeshStripeEncoder(
        tmesh.parse_mesh_spec("session:1", [torch.device("cpu")]), 2, 1920,
        1080)
    assert lane._packer.max_stripe_words * 4 == 61440
    assert lane._cap == 17 * 61440 // 4
    small = JpegStripeEncoder(256, 120, device="cpu")
    assert small._packer.max_stripe_words * 4 == 1 << 14


def _planes(h=128, w=256, sh=64, seed=3, sessions=1):
    rng = np.random.default_rng(seed)
    f = torch.from_numpy(rng.integers(0, 256, (sessions * h, w, 3),
                                      dtype=np.uint8))
    f[:sh // 2] = 90                                  # some flat blocks
    recip = torch.from_numpy(np.full((1, 8, 8), 1 / 16, np.float32))
    qsel = torch.zeros(sessions * h // sh, dtype=torch.int32)
    yq, cbq, crq, _, _ = encode_body(f, torch.zeros_like(f), recip, recip,
                                     qsel, stripe_h=sh)
    return yq, cbq, crq


@pytest.mark.parametrize("sessions", [1, 2])
def test_wrapper_hands_cpu_tensors_to_the_plain_version(sessions,
                                                        monkeypatch):
    planes = _planes(sessions=sessions)
    p = de.DeviceEntropyPacker(sessions * 128, 256, 64, device="cpu",
                               block_words=BLOCK_WORDS, sessions=sessions,
                               max_stripe_bytes=max_stripe_bytes(64, 256))
    want = p.pack_plain(*planes)
    calls = []
    plain = de.DeviceEntropyPacker.pack_plain

    def spy(self, *a):
        calls.append(self)
        return plain(self, *a)

    monkeypatch.setattr(de.DeviceEntropyPacker, "pack_plain", spy)
    launches = de.huffman_pack.launches
    got = p.pack(*planes)
    assert calls == [p]
    assert de.huffman_pack.launches == launches
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert got[0].shape == ((p.cap_words,) if sessions == 1
                            else (sessions, p.cap_words))


def test_wrapper_refuses_a_device_it_has_no_version_for():
    p = de.DeviceEntropyPacker(64, 64, 64, device="cpu")
    t = torch.empty((8, 8, 64), dtype=torch.int16, device="meta")
    c = torch.empty((4, 4, 64), dtype=torch.int16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        de.huffman_pack(p, t, c, c)


def test_planes_the_kernel_would_refuse():
    p = de.DeviceEntropyPacker(128, 256, 64, device="cpu")
    yq, cbq, crq = _planes()
    de._check_planes(p, yq, cbq, crq)
    with pytest.raises(ValueError, match="yq must be"):
        de._check_planes(p, yq[:8], cbq, crq)
    with pytest.raises(TypeError, match="int16"):
        de._check_planes(p, yq.int(), cbq, crq)
    with pytest.raises(ValueError, match="contiguous"):
        de._check_planes(p, yq, cbq.transpose(0, 1).contiguous()
                         .transpose(0, 1), crq)


@pytest.mark.parametrize("pad_h,pad_w,sh,sessions", [
    (128, 256, 64, 1), (3 * 64, 80, 16, 3), (8 * 1088, 1920, 64, 8),
    (1088, 3840, 64, 1)])
def test_kernel_arguments_describe_the_geometry(pad_h, pad_w, sh, sessions):
    """What the C interface checks before it launches (huffman_pack_launch)
    holds for the wrapper's arguments, and the scratch matches the count
    launch's grid."""
    p = de.DeviceEntropyPacker(pad_h, pad_w, sh, device="cpu",
                               sessions=sessions, block_words=BLOCK_WORDS,
                               max_stripe_bytes=max_stripe_bytes(sh, pad_w))
    S = pad_h // sh
    yq = torch.zeros((pad_h // 8, pad_w // 8, 64), dtype=torch.int16)
    c = torch.zeros((pad_h // 16, pad_w // 16, 64), dtype=torch.int16)
    out = de._pack_outputs(p, "cpu")
    a = de._pack_args(p, yq, c, c, out)
    assert (a.n_stripes, a.sessions) == (S, sessions)
    assert a.yrows == 2 * a.crows and a.bx == 2 * a.mcols == 2 * a.cbx
    assert a.bps == a.crows * a.mcols * 6 == len(de.scan_geometry(
        pad_h, pad_w, sh)[0]) // S
    assert a.cap_words == (S // sessions) * a.stripe_words
    assert a.block_bits == 32 * BLOCK_WORDS
    gx = -(-a.bps // de._COUNT_THREADS)
    assert out[4].numel() == S * a.bps and out[5].numel() == S * gx
    assert tuple(out[0].shape) == (sessions, p.cap_words)
    assert a.words == out[0].data_ptr() and a.yq == yq.data_ptr()


def test_the_wrapper_and_the_kernel_agree_on_their_constants():
    src = CU.read_text()
    assert int(re.search(r"kThreads = (\d+);", src).group(1)) \
        == de._COUNT_THREADS
    assert int(re.search(r"kTableSize = (\d+);", src).group(1)) \
        == de._kernel_tables().size
    fields = re.search(r"struct PackArgs \{(.*?)\};", src, re.S).group(1)
    names = re.findall(r"(\w+)(?:, (\w+))?;", fields)
    assert [n for pair in names for n in pair if n] == \
        [f for f, _ in de._PackArgs._fields_]


def test_kernel_tables_hold_the_standard_codes():
    t = de._kernel_tables()
    dc_code, dc_len, ac_code, ac_len = de._packed_tables()
    assert np.array_equal(t & 0xFFFF, np.concatenate([dc_code, ac_code]))
    assert np.array_equal(t >> 16, np.concatenate([dc_len, ac_len]))
    assert (t >> 16).max() <= 16      # the kernel's writer takes <= 16 bits
