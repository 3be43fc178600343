"""The port's device CAVLC (encoder/device_cavlc.py) against the JAX
package's, and its payloads against the port's own native coder.

The packed buffer is compared byte for byte (tolerance 0): heads always,
payloads of every stripe that is not flagged (an overflowed stripe's
payload is recoded on the host from its exact levels, so only its flag
must agree)."""

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from selkies_tpu.encoder import device_cavlc as jd  # noqa: E402
from selkies_tpu_torch.encoder import device_cavlc as td  # noqa: E402
from selkies_tpu_torch.encoder.h264 import encode_picture_nals_np  # noqa: E402

MB_W, MB_H, S = 4, 2, 3
N = MB_W * MB_H
MSB = 16384


@functools.lru_cache(maxsize=None)
def _jax_pack():
    return jax.jit(functools.partial(jd.pack_p_frame, mb_w=MB_W, mb_h=MB_H,
                                     max_stripe_bytes=MSB))


def _levels(seed, magnitude, density=0.3):
    """A random P frame's level tensors: sparse levels up to
    ``magnitude``, MVs in the search range, chroma AC position 0 zero."""
    rng = np.random.default_rng(seed)

    def sparse(shape, mag):
        v = rng.integers(-mag, mag + 1, shape)
        return np.where(rng.random(shape) < density, v, 0).astype(np.int32)

    mv = rng.integers(-12, 13, (S, N, 2)).astype(np.int32)
    mv[:, ::3] = 0                                  # skip candidates
    luma = sparse((S, N, 16, 4, 4), magnitude)
    luma[:, 1::4] = 0                               # uncoded 8x8s / skips
    cdc = sparse((S, N, 2, 2, 2), magnitude)
    cac = sparse((S, N, 2, 4, 4, 4), magnitude)
    cac[..., 0, 0] = 0
    return mv, luma, cdc, cac


def _both(mv, luma, cdc, cac, damage, update):
    args = (mv, luma, cdc, cac, damage, update)
    got = td.pack_p_frame(*[torch.from_numpy(np.array(a)) for a in args],
                          mb_w=MB_W, mb_h=MB_H, max_stripe_bytes=MSB).numpy()
    want = np.asarray(_jax_pack()(*[jnp.asarray(a) for a in args]))
    return got, want


def _native(mv, luma, cdc, cac, s, qp=26, frame_num=3):
    return encode_picture_nals_np(
        mv[s], luma[s], np.zeros((N, 4, 4), np.int32), cdc[s], cac[s],
        is_idr=False, mb_w=MB_W, mb_h=MB_H, qp=qp, frame_num=frame_num)


def _check(got, want, mv, luma, cdc, cac, update):
    head = td.HEAD_BYTES * S
    assert got.shape == want.shape
    assert np.array_equal(got[:head], want[:head])
    t_bits, base_words, _, ovf = td.parse_cavlc_head(got, S)
    for s in range(S):
        if ovf[s] or not update[s]:
            continue
        a, na = td.payload_slice(got, S, base_words, t_bits, s)
        b, nb = jd.payload_slice(want, S, base_words, t_bits, s)
        assert na == nb and np.array_equal(a, b)
        nal = td.assemble_p_slice(a, na, 26, 3)
        assert nal == jd.assemble_p_slice(b, nb, 26, 3)
        assert nal == _native(mv, luma, cdc, cac, s)
    return ovf


@pytest.mark.parametrize("seed,magnitude", [(0, 1), (1, 2), (2, 8), (3, 30),
                                            (4, 127), (5, 200), (6, 2063)])
def test_pack_matches_jax_and_native(seed, magnitude):
    lv = _levels(seed, magnitude, density=0.05 + 0.1 * seed)
    damage = np.array([True, False, True])
    update = np.array([True, True, seed % 2 == 0])
    got, want = _both(*lv, damage, update)
    ovf = _check(got, want, *lv, update)
    assert not ovf.any()
    assert np.array_equal(got, want)                # whole buffer, too


def test_levels_past_the_escape_range_are_flagged_rest_exact():
    mv, luma, cdc, cac = _levels(11, 30)
    luma[0, 0, 0, 0, 1] = 3000          # past the escape range
    luma[1, 2, 3, 2, 2] = 2063          # still encodable, > int8 range
    update = np.ones(S, bool)
    got, want = _both(mv, luma, cdc, cac, np.ones(S, bool), update)
    ovf = _check(got, want, mv, luma, cdc, cac, update)
    assert list(ovf) == [True, False, False]


def test_all_zero_update_packs_nothing():
    lv = _levels(12, 8)
    update = np.zeros(S, bool)
    got, want = _both(*lv, np.zeros(S, bool), update)
    assert np.array_equal(got, want)
    t_bits, base_words, damage, ovf = td.parse_cavlc_head(got, S)
    assert not t_bits.any() and not base_words.any()
    assert not damage.any() and not ovf.any()
    assert not got[td.HEAD_BYTES * S:].any()


def test_static_frame_codes_one_skip_run_per_stripe():
    """No levels and zero motion: every MB skips, so each updated stripe
    is the one trailing mb_skip_run, equal to the native coder's slice."""
    z = np.zeros
    mv, luma = z((S, N, 2), np.int32), z((S, N, 16, 4, 4), np.int32)
    cdc, cac = z((S, N, 2, 2, 2), np.int32), z((S, N, 2, 4, 4, 4), np.int32)
    update = np.ones(S, bool)
    got, want = _both(mv, luma, cdc, cac, np.zeros(S, bool), update)
    assert np.array_equal(got, want)
    _check(got, want, mv, luma, cdc, cac, update)
    t_bits = td.parse_cavlc_head(got, S)[0]
    assert list(t_bits) == [7] * S                  # ue(8) = 0001001


def test_ep_escape_and_host_glue_match():
    for arr in ([0, 0, 0, 0, 1], [0, 0, 0, 0, 0, 1], [0, 0, 2], [0, 0, 4],
                [1, 2, 3], [0, 0], []):
        a = np.array(arr, np.uint8)
        assert td._ep_escape(a) == jd._ep_escape(a)
    assert td._ep_escape(np.array([0, 0, 0, 0, 1], np.uint8)) == \
        bytes([0, 0, 3, 0, 0, 3, 1])
    for qp in (0, 18, 26, 51):
        for fn in (0, 7, 15, 16):
            assert td._p_slice_header_bits(qp, fn) == \
                jd._p_slice_header_bits(qp, fn)
    for mb in [(1, 1), (120, 4), (240, 8)]:
        assert td.default_max_stripe_bytes(*mb) == \
            jd.default_max_stripe_bytes(*mb)
