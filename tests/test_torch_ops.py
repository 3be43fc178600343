"""Port ops (selkies_tpu_torch.ops) against the JAX package on the same inputs.

Inputs are made with numpy from a seed and handed to both packages. On the
CPU the port's DCT+quant wrapper runs its plain PyTorch version, which must
equal the JAX step exactly; the hand-written CUDA kernel is held against
the plain version on the card in tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from selkies_tpu.encoder.jpeg import _encode_body
from selkies_tpu.ops import color as jcolor
from selkies_tpu.ops.quant import quality_scaled_tables as jtables
from selkies_tpu_torch._device import encoder_stream
from selkies_tpu_torch.encoder.jpeg import JpegStripeEncoder, _recip, encode_body
from selkies_tpu_torch.ops import color as tcolor
from selkies_tpu_torch.ops import dct as tdct
from selkies_tpu_torch.ops.dct_quant import (dct8_quant_zigzag,
                                             dct8_quant_zigzag_plain)
from selkies_tpu_torch.ops.quant import ZIGZAG, quality_scaled_tables


def _frame(seed, h=128, w=256, smooth=False):
    rng = np.random.default_rng(seed)
    if not smooth:
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    f = np.stack([xx % 255, yy * 1.7 % 255, (xx + yy) % 255], -1)
    f += rng.normal(0, 6, f.shape)
    return np.clip(f, 0, 255).astype(np.uint8)


def _tables(q, pq):
    ly, lc = quality_scaled_tables(q)
    py, pc = quality_scaled_tables(pq)
    return (np.stack([ly, py]).astype(np.float32),
            np.stack([lc, pc]).astype(np.float32))


def test_quant_tables_and_zigzag_are_copies():
    from selkies_tpu.ops.quant import ZIGZAG as JZZ

    assert np.array_equal(ZIGZAG, JZZ)
    for q in (1, 10, 40, 50, 90, 100):
        for a, b in zip(quality_scaled_tables(q), jtables(q)):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_color_and_420_bit_exact():
    f = _frame(0)
    jy, jcb, jcr = (np.asarray(a) for a in jcolor.rgb_to_ycbcr(jnp.asarray(f)))
    ty, tcb, tcr = (a.numpy() for a in tcolor.rgb_to_ycbcr(torch.from_numpy(f)))
    for a, b in ((jy, ty), (jcb, tcb), (jcr, tcr)):
        assert a.dtype == b.dtype == np.float32
        assert np.array_equal(a, b)
    assert np.array_equal(np.asarray(jcolor.subsample_420(jnp.asarray(jcb))),
                          tcolor.subsample_420(torch.from_numpy(tcb)).numpy())


@pytest.mark.parametrize("seed,q,pq,qsel,smooth", [
    (0, 40, 90, (0, 1), False),
    (1, 40, 90, (1, 0), True),
    (2, 10, 95, (0, 0), False),
    (3, 75, 100, (1, 1), True),
])
def test_encode_body_matches_jax_exactly(seed, q, pq, qsel, smooth):
    """color + 4:2:0 + plain DCT+quant+zigzag + damage, per component,
    against the JAX step: np.array_equal on int16."""
    f = _frame(seed, smooth=smooth)
    prev = _frame(seed + 100)
    prev[:64] = f[:64]                      # stripe 0 undamaged
    qy, qc = _tables(q, pq)
    qs = np.asarray(qsel, np.int32)
    jout = _encode_body(jnp.asarray(f), jnp.asarray(prev), jnp.asarray(qy),
                        jnp.asarray(qc), jnp.asarray(qs), stripe_h=64)
    tout = encode_body(torch.from_numpy(f), torch.from_numpy(prev),
                       torch.from_numpy(_recip(qy)),
                       torch.from_numpy(_recip(qc)),
                       torch.from_numpy(qs), stripe_h=64)
    for name, a, b in zip(("yq", "cbq", "crq", "damage"), jout[:4], tout[:4]):
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape, name
        assert np.array_equal(a, b), name
    assert tout[0].dtype == torch.int16
    assert np.array_equal(np.asarray(jout[4]), tout[4].numpy())


def test_plain_matches_pallas_interpret():
    """The plain version against the Pallas kernel in interpret mode, with
    tests/test_pallas_dct.py's tolerance (contractions reordered)."""
    from selkies_tpu.ops.pallas_dct import dct8_quant_zigzag as pallas

    rng = np.random.default_rng(0)
    h, w = 32, 256
    plane = rng.integers(0, 256, (h, w)).astype(np.float32)
    ly, _ = quality_scaled_tables(40)
    py, _ = quality_scaled_tables(90)
    recip = _recip(np.stack([ly, py]))
    row_idx = (np.arange(h // 8) % 2).astype(np.int32)
    row_recip = recip[row_idx]
    want = np.asarray(pallas(plane, row_recip, interpret=True))
    got = dct8_quant_zigzag_plain(torch.from_numpy(plane),
                                  torch.from_numpy(recip),
                                  torch.from_numpy(row_idx)).numpy()
    assert got.shape == want.shape == (h // 8, w // 8, 64)
    assert np.max(np.abs(got - want)) <= 1.0
    assert (got == want).mean() > 0.999


def test_wrapper_uses_plain_on_cpu_without_counting():
    rng = np.random.default_rng(4)
    plane = torch.from_numpy(rng.integers(0, 256, (16, 40)).astype(np.float32))
    recip = torch.from_numpy(_recip(_tables(40, 90)[0]))
    row = torch.tensor([0, 1], dtype=torch.int32)
    before = dct8_quant_zigzag.launches
    (out,) = dct8_quant_zigzag([(plane, recip, row)])
    assert dct8_quant_zigzag.launches == before
    assert torch.equal(out, dct8_quant_zigzag_plain(plane, recip, row))
    assert out.shape == (2, 5, 64) and out.dtype == torch.int16


def test_wrapper_rejects_other_devices_and_bad_shapes():
    """No fallback: a tensor that is neither on the CPU nor on the card is
    refused, as are shapes the kernel does not take and more planes than
    one launch takes."""
    recip = torch.ones(2, 8, 8)
    row2 = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        dct8_quant_zigzag([(torch.empty(16, 16, device="meta"), recip, row2)])
    with pytest.raises(ValueError):
        dct8_quant_zigzag([(torch.zeros(12, 16), recip,
                            torch.zeros(1, dtype=torch.int32))])
    with pytest.raises(ValueError):
        dct8_quant_zigzag([(torch.zeros(16, 16), recip,
                            torch.zeros(3, dtype=torch.int32))])
    with pytest.raises(ValueError):
        dct8_quant_zigzag([])
    with pytest.raises(ValueError):
        dct8_quant_zigzag([(torch.zeros(16, 16), recip, row2)] * 4)
    with pytest.raises(ValueError):
        dct8_quant_zigzag([(torch.zeros(16, 16), recip, row2),
                           (torch.empty(16, 16, device="meta"), recip, row2)])


def test_flat_plane_is_dc_only():
    plane = torch.full((16, 24), 200.0)
    recip = torch.from_numpy(_recip(_tables(50, 90)[0]))
    (out,) = dct8_quant_zigzag([(plane, recip,
                                 torch.zeros(2, dtype=torch.int32))])
    assert torch.all(out[:, :, 1:] == 0)
    assert torch.all(out[:, :, 0] == out[0, 0, 0])


def test_frame_wrapper_equals_pallas_interpret_plane_by_plane():
    """One call with a frame's Y, Cb and Cr planes (the chroma planes
    strided views, as the kernel takes them without a copy) against the
    JAX package's Pallas kernel in interpret mode, as
    tests/test_pallas_dct.py runs it, plane by plane, with that test's
    tolerance (the Pallas kernel's contractions are summed in another
    order); and exactly against the plain version per plane."""
    from selkies_tpu.ops.pallas_dct import dct8_quant_zigzag as pallas

    rng = np.random.default_rng(9)
    qy, qc = _tables(40, 90)
    ry, rc = _recip(qy), _recip(qc)
    y = rng.integers(0, 256, (32, 256)).astype(np.float32)
    cbcr = rng.integers(0, 256, (16, 2 * 128)).astype(np.float32)
    row_y = (np.arange(4) % 2).astype(np.int32)
    row_c = np.array([1, 0], np.int32)
    cb_t = torch.from_numpy(cbcr)[:, :128]             # rows 256 floats apart
    cr_t = torch.from_numpy(cbcr)[:, 128:]
    planes = [(torch.from_numpy(y), torch.from_numpy(ry),
               torch.from_numpy(row_y)),
              (cb_t, torch.from_numpy(rc), torch.from_numpy(row_c)),
              (cr_t, torch.from_numpy(rc), torch.from_numpy(row_c))]
    before = dct8_quant_zigzag.launches
    got = dct8_quant_zigzag(planes)
    assert dct8_quant_zigzag.launches == before
    for (p, r, i), g, recip, row in zip(planes, got, (ry, rc, rc),
                                        (row_y, row_c, row_c)):
        want = np.asarray(pallas(p.numpy(), recip[row], interpret=True))
        g = g.numpy()
        assert g.shape == want.shape and g.dtype == np.int16
        assert np.max(np.abs(g - want)) <= 1.0
        assert (g == want).mean() > 0.999
        assert np.array_equal(g, dct8_quant_zigzag_plain(p, r, i).numpy())


def test_tf32_canary():
    """The library DCT pins full-f32 matmuls even if a caller enabled TF32 —
    the GPU twin of the JAX package's Precision.HIGHEST pins."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        torch.set_float32_matmul_precision("medium")
        blocks = torch.from_numpy(
            np.random.default_rng(5).uniform(-128, 127, (3, 8, 8)).astype(np.float32))
        got = tdct.block_dct2_einsum(blocks).double()
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is False
        assert torch.get_float32_matmul_precision() == "highest"
        c = torch.from_numpy(tdct._dct8_np()).double()
        want = c @ blocks.double() @ c.T
        assert torch.max(torch.abs(got - want)).item() < 1e-3
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.backends.cudnn.allow_tf32 = old[1]
        torch.set_float32_matmul_precision(old[2])


def test_blockify_layout():
    x = torch.arange(16 * 24, dtype=torch.float32).reshape(16, 24)
    b = tdct.blockify(x)
    assert b.shape == (2, 3, 8, 8)
    assert torch.equal(b[1, 2], x[8:16, 16:24])


def test_encoders_on_the_cpu_have_no_stream_and_stay_independent():
    """The card's encoders share one stream (encoder_stream); on the CPU
    there is none, and two encoders alive at once still encode the same
    bytes as each other."""
    assert encoder_stream("cpu") is None
    assert encoder_stream(torch.device("cpu")) is None
    a = JpegStripeEncoder(64, 48, stripe_height=16, device="cpu")
    b = JpegStripeEncoder(64, 48, stripe_height=16, device="cpu")
    assert a.stream is None and b.stream is None
    for seed in (11, 12, 13):
        f = _frame(seed, h=48, w=64)
        sa, sb = a.encode_frame(f), b.encode_frame(f)
        assert [(s.y_start, s.jpeg) for s in sa] == \
            [(s.y_start, s.jpeg) for s in sb]
        assert sa
