"""The port's H.264 ops against the JAX package on the CPU, exactly.

This is an integer codec: every comparison is ``np.array_equal``
(tolerance 0). Inputs are made with numpy from a seed and handed to both.
The JAX motion kernel runs as the JAX package's own CPU tests run it, in
Pallas interpret mode."""

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from selkies_tpu.encoder import h264_device as jdev  # noqa: E402
from selkies_tpu.ops import h264_transform as jht  # noqa: E402
from selkies_tpu.ops import motion as jmotion  # noqa: E402
from selkies_tpu.ops.pallas_me import _rank_table as jrank  # noqa: E402
from selkies_tpu.ops.pallas_me import me_mc_stripes as jme  # noqa: E402
from selkies_tpu_torch.encoder import h264_device as tdev  # noqa: E402
from selkies_tpu_torch.ops import h264_transform as ht  # noqa: E402
from selkies_tpu_torch.ops import motion as tmotion  # noqa: E402
from selkies_tpu_torch.ops.me_mc import _rank_table as trank  # noqa: E402
from selkies_tpu_torch.ops.me_mc import me_mc_stripes  # noqa: E402

QPS = (0, 17, 26, 36, 51)


def _t(a):
    return torch.from_numpy(np.array(a))


def _blocks(seed, shape=(6, 5, 4, 4), lo=-300, hi=300):
    return np.random.default_rng(seed).integers(lo, hi, shape).astype(np.int32)


def test_tables_are_the_jax_packages():
    for name in ("_CF", "_MF", "_V", "_POS_CLASS", "_QPC", "MF_TABLE",
                 "V_TABLE", "ZIGZAG_4x4"):
        assert np.array_equal(getattr(ht, name), getattr(jht, name)), name
    for qp in range(-3, 56):
        assert ht.qpc_for(qp) == jht.qpc_for(qp)
    qps = np.arange(-3, 56, dtype=np.int32)
    assert np.array_equal(ht.qpc_for(_t(qps)).numpy(),
                          np.asarray(jht.qpc_for(jnp.asarray(qps))))


def test_block_layout_matches():
    plane = np.random.default_rng(1).integers(0, 256, (3, 32, 48)) \
        .astype(np.int32)
    got = ht.plane_to_blocks(_t(plane))
    assert np.array_equal(got.numpy(),
                          np.asarray(jht.plane_to_blocks(jnp.asarray(plane))))
    assert np.array_equal(ht.blocks_to_plane(got).numpy(), plane)


def test_forward_dct4_is_cf_x_cft_and_matches():
    x = _blocks(2, lo=-255, hi=256)
    got = ht.forward_dct4(_t(x)).numpy()
    assert np.array_equal(got, np.einsum("ij,...jk,lk->...il", ht._CF, x,
                                         ht._CF))
    assert np.array_equal(got, np.asarray(jht.forward_dct4(jnp.asarray(x))))


def test_inverse_dct4_matches_jax_and_numpy_mirror():
    d = _blocks(3, lo=-5000, hi=5000)
    got = ht.inverse_dct4(_t(d)).numpy()
    assert np.array_equal(got, np.asarray(jht.inverse_dct4(jnp.asarray(d))))
    assert np.array_equal(got, jht.NumpyMirror.inverse_dct4(d))


@pytest.mark.parametrize("qp", QPS)
@pytest.mark.parametrize("intra", [True, False])
def test_quant4_dequant4(qp, intra):
    w = np.asarray(jht.forward_dct4(jnp.asarray(_blocks(qp, lo=-255,
                                                        hi=256))))
    z = ht.quant4(_t(w), qp, intra=intra).numpy()
    assert np.array_equal(z, np.asarray(jht.quant4(jnp.asarray(w),
                                                   jnp.int32(qp), intra)))
    d = ht.dequant4(_t(z), qp).numpy()
    assert np.array_equal(d, np.asarray(jht.dequant4(jnp.asarray(z),
                                                     jnp.int32(qp))))
    assert np.array_equal(d, jht.NumpyMirror.dequant4(z, qp))


@pytest.mark.parametrize("qp", QPS)
def test_luma_dc_path(qp):
    dc = _blocks(10 + qp, shape=(7, 4, 4), lo=-4080, hi=4081)
    y = ht.hadamard4_fwd(_t(dc)).numpy()
    assert np.array_equal(y, np.asarray(jht.hadamard4_fwd(jnp.asarray(dc))))
    z = ht.quant_dc16(_t(y), qp).numpy()
    assert np.array_equal(z, np.asarray(jht.quant_dc16(jnp.asarray(y),
                                                       jnp.int32(qp))))
    d = ht.dequant_dc16(_t(z), qp).numpy()
    assert np.array_equal(d, np.asarray(jht.dequant_dc16(jnp.asarray(z),
                                                         jnp.int32(qp))))
    assert np.array_equal(d, jht.NumpyMirror.dequant_dc16(z, qp))


@pytest.mark.parametrize("qp", QPS)
def test_chroma_dc_path(qp):
    qpc = jht.qpc_for(qp)
    dc = _blocks(20 + qp, shape=(7, 2, 2), lo=-4080, hi=4081)
    y = ht.hadamard2_fwd(_t(dc)).numpy()
    assert np.array_equal(y, np.asarray(jht.hadamard2_fwd(jnp.asarray(dc))))
    z = ht.quant_dc2(_t(y), qpc).numpy()
    assert np.array_equal(z, np.asarray(jht.quant_dc2(jnp.asarray(y),
                                                      jnp.int32(qpc))))
    d = ht.dequant_dc2(_t(z), qpc).numpy()
    assert np.array_equal(d, np.asarray(jht.dequant_dc2(jnp.asarray(z),
                                                        jnp.int32(qpc))))
    assert np.array_equal(d, jht.NumpyMirror.dequant_dc2(z, qpc))


def test_per_stripe_qp_equals_scalar_qp_per_stripe():
    """A [S] QP tensor (paint-over raises some stripes' QP) gives each
    stripe what its own scalar QP gives."""
    qps = np.array([26, 18, 40], np.int32)
    w = _blocks(30, shape=(3, 5, 16, 4, 4), lo=-2000, hi=2000)
    dc = _blocks(31, shape=(3, 5, 2, 2), lo=-8000, hi=8000)
    q = _t(qps)
    z = ht.quant4(_t(w), q, intra=False).numpy()
    d = ht.dequant4(_t(z), q).numpy()
    zc = ht.quant_dc2(_t(dc), q).numpy()
    dcd = ht.dequant_dc2(_t(zc), q).numpy()
    for s, qp in enumerate(qps.tolist()):
        assert np.array_equal(z[s], ht.quant4(_t(w[s]), qp, False).numpy())
        assert np.array_equal(d[s], ht.dequant4(_t(z[s]), qp).numpy())
        assert np.array_equal(zc[s], ht.quant_dc2(_t(dc[s]), qp).numpy())
        assert np.array_equal(dcd[s], ht.dequant_dc2(_t(zc[s]), qp).numpy())


# ---------------------------------------------------------------------------
# motion search


S, H, W = 3, 32, 128


def _me_case(kind):
    """(cur, ref, ref_cb, ref_cr) stripe batches: true motion, all ties,
    or noise."""
    rng = np.random.default_rng({"shifted": 40, "flat": 41, "noise": 42}[kind])
    cb = rng.integers(0, 256, (S, H // 2, W // 2), dtype=np.uint8)
    cr = rng.integers(0, 256, (S, H // 2, W // 2), dtype=np.uint8)
    if kind == "shifted":
        big = rng.integers(0, 256, (S, H + 16, W + 16), dtype=np.uint8)
        return big[:, 5:5 + H, 3:3 + W].copy(), big[:, :H, :W].copy(), cb, cr
    if kind == "flat":
        flat = np.full((S, H, W), 77, np.uint8)
        return flat, flat.copy(), cb, cr
    return (rng.integers(0, 256, (S, H, W), dtype=np.uint8),
            rng.integers(0, 256, (S, H, W), dtype=np.uint8), cb, cr)


@pytest.mark.parametrize("kind", ["shifted", "flat", "noise"])
def test_me_mc_plain_matches_pallas_kernel_and_full_search(kind):
    """The wrapper on CPU tensors (the plain version) equals the JAX
    package's Pallas kernel and, stripe by stripe, the port's
    ``full_search_mc`` on one unbatched plane."""
    planes = _me_case(kind)
    before = me_mc_stripes.launches
    got = [x.numpy() for x in me_mc_stripes(*[_t(p) for p in planes])]
    assert me_mc_stripes.launches == before      # CPU: the plain version
    want = [np.asarray(x) for x in jme(*[jnp.asarray(p) for p in planes])]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        assert np.array_equal(g, w)
    for s in range(S):
        one = tmotion.full_search_mc(*[_t(p[s]) for p in planes])
        for g, o in zip(got, one):
            assert np.array_equal(g[s], o.numpy())
    if kind == "shifted":
        assert (got[0][:, 1:-1, 1:-1] == [5, 3]).all()   # true motion found
    if kind == "flat":
        assert (got[0] == 0).all()                       # ties go to (0, 0)


def test_pad_replicate_and_offsets_match():
    x = np.random.default_rng(5).integers(0, 256, (2, 16, 32), dtype=np.uint8)
    assert np.array_equal(tmotion.pad_replicate(_t(x), 12).numpy(),
                          np.asarray(jmotion.pad_replicate(jnp.asarray(x), 12)))
    for s in (0, 1, 12):
        assert np.array_equal(tmotion._offsets(s), jmotion._offsets(s))


@pytest.mark.parametrize("search", range(16))
def test_rank_table_is_the_pallas_kernels(search):
    """The rank table the kernel's wrapper uploads (the low bits of its
    (sad << 10) | rank key) equals the Pallas kernel's for every radius
    the kernel takes."""
    got, want = trank(search), jrank(search)
    assert got.dtype == want.dtype == np.int32
    assert np.array_equal(got, want)


def test_me_mc_wrapper_rejects_bad_shapes():
    cur = torch.zeros((2, 32, 64), dtype=torch.uint8)
    cb = torch.zeros((2, 16, 32), dtype=torch.uint8)
    with pytest.raises(ValueError):
        me_mc_stripes(cur, cur, cb[:, :8], cb)
    with pytest.raises(ValueError):
        me_mc_stripes(cur[:, :24], cur[:, :24], cb[:, :12], cb[:, :12])
    with pytest.raises(ValueError):
        me_mc_stripes(cur, cur, cb, cb, search=16)


def _tie_case():
    """A stripe whose MV field has a tie in its winner counts: eight MBs
    at (0, 1) and eight at (1, 0); a flat reference makes every offset an
    exact SAD tie, so the collapse moves MBs."""
    rng = np.random.default_rng(7)
    nby, nbx = H // 16, W // 16
    mv = np.zeros((S, nby, nbx, 2), np.int32)
    mv[0, 0] = (0, 1)
    mv[0, 1] = (1, 0)
    mv[1, 0, :3] = (2, -3)
    mv[2] = rng.integers(-12, 13, (nby, nbx, 2))
    cur = rng.integers(0, 256, (S, H, W), dtype=np.uint8)
    cur[0] = 90
    ref = cur.copy()
    ref[1] = np.roll(cur[1], (2, -3), axis=(0, 1))
    cb = rng.integers(0, 256, (S, H // 2, W // 2), dtype=np.uint8)
    cr = rng.integers(0, 256, (S, H // 2, W // 2), dtype=np.uint8)
    return cur, ref, cb, cr, mv


def test_collapse_mv_ties_matches_with_tied_counts():
    cur, ref, cb, cr, mv = _tie_case()
    py, pcb, pcr = (x.numpy() for x in tmotion.mc_predict(
        _t(ref), _t(cb), _t(cr), _t(mv)))
    args = (cur, ref, cb, cr, mv, py, pcb, pcr)
    got = [x.numpy() for x in tdev._collapse_mv_ties(
        *[_t(a) for a in args], search=12)]
    fn = jax.jit(jax.vmap(functools.partial(jdev._collapse_mv_ties,
                                            search=12)))
    want = [np.asarray(x) for x in fn(*[jnp.asarray(a) for a in args])]
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    # the tie (8 MBs each at (0, 1) and (1, 0)) goes to the lower index,
    # (0, 1), and the flat stripe collapses onto it entirely
    assert (got[0][0] == [0, 1]).all()


def test_first_argmax_takes_the_lowest_index():
    x = torch.tensor([[3, 7, 7, 1], [0, 0, 0, 0], [5, 1, 9, 9]])
    assert tdev._first_argmax(x).tolist() == [1, 0, 2]


def test_prepare_planes_matches_the_compiled_jax_step():
    """The color transform rounds to integers, so it must follow the JAX
    encoder's compiled arithmetic (fused multiply-adds), not its eager
    one; odd sizes exercise the edge padding."""
    rng = np.random.default_rng(9)
    rgb = rng.integers(0, 256, (94, 120, 3), dtype=np.uint8)
    fn = jax.jit(jdev.prepare_planes, static_argnums=(1, 2))
    want = [np.asarray(x) for x in fn(jnp.asarray(rgb), 96, 128)]
    got = [x.numpy() for x in tdev.prepare_planes(_t(rgb), 96, 128)]
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
