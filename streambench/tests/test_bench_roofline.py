"""The kernels' work is counted from shapes alone."""

from streambench import roofline


def test_dct8_bytes_of_a_lane_of_8_at_1080p():
    # Y [8*1088, 1920] + 2 x [8*544, 960] float32 in, int16 out
    planes = (8 * 1088 * 1920 + 2 * 8 * 544 * 960) * 6
    got = roofline.dct8_bytes(8, 1088, 1920)
    assert planes < got < planes + 20_000
    assert abs(roofline.dct8_bound_s(8, 1088, 1920) - 44.9e-6) < 0.1e-6


def test_dct8_bytes_scale_with_sessions():
    one = roofline.dct8_bytes(1, 1088, 1920)
    assert roofline.dct8_bytes(4, 1088, 1920) - 4 * one == \
        -3 * 3 * 2 * 64 * 4


def test_me_mc_comparisons_from_shapes():
    assert roofline.me_mc_comparisons(17, 64, 1920) == \
        17 * 64 * 1920 * 625
    assert roofline.me_mc_comparisons(17, 64, 1920, search=4) == \
        17 * 64 * 1920 * 81


def test_share():
    assert roofline.share_pct(1.0, 2.0) == 50.0
    assert roofline.share_pct(2.0, 1.0) == 200.0
