"""The benchmark's source: the same seed gives the same frames, served
or made anew, and its content is the port's synthetic desktop."""

import numpy as np
import pytest

from streambench.source import (RING, Pattern, SourceFactory, background,
                                glyph_atlas, text_page)


@pytest.mark.parametrize("pattern", ["scroll", "desktop", "static", "text"])
def test_served_frames_are_made_again_by_index(pattern):
    served = Pattern(160, 96, 2**31 + 7, pattern)
    again = Pattern(160, 96, 2**31 + 7, pattern)
    for k in range(3 * RING):
        assert np.array_equal(served.served(k), again.frame(k))


@pytest.mark.parametrize("pattern", ["scroll", "text"])
def test_scroll_is_the_background_rolled(pattern):
    p = Pattern(160, 96, 11, pattern)
    for k in (0, 1, 23, 24, 25, 500):
        assert np.array_equal(p.frame(k),
                              np.roll(p.frame(0), -(4 * k) % 96, axis=0))


def test_text_page_is_seeded_text_on_two_panes():
    a, b = text_page(640, 200, 2**31 + 3), text_page(640, 200, 2**31 + 3)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, text_page(640, 200, 2**31 + 4))
    code, doc = a[:, :160].astype(int), a[:, 160:].astype(int)
    # dark pane with light glyphs, white page with dark glyphs, and grey
    # anti-aliased edges between
    assert np.median(code) == 30 and np.median(doc) == 255
    assert (doc.min(axis=-1) < 64).mean() > 0.02
    assert ((doc > 64) & (doc < 224)).any()


def test_every_seed_shows_the_same_lines_in_another_order():
    a, b = text_page(640, 192, 5), text_page(640, 192, 6)
    assert not np.array_equal(a, b)
    for pane in (np.s_[:, :160], np.s_[:, 160:]):
        lines = [sorted(map(bytes, x[pane].reshape(12, -1)))
                 for x in (a, b)]
        assert lines[0] == lines[1]


def test_glyphs_are_one_pen_wide_strokes():
    atlas = glyph_atlas()
    assert atlas.shape == (95, 16, 8)
    assert not atlas[0].any() and (atlas[1:].sum(axis=(1, 2)) > 4).all()
    assert atlas.min() >= 0 and atlas.max() == 1


def test_background_is_the_ports_synthetic_desktop():
    from selkies_tpu_torch.capture.synthetic import SyntheticSource

    for seed in (0, 5, 2**32 + 1):
        assert np.array_equal(background(320, 180, seed),
                              SyntheticSource(320, 180, seed=seed)._bg)


def test_factory_logs_each_frame_and_stops():
    f = SourceFactory(100, "scroll")
    a, b = f(64, 48, 60.0), f(64, 48, 60.0)
    assert a.next_frame() is not None and b.next_frame() is not None
    assert a.next_frame() is not None
    assert [(i, k) for _t, i, k in f.log] == [(0, 0), (1, 0), (0, 1)]
    assert np.array_equal(f.pattern(1).frame(0), Pattern(64, 48, 101,
                                                         "scroll").frame(0))
    f.stop_at = 0.0
    assert a.next_frame() is None and len(f.log) == 3
