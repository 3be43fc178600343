"""The port's harnesses (``selkies_tpu_torch/tools/``) against the
repository's ``tools/`` scripts that drive the JAX package, on the CPU.

* ``proto_fuzz``: the corpus for a seed is the JAX tool's, message for
  message; the port's fuzz session over it is held to
  ``tests/test_edge.py``'s assertions.
* ``chaos_run``: a 3 s fault storm through the port's real encoder
  factory on the CPU (solo, on a lane, and on a split-frame-encoding lane
  of two shards), each held to the assertions of
  ``tests/test_robustness.py``'s chaos test. The port compiles nothing on
  the CPU, so these run here; the JAX chaos test stays ``slow``.
* ``swarm_run``: the smoke of ``tests/test_swarm.py`` over the fake lane
  encoder, and a small storm over the port's real lane encoders.
* ``cavlc_fuzz``: the device mode's verdicts, reasons and overflow counts
  equal the JAX tool's seed by seed, its random frames are the JAX tool's
  arrays, an escape overflow is flagged with the clean stripe still
  exact; mode 1 decodes the native coder's stream to the NumpyMirror
  picture, with the stream equal to the JAX package's coder's.

Tolerance 0 throughout: corpora, arrays, verdicts and bytes are compared
for equality. No assertion reads a figure that follows the wall clock.
"""

import asyncio
import functools
import random

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from selkies_tpu_torch.tools import cavlc_fuzz as tfuzz  # noqa: E402
from selkies_tpu_torch.tools import proto_fuzz as tproto  # noqa: E402
from selkies_tpu_torch.tools.chaos_run import chaos_session  # noqa: E402
from selkies_tpu_torch.tools.swarm_run import swarm_run  # noqa: E402
from tools import cavlc_fuzz as jfuzz  # noqa: E402
from tools import proto_fuzz as jproto  # noqa: E402

# the geometry of tests/test_device_cavlc.py's seeded sweep
GEOM = dict(mb_w=4, mb_h=2, S=2)


@functools.lru_cache(maxsize=None)
def _jax_pack_jitted():
    """The JAX package's ``pack_p_frame_words`` under ``jax.jit``: one
    compile for the geometry (~10 s here) where the JAX tool's eager call
    compiles each primitive on its own (~45 s). The same function, so the
    same words."""
    import jax

    from selkies_tpu.encoder import device_cavlc as jdcav

    return jax.jit(jdcav.pack_p_frame_words,
                   static_argnames=("mb_w", "mb_h", "max_stripe_bytes"))


# ---------------------------------------------------------------- proto_fuzz


@pytest.mark.parametrize("seed", range(5))
def test_fuzz_corpus_equals_the_jax_tools(seed):
    want, got = random.Random(seed), random.Random(seed)
    for k in range(2000):
        assert tproto.gen_message(got) == jproto.gen_message(want), k
    assert got.random() == want.random()


def test_fuzz_corpus_kills_no_sessions(tmp_path, monkeypatch):
    monkeypatch.setenv("SELKIES_UPLOAD_DIR", str(tmp_path / "up"))
    report = asyncio.run(tproto.fuzz_session(iterations=500, seed=0,
                                             device="cpu"))
    assert report["premature_deaths"] == 0, report
    assert report["kills"] == 0, report
    assert report["uploads_leaked"] == 0, report
    assert report["observer_alive"], report
    assert report["observer_streaming"], report
    # the corpus reached the boundary
    assert report["protocol_errors"] > 0, report


# ----------------------------------------------------------------- chaos_run


@pytest.mark.parametrize("mode", [
    {}, {"mesh": True}, {"sfe": True, "devices": ["cpu", "cpu"]}],
    ids=["solo", "mesh", "sfe"])
def test_chaos_session_survives_fault_storm(mode, tmp_path, monkeypatch):
    monkeypatch.setenv("SELKIES_UPLOAD_DIR", str(tmp_path / "up"))
    report = asyncio.run(chaos_session(duration_s=3.0, seed=1, device="cpu",
                                       **mode))
    assert report["alive"], report
    assert report["injected"], report
    assert report["failed_displays"] == 0
    assert (report["restarts"] + report["watchdog_restarts"]
            + report["reconnects"]) >= 1, report
    assert report["frames_delivered"] > 0
    if mode:
        assert report["mesh_leaked_slots"] == 0, report
        assert report["mesh_sfe_shards"] == (2 if "sfe" in mode else 1)


def test_chaos_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        asyncio.run(chaos_session(duration_s=1.0))


# ----------------------------------------------------------------- swarm_run


def test_swarm_smoke_churn_storm_with_sick_slot():
    report = asyncio.run(swarm_run(
        n_clients=32, duration_s=3.0, seed=1, concurrency=12, fps=15.0,
        slots_per_lane=4, max_lanes=2, sick_slot=True, device="cpu"))
    assert report["swarm_clients"] >= 32
    assert report["leaked_slots"] == 0
    assert report["trace_open_spans"] == 0
    assert report["slot_accounting_violations"] == []
    assert report["victim_migrated"] is True
    assert report["cohabitants_stalled"] == 0
    assert report["quarantined_slots"] + report.get(
        "migrations", 0) >= 1
    assert report["frames_delivered_total"] > 0
    assert report["alive"] is True


def test_swarm_over_the_real_lane_encoders():
    report = asyncio.run(swarm_run(
        n_clients=8, duration_s=2.0, seed=1, concurrency=6, fps=15.0,
        slots_per_lane=4, max_lanes=2, encoder="real", sick_slot=True,
        device="cpu"))
    assert report["encoder"] == "real"
    assert report["swarm_clients"] >= 8
    assert report["leaked_slots"] == 0
    assert report["trace_open_spans"] == 0
    assert report["slot_accounting_violations"] == []
    assert report["victim_migrated"] is True
    assert report["cohabitants_stalled"] == 0
    assert report["frames_delivered_total"] > 0
    assert report["alive"] is True


# ---------------------------------------------------------------- cavlc_fuzz


@pytest.mark.parametrize("seed", range(12))
def test_device_mode_verdicts_equal_the_jax_tools(seed, monkeypatch):
    from selkies_tpu.encoder import device_cavlc as jdcav

    monkeypatch.setattr(jdcav, "pack_p_frame_words", _jax_pack_jitted())
    got = tfuzz.check_device_seed(seed, device="cpu", **GEOM)
    want = jfuzz.check_device_seed(seed, **GEOM)
    assert got == want
    assert got[0], got[1]


@pytest.mark.parametrize("seed", range(4))
def test_random_p_frame_equals_the_jax_tools(seed):
    for S, n_mb in ((2, 8), (17, 480)):
        got = tfuzz.random_p_frame(np.random.default_rng(seed), S, n_mb,
                                   0.3, 127)
        want = jfuzz.random_p_frame(np.random.default_rng(seed), S, n_mb,
                                    0.3, 127)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_device_pack_overflow_levels_flagged_and_rest_exact():
    """|level| past the escape code flags its stripe; the clean stripe
    in the same frame stays bit-exact with the native coder."""
    from selkies_tpu_torch.encoder import device_cavlc as dcav
    from selkies_tpu_torch.encoder.h264 import encode_picture_nals_np

    mb_w, mb_h, S = 4, 2, 2
    n = mb_w * mb_h
    mv = np.zeros((S, n, 2), np.int32)
    luma = np.zeros((S, n, 16, 4, 4), np.int32)
    cdc = np.zeros((S, n, 2, 2, 2), np.int32)
    cac = np.zeros((S, n, 2, 4, 4, 4), np.int32)
    luma[0, 0, 0, 0, 1] = 3000          # escape overflow → fallback
    luma[1, 2, 3, 2, 2] = 2063          # still codable, past int8
    words, t_bits, base_words, ovf = [x.numpy() for x in (
        dcav.pack_p_frame_words(
            *[torch.from_numpy(a) for a in (mv, luma, cdc, cac)],
            torch.ones(S, dtype=torch.bool),
            mb_w=mb_w, mb_h=mb_h, max_stripe_bytes=16384))]
    assert list(ovf) == [True, False]
    payload = np.stack(
        [(words >> 24) & 0xFF, (words >> 16) & 0xFF,
         (words >> 8) & 0xFF, words & 0xFF], -1).astype(np.uint8).reshape(-1)
    start = int(base_words[1]) * 4
    nbits = int(t_bits[1])
    got = dcav.assemble_p_slice(
        payload[start:start + ((nbits + 31) // 32) * 4], nbits, 26, 3)
    ldc = np.zeros((n, 4, 4), np.int32)
    ref = encode_picture_nals_np(
        mv[1], luma[1], ldc, cdc[1], cac[1], is_idr=False,
        mb_w=mb_w, mb_h=mb_h, qp=26, frame_num=3)
    assert got == ref


def test_device_mode_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tfuzz.check_device_seed(0, **GEOM)


@pytest.mark.parametrize("seed", range(4))
def test_mode1_decodes_to_the_numpy_mirror(seed, monkeypatch):
    """The port's stream decodes to the mirror's picture, and equals the
    stream of the JAX package's native coder and parameter sets (the JAX
    tool's own ``encode_two_frames`` predates its coder's deblocking
    argument, so the port's runs with the JAX package's parts)."""
    pytest.importorskip("cv2")
    from selkies_tpu.encoder import h264 as jh264
    from selkies_tpu.native import cavlc_lib as jax_cavlc_lib

    ok, why, levels = tfuzz.check_seed(seed)
    assert ok, why
    got = tfuzz.encode_two_frames(levels, 2, 2, 26)
    monkeypatch.setattr(tfuzz, "cavlc_lib", jax_cavlc_lib)
    monkeypatch.setattr(tfuzz, "make_sps", jh264.make_sps)
    monkeypatch.setattr(tfuzz, "make_pps", jh264.make_pps)
    assert got == tfuzz.encode_two_frames(levels, 2, 2, 26)
