"""The readers of the lane's waits, each on a hand-made record: a record
whose delivered frames carry the stage gives its mean, one without it (the
program before the stage existed, or no card) gives None."""

import pytest

from streambench import harness

#: reader -> the recorder stage it reads
READERS = {"pending_wait_ms": "pending", "harvest_lag_ms": "harvest_lag",
           "device_tail_ms": "device_tail", "handoff_ms": "handoff",
           "tick_device_ms": "device"}


def frame(t0, **stages):
    span = {"display": "d0", "frame_id": 1, "terminal": "acked", "t0": t0,
            "stages": {"capture": (t0, t0 + 0.001), **stages}}
    return {"span": span, "t_receipt": t0 + 0.1}


def record(frames):
    return {"delivered": frames, "spans": [f["span"] for f in frames],
            "device_window": None}


@pytest.mark.parametrize("name", sorted(READERS))
def test_a_stage_reader_gives_the_mean_over_delivered_frames(name):
    stage = READERS[name]
    rec = record([frame(10.0, **{stage: (10.010, 10.014)}),
                  frame(10.2, **{stage: (10.210, 10.220)}),
                  frame(10.4)])
    # frames that lack the stage do not count
    assert harness.reader(name)(rec) == pytest.approx(7.0)


@pytest.mark.parametrize("name", sorted(READERS))
def test_a_stage_reader_without_the_stage_reads_nothing(name):
    rec = record([frame(10.0, dispatch=(10.010, 10.030)), frame(10.2)])
    assert harness.reader(name)(rec) is None
    assert harness.reader(name)(record([])) is None


def test_the_lane_stages_cover_what_no_recorder_stage_covers():
    """Together with the recorder's stages the lane's waits tile a span:
    between_stages_ms (time no recorder stage covers) is then their sum."""
    t = 10.0
    stages = {}
    for name, ms in (("capture", 1), ("superseded", 5), ("pending", 9),
                     ("dispatch", 30), ("device_tail", 4),
                     ("harvest_lag", 20), ("fetch_wait", 1), ("pack", 6),
                     ("handoff", 3), ("queue", 1), ("send", 1)):
        stages[name] = (t, t + ms / 1e3)
        t += ms / 1e3
    rec = record([frame(10.0)])
    rec["delivered"][0]["span"]["stages"].update(stages)
    waits = sum(harness.reader(n)(rec) for n in (
        "pending_wait_ms", "harvest_lag_ms", "device_tail_ms", "handoff_ms"))
    assert harness.reader("between_stages_ms")(rec) == \
        pytest.approx(waits + 5)
