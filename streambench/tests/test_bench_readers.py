"""Each per-layer reader on a hand-made record."""

import pytest

from streambench import breakdown, harness

CELL = "jpeg-q40-1080p60.lane8-scroll"


def record(device_window=None):
    res = harness.resolve(CELL)

    def span(t0, terminal="acked", **stages):
        return {"display": "d0", "frame_id": 1, "terminal": terminal,
                "t0": t0, "stages": {"capture": (t0, t0 + 0.001), **stages}}

    acked = span(10.0, dispatch=(10.010, 10.030), fetch_wait=(10.060, 10.061),
                 pack=(10.061, 10.065), queue=(10.065, 10.066),
                 send=(10.066, 10.067))
    spans = [acked, span(10.02, "dropped@submit"),
             span(10.04, "dropped@submit"), span(10.06, "empty")]
    return {"config": res["config"], "traffic": res["traffic"],
            "env": {**res["config"]["settings"], **res["traffic"]["settings"]},
            "width": 1920, "height": 1080, "spans": spans,
            "delivered": [{"span": acked, "t_receipt": 10.07}],
            "device_window": device_window}


def test_span_readers():
    rec = record()
    assert harness.reader("submit_drop_pct")(rec) == 50.0
    assert harness.reader("queue_send_ms")(rec) == pytest.approx(2.0)
    assert harness.reader("tick_dispatch_ms")(rec) == pytest.approx(20.0)
    assert harness.reader("harvest_pack_ms")(rec) == pytest.approx(4.0)
    # 67 ms from capture to the send's end; 1 + 20 + 7 of it covered
    assert harness.reader("between_stages_ms")(rec) == pytest.approx(39.0)


def test_counter_reader():
    rec = record()
    read = harness.reader("host_coded_stripes_per_frame")
    assert read(rec) is None
    rec["counters"] = {"host_fallback_stripes_total": 17}
    assert read(rec) == 17.0
    rec["delivered"] = []
    assert read(rec) is None


def test_device_readers_without_a_trace_read_nothing():
    rec = record()
    for name in ("eager_device_ms_per_frame", "dct8_quant_zigzag_roofline",
                 "device_idle_pct"):
        assert harness.reader(name)(rec) is None


def test_device_readers():
    ev = [("dct8_quant_zigzag_kernel(Frame)", 10.000, 10.0001, 0),
          ("dct8_quant_zigzag_kernel(Frame)", 10.040, 10.0401, 0),
          ("void at::native::elementwise_kernel<...>", 10.0001, 10.0101, 0),
          ("Memcpy HtoD (Pinned -> Device)", 10.020, 10.030, 0)]
    rec = record({"t0": 10.0, "t1": 10.1, "events": ev, "frames": 1})
    assert harness.reader("eager_device_ms_per_frame")(rec) == \
        pytest.approx(10.0)
    # 150 MB at 3.35 TB/s is ~44.9 us against 100 us
    assert harness.reader("dct8_quant_zigzag_roofline")(rec) == \
        pytest.approx(44.9, abs=0.1)
    assert harness.reader("device_idle_pct")(rec) == pytest.approx(79.8)
    b = breakdown.of(rec["device_window"], rec["delivered"])
    assert b["device_ops"][0][0].startswith("void at::native")
    # the longest gap, 10.0401 to 10.1, overlaps pack longest (4 ms)
    assert b["idle_gaps"][0] == ["host:pack", pytest.approx(0.0599)]
    assert len(b["idle_gaps"]) == 3
