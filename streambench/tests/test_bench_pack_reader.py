"""The reader of the Huffman pack kernel's device time on hand-made
records: the kernel's launches inside the traced window, per delivered
frame; nothing where the window holds no launch of it (the program before
the kernel existed), no trace, or no frame."""

import pytest

from streambench import harness

READ = harness.reader("huffman_pack_ms_per_frame")

COUNT = "(anonymous namespace)::huffman_pack_count(PackArgs)"
EMIT = "(anonymous namespace)::huffman_pack_emit(PackArgs)"


def record(events, frames=2, t0=10.0, t1=10.1):
    return {"delivered": [], "spans": [],
            "device_window": {"t0": t0, "t1": t1, "events": events,
                              "frames": frames}}


def test_the_kernels_launches_per_delivered_frame():
    ev = [(COUNT, 10.010, 10.0101, 0), (EMIT, 10.0101, 10.0104, 0),
          (COUNT, 10.050, 10.0502, 0), (EMIT, 10.0502, 10.0506, 0),
          ("dct8_quant_zigzag_kernel(Frame)", 10.000, 10.0001, 0),
          ("void at::native::elementwise_kernel<...>", 10.02, 10.03, 0),
          ("Memcpy DtoH (Device -> Pinned)", 10.0104, 10.02, 0)]
    # 0.1 + 0.3 + 0.2 + 0.4 ms of the kernel over 2 frames
    assert READ(record(ev)) == pytest.approx(0.5)


def test_a_launch_across_the_window_counts_its_part_inside():
    ev = [(COUNT, 9.9995, 10.0005, 0), (EMIT, 10.0995, 10.1005, 0)]
    assert READ(record(ev, frames=1)) == pytest.approx(1.0)


def test_without_the_kernel_a_trace_or_a_frame_it_reads_nothing():
    assert READ(record([("void at::native::cummax<...>", 10.0, 10.05, 0)])) \
        is None
    assert READ(record([(COUNT, 10.01, 10.02, 0)], frames=0)) is None
    assert READ({"delivered": [], "spans": [], "device_window": None}) is None
    # outside the window
    assert READ(record([(EMIT, 10.2, 10.3, 0)])) is None
