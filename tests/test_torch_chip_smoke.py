"""``chip_smoke.py``'s thread discipline and its trace check, on the CPU.

The script runs on the card, but how it ends does not depend on one: a
phase that leaves a thread of the port running fails its check, naming
the thread, and a phase whose check fails while a served display's
encoder thread and the metrics server run closes them in its own
``finally``, so the process exits 1 with the check's message. (A
``torchenc-async`` driver thread still running at interpreter exit makes
the process abort with SIGABRT, exit 134, instead: ``PERF.md`` §6.) The
profiler check takes a request again only when CUPTI lost its records.
"""

import importlib.util
import threading
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def cs():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port_threads(cs, but=()):
    return sorted(t.name for t in threading.enumerate()
                  if t.is_alive() and t.name.startswith(cs.PORT_THREADS)
                  and t.ident not in but)


def test_a_thread_left_running_fails_the_check_by_name(cs, monkeypatch):
    monkeypatch.setattr(cs, "THREAD_GRACE_S", 0.2)
    stop = threading.Event()
    t = threading.Thread(target=stop.wait, name="torchenc-left", daemon=True)
    t.start()
    try:
        with pytest.raises(SystemExit, match="torchenc-left"):
            cs.check_no_port_threads("a phase")
    finally:
        stop.set()
        t.join(5.0)
    assert not t.is_alive()


def test_a_failed_check_in_a_served_phase_closes_what_it_left(
        cs, monkeypatch):
    """``server_trace`` on the CPU at 256x144, its JPEG trace asked for a
    kernel no trace holds: the check raises while the display's encoder
    driver and the metrics server run, and the phase's own ``finally``
    stops both, so no thread of the port is left."""
    monkeypatch.setattr(cs, "DEVICE", "cpu")
    monkeypatch.setattr(cs, "W", 256)
    monkeypatch.setattr(cs, "H", 144)
    monkeypatch.setattr(cs, "TRACE_FRAMES", 5)
    monkeypatch.setitem(cs.TRACE_KERNEL, "jpeg", "no_such_kernel")
    before = {t.ident for t in threading.enumerate()}
    with pytest.raises(SystemExit, match="no_such_kernel"):
        cs.phase_server_trace()
    deadline = time.monotonic() + 10.0
    while _port_threads(cs, before) and time.monotonic() < deadline:
        time.sleep(0.05)
    assert _port_threads(cs, before) == []


class _Wrapper:
    launches = 0


@pytest.mark.parametrize("case", ["stalled", "lost_then_held"])
def test_trace_capture_retries_only_windows_cupti_lost(
        cs, monkeypatch, tmp_path, case):
    """Each profiler request's readings are kept. A request during which
    the path launched no kernel fails the check at once; one during which
    it launched and whose trace holds none of it is taken again, and the
    first trace that holds the kernel ends the check."""
    import asyncio
    import json

    held = {"traceEvents": [{"cat": "kernel", "name": "k_kernel",
                             "dur": 5.0}]}
    lost = {"traceEvents": [{"cat": "kernel", "name": "other", "dur": 1.0}]}
    plan = [(0, lost)] if case == "stalled" else [(3, lost), (2, lost),
                                                  (4, held)]
    calls = []

    def http(url):
        launched, trace = plan[len(calls)]
        path = tmp_path / f"trace{len(calls)}.json"
        path.write_text(json.dumps(trace))
        calls.append(url)
        _Wrapper.launches += launched
        return 200, json.dumps({"path": str(path), "device_events": 7})

    monkeypatch.setattr(cs, "_http", http)
    metrics = type("M", (), {"http_port": 1})()
    run = cs._trace_capture(metrics, "k_kernel", _Wrapper)
    if case == "stalled":
        with pytest.raises(SystemExit, match="launched no k_kernel"):
            asyncio.run(run)
        assert len(calls) == 1
        return
    out = asyncio.run(run)
    assert out["attempts"] == 3 and out["kernel_events"] == 1
    assert [r["launches"] for r in out["readings"]] == [3, 2, 4]
    assert [r["hits"] for r in out["readings"]] == [0, 0, 1]
    assert out["readings"][0] == {"launches": 3, "device_events": 7,
                                  "kernel_events": 1, "hits": 0}
