"""The traced window: device activity from ``torch.profiler``.

Only the card's activity is recorded (CUPTI), not the host's operators:
the measured quantities are the device's intervals and kernel names. The
profiler is started and stopped from the event loop's thread, the process's
main thread (CUPTI records nothing for a first start from another thread).

CUPTI now and then drops every kernel record of a window while the card
worked throughout. A window holding no kernel record is taken again, a
bounded number of times; if every try comes back empty the device readings
are missing (never 0, never 100).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

#: names of device events that are copies or fills, not kernels
_NOT_KERNELS = ("Memcpy", "Memset")


def is_kernel(name: str) -> bool:
    return not name.startswith(_NOT_KERNELS)


def _synchronize_all() -> None:
    import torch

    for d in range(torch.cuda.device_count()):
        torch.cuda.synchronize(d)


class DeviceWindow:
    """One profiler window. ``start``/``stop`` bracket it and only switch
    the profiler; its records are read after the measured window
    (``collect``), so their parsing never holds up the served frames.
    ``result`` is ``{"t0", "t1", "events": [(name, start_s, end_s,
    device), ...]}`` in monotonic seconds."""

    def __init__(self) -> None:
        self._prof = None
        self.t0 = self.t1 = 0.0
        self._unix_minus_mono = 0.0
        self._counts: Optional[List[int]] = None
        self.result: Optional[Dict] = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        _synchronize_all()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self.t0 = time.monotonic()
        self._unix_minus_mono = time.time() - time.monotonic()

    def stop(self) -> None:
        _synchronize_all()
        self.t1 = time.monotonic()
        self._prof.__exit__(None, None, None)

    def _device_events(self):
        import torch

        cuda = torch.autograd.DeviceType.CUDA
        return [e for e in self._prof.profiler.kineto_results.events()
                if e.device_type() == cuda]

    def holds_kernels(self) -> bool:
        return self.counts()[1] > 0

    def counts(self) -> List[int]:
        """[device events, kernel events] the window recorded."""
        if self._counts is None:
            names = [e.name() for e in self._device_events()]
            self._counts = [len(names), sum(map(is_kernel, names))]
        return self._counts

    def collect(self) -> Dict:
        """The window's device events (kernels, copies, fills) on the
        monotonic clock (the profiler stamps them on the Unix clock)."""
        if self.result is None:
            off = self._unix_minus_mono
            self.result = {"t0": self.t0, "t1": self.t1, "events": [
                (e.name(), e.start_ns() / 1e9 - off, e.end_ns() / 1e9 - off,
                 int(e.device_index())) for e in self._device_events()]}
            self._prof = None
        return self.result


def busy_s(window: dict) -> float:
    """Seconds of the window in which some operation ran on the card,
    averaged over the cards that ran any."""
    from .stats import union_length

    t0, t1 = window["t0"], window["t1"]
    by_dev = {}
    for _n, s, e, d in window["events"]:
        if e > t0 and s < t1:
            by_dev.setdefault(d, []).append((max(s, t0), min(e, t1)))
    if not by_dev:
        return 0.0
    return sum(union_length(iv) for iv in by_dev.values()) / len(by_dev)
