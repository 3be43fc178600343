"""The traced run's ``breakdown``: where the device's time went, and what
the host was doing while the device sat idle."""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List

from . import stats

#: recorder stages a host can be in while the device waits
HOST_STAGES = ("capture", "stage", "dispatch", "fetch_wait", "pack",
               "queue", "send")


def of(window: dict, delivered: List[dict], top: int = 10) -> dict:
    t0, t1 = window["t0"], window["t1"]
    events = [(n, max(s, t0), min(e, t1)) for n, s, e, _d in window["events"]
              if e > t0 and s < t1]
    by_name: Dict[str, float] = defaultdict(float)
    for n, s, e in events:
        by_name[n] += e - s
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = stats.gaps([(s, e) for _n, s, e in events], t0, t1)
    gaps.sort(key=lambda g: g[0] - g[1])
    stages = [(name, iv) for f in delivered
              for name, iv in f["span"]["stages"].items()
              if name in HOST_STAGES]
    idle = []
    for g0, g1 in gaps[:top]:
        over: Dict[str, float] = defaultdict(float)
        for name, (s, e) in stages:
            o = min(e, g1) - max(s, g0)
            if o > 0:
                over[name] += o
        label = max(over.items(), key=lambda kv: kv[1])[0] if over \
            else "none"
        idle.append([f"host:{label}", g1 - g0])
    return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": idle}
