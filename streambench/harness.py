"""One run of one cell: serve the cell's displays through the program's
websocket handler for a measured window, then judge what was delivered.

The program under test is ``selkies_tpu_torch``: its
``DataStreamingServer.ws_handler`` serves every display, built from
``Settings(argv=[], env=...)`` with the configuration's and the traffic's
settings and the benchmark's own seeded source. Everything before the
window is set-up; the window measures ``seconds``; then the sources stop,
the frames in flight are waited for, the server is stopped, and the
plain reference judges a sample of the window's frames.
"""

from __future__ import annotations

import asyncio
import bisect
import importlib.util
import json
import random
import sys
import threading
import time
from collections import defaultdict
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

from . import stats
from .client import BenchClient
from .reference import Encoded, Session
from .source import SourceFactory

ROOT = Path(__file__).resolve().parent.parent
BENCH = Path(__file__).resolve().parent

#: modules no run may hold once its window has closed, by top-level name
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "selkies_tpu", "chip_smoke",
                     "tools")
#: names of the program's threads (a thread left alive at exit may be in a
#: device call while CUDA is torn down)
PORT_THREADS = ("torchenc", "mesh-encode", "selkies-", "metrics-http")
#: spans the run's recorder keeps (the program's default ring of 4,096
#: holds under 10 s of 8 displays at 60 frames/s)
RING = 1 << 18
#: counters of the program's lane encoders the run reads at the window's
#: start and close
LANE_COUNTERS = ("host_fallback_stripes_total",)
#: terminals of a frame the encoder took and finished
DONE = ("acked", "empty")
#: the measurement procedure, the same for every cell: how long set-up may
#: take, how long it serves on before the window, how long the frames in
#: flight at the window's close may take to finish
SETUP_TIMEOUT_S = 900.0
SETTLE_S = 2.0
DRAIN_TIMEOUT_S = 60.0
#: a traced run's profiler: its window starts this far into the measured
#: window and lasts this long; set-up probes with short windows for up to
#: PROFILE_WARM_S, and a run whose windows held no kernel record retakes
#: them for up to PROFILE_AFTER_S past the window
PROFILE_OFFSET_S = 1.0
PROFILE_SECONDS = 2.0
PROFILE_PROBE_S = 0.5
PROFILE_WARM_S = 60.0
PROFILE_AFTER_S = 60.0


class RunError(RuntimeError):
    """The run could not produce a result."""


# -- the specification -------------------------------------------------------


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def resolve(workload: str, spec: Optional[dict] = None) -> dict:
    """The cell named ``workload`` with its configuration, traffic and
    metrics, each found by name from ``BENCHMARK.json``."""
    spec = spec if spec is not None else load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise RunError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    config = load_json(ROOT / entry["file"])
    traffic = load_json(BENCH / "traffic" / f"{cell['traffic']}.json")
    e2e = [m for m in spec["end_to_end"]
           if workload in m.get("workloads", [workload])]
    moved = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if (workload in m["workloads"] if "workloads" in m
                 else m["moves"] in moved)]
    return {"cell": cell, "config": config, "traffic": traffic,
            "end_to_end": e2e, "per_layer": layer}


def reader(name: str):
    """The reader of per-layer metric ``name``: ``metrics/<name>.py``'s
    ``read(record)``."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"streambench_metric_{name.replace('.', '_')}", path)
    if spec is None or not path.exists():
        raise RunError(f"no reader for metric {name!r}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def reference_module(name: str):
    return importlib.import_module(f"streambench.reference.{name}")


# -- hygiene -----------------------------------------------------------------


def forbidden_modules() -> List[str]:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN_MODULES))


def port_threads() -> List[str]:
    return [t.name for t in threading.enumerate()
            if t.name.startswith(PORT_THREADS)]


def wait_port_threads(timeout: float = 15.0) -> List[str]:
    deadline = time.monotonic() + timeout
    while port_threads() and time.monotonic() < deadline:
        time.sleep(0.05)
    return port_threads()


class _Clock:
    """``time.monotonic`` that remembers its first reading (the recorder's
    epoch, which its trace export counts from)."""

    def __init__(self) -> None:
        self.first: Optional[float] = None

    def __call__(self) -> float:
        t = time.monotonic()
        if self.first is None:
            self.first = t
        return t


# -- the run -----------------------------------------------------------------


class Run:
    """Everything one run measured, for the metrics and the comparison."""

    def __init__(self, res: dict, seed: int, seconds: float, trace: bool,
                 device, geometry: Optional[Tuple[int, int]] = None,
                 displays: Optional[int] = None) -> None:
        self.cell, self.config, self.traffic = (res["cell"], res["config"],
                                                res["traffic"])
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        self.width, self.height = geometry or (int(self.config["width"]),
                                               int(self.config["height"]))
        self.n_displays = int(displays or self.traffic["displays"])
        self.framerate = int(self.config["framerate"])
        self.env = {**self.config["settings"], **self.traffic["settings"],
                    "SELKIES_PORT": "0"}
        self.lane = bool(self.env.get("SELKIES_TPU_MESH"))
        self.t_w0 = self.t_w1 = 0.0
        self.setup_s = 0.0
        self.memory: Dict[str, int] = {}
        self.windows: List = []
        self.spans: List[dict] = []
        self.clients: List[BenchClient] = []
        self.factory: Optional[SourceFactory] = None
        self.mesh_stats: Dict[str, int] = {}
        #: the program's lane counters at the window's start and close
        self.counters: Dict[str, List[int]] = {}
        self.server = None
        self.open_spans_left = 0

    # -- serving -------------------------------------------------------------

    async def serve(self, t_process: float) -> None:
        from selkies_tpu_torch.observability.tracing import FlightRecorder
        from selkies_tpu_torch.server.data_server import DataStreamingServer
        from selkies_tpu_torch.settings import Settings

        from selkies_tpu_torch import native

        # the program builds its host coders at first use, which may fall
        # inside the window (a stripe that overflows the device packer)
        for coder in ("entropy_lib", "cavlc_lib"):
            getattr(native, coder, lambda: None)()
        tr = self.traffic
        self.factory = SourceFactory(self.seed, tr["content"],
                                     int(tr.get("scroll_rows", 4)))
        server = DataStreamingServer(Settings(argv=[], env=self.env),
                                     source_factory=self.factory,
                                     device=self.device)
        self.server = server
        clock = _Clock()
        server.recorder = FlightRecorder(capacity=RING, clock=clock)
        self.clients = [BenchClient(f"d{i}", self.width, self.height,
                                    self.framerate)
                        for i in range(self.n_displays)]
        tasks = [asyncio.create_task(server.ws_handler(c))
                 for c in self.clients]
        try:
            await self._set_up(server, tasks)
            self.setup_s = time.monotonic() - t_process
            await self._window()
            await self._drain(server)
            self.mesh_stats = dict(server.mesh_stats)
            self.spans = self._spans(server.recorder, clock.first)
        finally:
            for c in self.clients:
                await c.close()
            await asyncio.wait(tasks, timeout=30.0)
            await server.stop()
            self.server = None

    async def _set_up(self, server, tasks) -> None:
        """Until every display has delivered ``warmup_frames`` frames from
        its lane slot (no display on a solo encoder), then ``SETTLE_S``
        more of serving."""
        want = int(self.traffic["warmup_frames"])
        deadline = time.monotonic() + SETUP_TIMEOUT_S

        def ready() -> bool:
            if any(len(c.frames) < want for c in self.clients):
                return False
            if self.lane:
                return server.mesh_stats == {"bucketed": self.n_displays,
                                             "solo_fallback": 0}
            return True

        while not ready():
            if time.monotonic() > deadline:
                raise RunError(
                    "set-up timed out: frames "
                    f"{[len(c.frames) for c in self.clients]}, "
                    f"mesh_stats {server.mesh_stats}")
            for c, t in zip(self.clients, tasks):
                if c.killed() or t.done():
                    raise RunError(f"display {c.display} ended in set-up: "
                                   f"{c.killed()}")
            await asyncio.sleep(0.05)
        if self.trace and self._cuda():
            # CUPTI now and then records no kernel for a stretch of
            # windows; short windows until one holds a kernel keep such a
            # stretch out of the measured window where they can
            await self._profile_windows(
                until=time.monotonic() + PROFILE_WARM_S,
                length=PROFILE_PROBE_S, keep=False)
        await asyncio.sleep(SETTLE_S)

    def _cuda(self) -> bool:
        return str(self.device or "cuda").startswith("cuda")

    async def _window(self) -> None:
        import torch

        cuda = self._cuda()
        traced = self.trace and cuda
        self.t_w0 = time.monotonic()
        self.t_w1 = self.t_w0 + self.seconds
        # a traced run keeps serving past the window while it still waits
        # for a device trace that holds kernels
        self.factory.stop_at = float("inf") if traced else self.t_w1
        for c in self.clients:
            c.keep_from = self.t_w0
        self._count()
        if cuda:
            for d in range(torch.cuda.device_count()):
                torch.cuda.reset_peak_memory_stats(d)
        if traced:
            await asyncio.sleep(PROFILE_OFFSET_S)
            await self._profile_windows(until=self.t_w1)
        await asyncio.sleep(max(0.0, self.t_w1 - time.monotonic()))
        self._count()
        if cuda:
            self.memory = {
                f"cuda:{d}": int(torch.cuda.max_memory_reserved(d))
                for d in range(torch.cuda.device_count())}
        if traced:
            if not any(w.holds_kernels() for w in self.windows):
                await self._profile_windows(
                    until=time.monotonic() + PROFILE_AFTER_S)
            self.factory.stop_at = time.monotonic()

    def _count(self) -> None:
        """Read the program's lane counters (summed over its lanes)."""
        lanes = [ln for coord in self.server.mesh_coordinators.values()
                 for ln in coord.lanes]
        for name in LANE_COUNTERS:
            self.counters.setdefault(name, []).append(
                sum(int(getattr(ln.enc, name, 0)) for ln in lanes))

    async def _profile_windows(self, until: float,
                               length: float = PROFILE_SECONDS,
                               keep: bool = True) -> None:
        """Profiler windows of ``length`` one after another until one holds
        a kernel record, or until ``until``; kept for the readers unless
        ``keep`` is false."""
        from .profiling import DeviceWindow

        while time.monotonic() + length <= until:
            w = DeviceWindow()
            w.start()
            await asyncio.sleep(length)
            w.stop()
            if keep:
                self.windows.append(w)
            if w.holds_kernels():
                return

    async def _drain(self, server) -> None:
        """Wait (up to ``DRAIN_TIMEOUT_S``) until every frame the sources
        handed out has reached a terminal mark."""
        rec = server.recorder
        deadline = time.monotonic() + DRAIN_TIMEOUT_S
        while rec.open_spans() and time.monotonic() < deadline:
            await asyncio.sleep(0.02)
        self.open_spans_left = rec.open_spans()

    @staticmethod
    def _spans(recorder, epoch: float) -> List[dict]:
        """Every closed span of the run, from the recorder's trace export
        (monotonic seconds)."""
        by: Dict[int, dict] = {}
        for ev in recorder.export_trace_events()["traceEvents"]:
            if ev.get("ph") != "X":
                continue
            a = ev["args"]
            sp = by.setdefault(a["span"], {
                "display": a["display"], "frame_id": a["frame_id"],
                "terminal": a["terminal"], "stages": {}})
            t0 = epoch + ev["ts"] / 1e6
            sp["stages"][ev["name"]] = (t0, t0 + ev["dur"] / 1e6)
        out = []
        for sp in by.values():
            cap = sp["stages"].get("capture")
            if cap is None:
                continue
            sp["t0"] = cap[0]
            out.append(sp)
        out.sort(key=lambda s: s["t0"])
        return out

    # -- pairing -------------------------------------------------------------

    def pair(self) -> None:
        """Give each span the source frame it carried (``inst``, ``k``) and
        each head span (one the encoder took) the frame it encoded
        (``enc_k``): in a lane, the newest frame submitted before the
        tick took it, which is the last of the head's run of superseded
        submits (``dropped@submit``); on a solo pipeline, its own."""
        log = self.factory.log
        times = [t for t, _i, _k in log]
        for sp in self.spans:
            c0, c1 = sp["stages"]["capture"]
            j = bisect.bisect_left(times, c0 - 2e-6)
            sp["inst"] = sp["k"] = None
            if j < len(log) and log[j][0] <= c1 + 2e-6:
                sp["inst"], sp["k"] = log[j][1], log[j][2]
        self.log_time = {(i, k): t for t, i, k in log}
        runs: Dict[Tuple[str, int], List[dict]] = defaultdict(list)
        for sp in self.spans:
            if sp["inst"] is not None:
                runs[(sp["display"], sp["inst"])].append(sp)
        self.heads: Dict[Tuple[str, int], List[dict]] = {}
        for key, seq in runs.items():
            heads: List[dict] = []
            for sp in seq:
                if sp["terminal"] == "dropped@submit" and heads:
                    if self.lane:
                        heads[-1]["enc_k"] = sp["k"]
                    continue
                if sp["terminal"] == "dropped@submit":
                    continue
                sp["enc_k"] = sp["k"]
                heads.append(sp)
            self.heads[key] = heads

    def delivered(self) -> List[dict]:
        """Every frame delivered by each display's last source (the one
        that served the window), with its head span: receipt (its last
        stripe's arrival) and the capture of the pixels it carried."""
        out = []
        last = {}
        for display, inst in self.heads:
            last[display] = max(inst, last.get(display, inst))
        for display, inst in last.items():
            heads = self.heads[(display, inst)]
            client = next(c for c in self.clients if c.display == display)
            epoch = max((e for e, _f in client.frames), default=0)
            for pos, sp in enumerate(heads):
                if sp["terminal"] != "acked":
                    continue
                fr = client.frames.get((epoch, sp["frame_id"]))
                if fr is None:
                    continue
                out.append({
                    "display": display, "inst": inst, "pos": pos,
                    "frame_id": sp["frame_id"], "frame": fr, "span": sp,
                    "t_receipt": fr.t_last,
                    "t_capture": self.log_time[(inst, sp["enc_k"])]})
        return out

    # -- results -------------------------------------------------------------

    def in_window(self, t: float) -> bool:
        return stats.in_window(t, self.t_w0, self.t_w1)

    def end_to_end(self, frames: List[dict]) -> Dict[str, float]:
        win = [f for f in frames if self.in_window(f["t_receipt"])]
        g2g = [(f["t_receipt"] - f["t_capture"]) * 1e3 for f in win]
        out = {"served_fps": stats.window_rate(
                   [f["t_receipt"] for f in frames], self.t_w0, self.t_w1),
               "setup_s": self.setup_s}
        p95 = stats.percentile(g2g, 95)
        if p95 is not None:
            out["g2g_p95_ms"] = p95
        if self.memory:
            out["peak_mb_per_display"] = (sum(self.memory.values()) / 2**20
                                          / self.n_displays)
        return out

    def session(self, display: str, inst: int) -> Session:
        """What the encoder of ``display``'s source ``inst`` was handed, in
        order, with the messages the client kept of each frame."""
        client = next(c for c in self.clients if c.display == display)
        epoch = max((e for e, _f in client.frames), default=0)
        encoded = []
        for sp in self.heads[(display, inst)]:
            fr = client.frames.get((epoch, sp["frame_id"]))
            kept = fr is not None and sp["terminal"] == "acked" \
                and fr.t_first >= self.t_w0
            encoded.append(Encoded(sp["enc_k"], sp["frame_id"],
                                   sp["terminal"],
                                   fr.messages if kept else None))
        return Session(display, self.factory.pattern(inst).frame, encoded)

    def judge(self, frames: List[dict]) -> dict:
        """The comparison that decides ``correct``: a sample of the
        window's delivered frames, drawn from the seed, each judged by the
        configuration's reference within its whole session."""
        win = [f for f in frames if self.in_window(f["t_receipt"])
               and f["frame"].t_first >= self.t_w0]
        by_display: Dict[str, List[dict]] = defaultdict(list)
        for f in win:
            by_display[f["display"]].append(f)
        rng = random.Random(self.seed)
        n = int(self.traffic["sample_frames_per_display"])
        sample: Dict[Tuple[str, int], List[int]] = defaultdict(list)
        for d in sorted(by_display):
            fs = by_display[d]
            for f in rng.sample(fs, min(n, len(fs))):
                sample[(d, f["inst"])].append(f["pos"])
        ref = reference_module(self.config["reference"]).make(
            {**self.config, "width": self.width, "height": self.height},
            device=self.device or "cuda")
        mismatched, paint, why = 0, 0, []
        for (display, inst), positions in sorted(sample.items()):
            session = self.session(display, inst)
            for p, v in zip(positions, ref.judge_session(session, positions)):
                paint += v["paintover"]
                if not v["ok"]:
                    mismatched += 1
                    why.append(f"{display} frame "
                               f"{session.encoded[p].frame_id}: {v['why']}")
        n_sample = sum(len(p) for p in sample.values())
        # frames the encoder took in the window that never ended as
        # delivered (or empty)
        taken = [sp for heads in self.heads.values() for sp in heads
                 if self.in_window(sp["t0"])]
        lost = [sp for sp in taken if sp["terminal"] not in DONE]
        unmatched = sum(1 for sp in self.spans if sp["inst"] is None
                        and self.in_window(sp["t0"]))
        silent = [c.display for c in self.clients
                  if not by_display.get(c.display)]
        return {"sample": n_sample, "mismatched": mismatched,
                "lost": len(lost) + unmatched + self.open_spans_left,
                "silent": len(silent), "taken": len(taken),
                "paintover_stripes": paint, "why": why[:5]
                + [f"lost: {sp['display']} {sp['terminal']}"
                   for sp in lost[:3]] + [f"silent: {d}" for d in silent]}

    def record(self, frames: List[dict]) -> dict:
        """What the per-layer readers read: the window's delivered frames
        and spans, and the device trace with the frames delivered while
        it ran (a trace retaken past the window counts those frames)."""
        win = [f for f in frames if self.in_window(f["t_receipt"])]
        dw = next((w.collect() for w in self.windows if w.holds_kernels()),
                  None)
        if dw is not None:
            dw["frames"] = sum(1 for f in frames
                               if dw["t0"] <= f["t_receipt"] < dw["t1"])
        return {
            "config": self.config, "env": self.env,
            "width": self.width, "height": self.height,
            "delivered": win,
            "counters": {k: v[-1] - v[0] for k, v in self.counters.items()
                         if len(v) == 2},
            "spans": [sp for sp in self.spans if self.in_window(sp["t0"])],
            "device_window": dw,
        }


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             t_process: float, device=None, spec: Optional[dict] = None,
             geometry=None, displays=None) -> dict:
    """One run of ``workload``: the object of its result line.
    ``device``, ``geometry`` and ``displays`` let the CPU tests run a cell
    small; a run on the card leaves them unset."""
    res = resolve(workload, spec)
    run = Run(res, seed, seconds, trace, device, geometry, displays)
    run.host_probe_ms = host_probe_ms()
    asyncio.run(run.serve(t_process))
    left = wait_port_threads()
    if left:
        raise RunError(f"threads of the program still running: {left}")
    run.pair()
    frames = run.delivered()
    e2e = run.end_to_end(frames)
    rec = run.record(frames)
    layer_vals: Dict[str, float] = {}
    if trace:
        for m in res["per_layer"]:
            v = reader(m["name"])(rec)
            if v is not None:
                layer_vals[m["name"]] = v
    free_device(device)
    t_judge = time.monotonic()
    verdict = run.judge(frames)
    verdict["timing"] = {"setup_s": run.setup_s,
                         "after_window_s": t_judge - run.t_w1,
                         "judge_s": time.monotonic() - t_judge}
    return finish(run, res, e2e, layer_vals, verdict, trace, rec)


def free_device(device) -> None:
    import gc

    import torch

    gc.collect()
    if str(device or "cuda").startswith("cuda"):
        torch.cuda.empty_cache()


def checks_of(verdict: dict, min_sample: int) -> Dict[str, dict]:
    return {
        "mismatched_frames": {"value": verdict["mismatched"], "limit": 0},
        "lost_frames": {"value": verdict["lost"], "limit": 0},
        "silent_displays": {"value": verdict["silent"], "limit": 0},
        "compared_frames": {"value": verdict["sample"],
                            "limit": f">={min_sample}"},
    }


def finish(run: Run, res: dict, e2e: dict, layer_vals: dict, verdict: dict,
           trace: bool, rec: dict) -> dict:
    from . import breakdown

    min_sample = run.n_displays
    checks = checks_of(verdict, min_sample)
    correct = (verdict["mismatched"] == 0 and verdict["lost"] == 0
               and verdict["silent"] == 0 and verdict["sample"] >= min_sample)
    units = {m["name"]: m["unit"]
             for m in res["end_to_end"] + res["per_layer"]}
    if trace:
        metrics = {k: {"value": v, "unit": units[k]}
                   for k, v in layer_vals.items()}
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in res["end_to_end"] if m["name"] in e2e}
    device = device_info(run)
    out = {"correct": bool(correct),
           "attempted": verdict["taken"],
           "failed": verdict["lost"] + verdict["mismatched"],
           "metrics": metrics, "device": device}
    if trace:
        dw = rec["device_window"]
        if dw is not None:
            from .profiling import busy_s
            device["busy_s"] = busy_s(dw)
            device["window_s"] = dw["t1"] - dw["t0"]
            out["breakdown"] = breakdown.of(dw, rec["delivered"])
    out["diagnostics"] = {
        "end_to_end": e2e, "mesh_stats": run.mesh_stats,
        "paintover_stripes": verdict["paintover_stripes"],
        "why": verdict["why"],
        "profiler_windows": [w.counts() for w in run.windows],
        "delivered_in_window": len(rec["delivered"]),
        "timing": verdict["timing"],
        "memory_peak_reserved": run.memory,
        "counters": rec["counters"]}
    # how fast this host ran the program's host side: a lane whose tick
    # dispatch runs long on a slow host turns host-bound (PERF.md)
    out["host"] = {"probe_ms": run.host_probe_ms,
                   "tick_dispatch_ms": reader("tick_dispatch_ms")(rec)}
    out["checks"] = checks
    return out


def host_probe_ms() -> float:
    """Milliseconds this process takes for a fixed piece of Python work
    (the host's single-thread speed, read before the server starts)."""
    t = time.perf_counter()
    acc = 0
    for i in range(1_000_000):
        acc ^= i * i
    return (time.perf_counter() - t) * 1e3


def device_info(run: Run) -> dict:
    import torch

    if not run._cuda():
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": int(run.cell["chips"]),
            "memory_peak_bytes": max(run.memory.values(), default=0),
            "power_limit_w": power_limit()}


def power_limit() -> Optional[str]:
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None
