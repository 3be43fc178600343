"""The lane's waits in the flight recorder (``observability.LANE_STAGES``).

* Served through the port's ``ws_handler`` on the CPU, every ACKed lane
  span carries capture, superseded, pending, dispatch, harvest_lag,
  fetch_wait, pack, handoff, queue and send, and they tile it: each stage
  ends where the next starts, on one shared timestamp, except the step
  from the end of ``capture`` to the submit's own stamp. A solo frame's
  span carries ``handoff`` by the same rule.
* On an injected clock, through the facade: a run of submits gives the
  frame the tick took ``superseded`` from the run's first submit to its
  last, ``pending`` from there to the dispatch; a lane encoder's device
  interval gives ``device`` and ``device_tail`` and moves the start of
  ``harvest_lag``; an encoder without one (the CPU) gives neither.
* Which submits are refused (the spans the capture loop closes
  ``dropped@submit``) is the JAX coordinator's, submit for submit.
"""

import asyncio
import json
import statistics
import time
import types

import pytest

pytest.importorskip("jax")

from selkies_tpu import robustness as jrob  # noqa: E402
from selkies_tpu.parallel import coordinator as jcoord  # noqa: E402
from selkies_tpu_torch import robustness as trob  # noqa: E402
from selkies_tpu_torch.observability import tracing  # noqa: E402
from selkies_tpu_torch.parallel import coordinator as tcoord  # noqa: E402
from selkies_tpu_torch.protocol.wire import unpack_binary  # noqa: E402
from selkies_tpu_torch.server import data_server as tds  # noqa: E402
from selkies_tpu_torch.settings import Settings  # noqa: E402

#: an ACKed lane span's stages on the CPU, in path order (no device ones)
TILED = ("capture", "superseded", "pending", "dispatch", "harvest_lag",
         "fetch_wait", "pack", "handoff", "queue", "send")


#: one lane of two slots (the default of :func:`_serve`)
LANE_ENV = {"SELKIES_TPU_MESH": "session:1",
            "SELKIES_TPU_SESSIONS_PER_CHIP": "2"}


def _serve(frames=24, env=LANE_ENV):
    """One 128x64 display of the real port JPEG encoder on the CPU (in a
    lane with the default ``env``, else solo), ACKing every frame; the
    recorder once the display has stopped."""
    async def run():
        full = {"SELKIES_PORT": "0", "SELKIES_ENCODER": "jpeg", **env}
        server = tds.DataStreamingServer(Settings(argv=[], env=full),
                                         device="cpu")
        ws = trob.InProcessClient()
        task = asyncio.create_task(server.ws_handler(ws))
        ws.feed("SETTINGS," + json.dumps({
            "displayId": "primary", "initialClientWidth": 128,
            "initialClientHeight": 64, "framerate": 60}))
        acked = set()
        deadline = time.monotonic() + 120.0
        while len(acked) < frames and time.monotonic() < deadline:
            await asyncio.sleep(0.01)
            for raw in list(ws.binary()):
                fid = unpack_binary(bytes(raw)).frame_id
                if fid not in acked:
                    acked.add(fid)
                    ws.feed(f"CLIENT_FRAME_ACK {fid}")
        await asyncio.sleep(0.2)
        await ws.close()
        await asyncio.wait_for(task, 30.0)
        await server.stop()
        return server.recorder

    return asyncio.run(run())


@pytest.fixture(scope="module")
def lane_spans():
    rec = _serve()
    assert rec.open_spans() == 0
    spans = sorted(rec._completed(), key=lambda t: t.t0)
    assert sum(t.terminal == "acked" for t in spans) >= 16
    return spans


def test_served_lane_spans_are_tiled_by_their_stages(lane_spans):
    steps = []
    for t in lane_spans:
        if t.terminal != "acked":
            continue
        assert sorted(t.spans) == sorted(TILED + ("ack",)), sorted(t.spans)
        for a, b in zip(TILED, TILED[1:]):
            (s0, e0), (s1, e1) = t.spans[a], t.spans[b]
            assert s0 <= e0 and s1 <= e1, (a, b)
            if a == "capture":
                # capture's end and the submit's stamp are two clock reads
                assert 0.0 <= s1 - e0 < 0.1, (a, b, s1 - e0)
                steps.append(s1 - e0)
            else:
                assert s1 == e0, (a, b, t.spans[a], t.spans[b])
    # a few microseconds apart, unless the event loop lost the GIL between
    assert statistics.median(steps) < 1e-4


def test_superseded_ends_at_the_frame_the_tick_took(lane_spans):
    """A head span's ``superseded`` runs over the spans the capture loop
    closed ``dropped@submit`` after it (the frames its run replaced, the
    last of which the tick encoded), and ends before the next head's
    capture."""
    heads = [i for i, t in enumerate(lane_spans)
             if t.terminal != "dropped@submit"]
    runs = 0
    for i, j in zip(heads, heads[1:]):
        head = lane_spans[i]
        if head.terminal != "acked":
            continue
        first, latest = head.spans["superseded"]
        assert first >= head.spans["capture"][1]
        dropped = lane_spans[i + 1:j]
        assert all(t.terminal == "dropped@submit" for t in dropped)
        if dropped:
            runs += 1
            assert latest >= dropped[-1].spans["capture"][1]
        else:
            assert latest == first
        assert latest <= lane_spans[j].spans["capture"][0]
    assert runs or all(t.terminal != "dropped@submit" for t in lane_spans)


# ---------------------------------------------------------------------------
# the facade on an injected clock


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


class _TimedEncoder(trob.FakeMeshEncoder):
    """A fake lane encoder whose dispatch and harvest take time on the
    injected clock."""

    def __init__(self, n, clock):
        super().__init__(n)
        self.clock = clock

    def dispatch(self, frames):
        self.clock.t += 0.010
        return super().dispatch(frames)

    def harvest(self, pending):
        self.clock.t += 0.002
        return super().harvest(pending)


def _coord(monkeypatch, clock, device=None):
    coord = tcoord.MeshEncodeCoordinator(
        "session:1", 2, 64, 48, slots_per_lane=2, max_lanes=1,
        enc_factory=lambda n: _TimedEncoder(n, clock))
    coord.stop()                      # ticks driven by hand
    facade = coord.acquire(64, 48)
    coord.stop()
    monkeypatch.setattr(tcoord, "time", types.SimpleNamespace(
        monotonic=clock, sleep=time.sleep))
    if device is not None:
        enc = coord.lanes[0].enc
        enc.device_interval = lambda pending: device(clock)
    return coord, facade


@pytest.mark.parametrize("k", [1, 3])
def test_a_run_of_submits_is_superseded_up_to_the_taken_frame(monkeypatch,
                                                             k):
    clock = _Clock()
    coord, facade = _coord(monkeypatch, clock)
    seqs = []
    for n in range(k):
        clock.t = 100.0 + 0.004 * n
        seqs.append(facade.try_submit(f"frame{n}"))
    assert seqs == [0] + [None] * (k - 1)
    clock.t = 100.020
    coord._tick()
    (seq, _stripes), = facade.poll()
    tr = facade.pop_trace(seq)
    latest = 100.0 + 0.004 * (k - 1)
    assert tr["superseded"] == (100.0, latest)
    assert tr["pending"] == (latest, 100.020)
    assert tr["dispatch"] == (100.020, 100.030)
    assert tr["harvest_lag"] == (100.030, 100.030)
    assert tr["fetch_wait"][0] == 100.030
    assert "device" not in tr and "device_tail" not in tr
    # the next run starts at its own first submit
    clock.t = 100.050
    assert facade.try_submit("frame") == 1
    clock.t = 100.060
    coord._tick()
    facade.poll()
    assert facade.pop_trace(1)["superseded"] == (100.050, 100.050)


@pytest.mark.parametrize("finish,tail,lag", [
    # the card finished during the launch: no tail
    (0.005, (100.030, 100.030), (100.030, 100.040)),
    # the card finished after the launch, before the harvest
    (0.034, (100.030, 100.034), (100.034, 100.040)),
    # the card still worked when the harvest began (it waits in fetch_wait)
    (0.055, (100.030, 100.040), (100.040, 100.040)),
], ids=["during", "after", "past-harvest"])
def test_device_interval_moves_harvest_lag(monkeypatch, finish, tail, lag):
    clock = _Clock()
    coord, facade = _coord(
        monkeypatch, clock, device=lambda c: (100.021, 100.0 + finish))
    lane = coord.lanes[0]
    lane.enc.fetch_ready = lambda pending: False
    clock.t = 100.0
    facade.try_submit("frame")
    # dispatch at 100.020-100.030, left in flight; the harvest at 100.040
    clock.t = 100.020
    coord._tick()
    assert not facade.poll()
    clock.t = 100.040
    coord._harvest_oldest(lane)
    (seq, _stripes), = facade.poll()
    tr = facade.pop_trace(seq)
    assert tr["dispatch"] == (100.020, 100.030)
    assert tr["device"] == (100.021, 100.0 + finish)
    assert tr["device_tail"] == pytest.approx(tail)
    assert tr["harvest_lag"] == pytest.approx(lag)
    assert tr["fetch_wait"][0] == 100.040


def test_the_port_encoders_stamp_no_device_interval_on_the_cpu():
    import numpy as np

    from selkies_tpu_torch.parallel import (MeshStripeEncoder,
                                            parse_mesh_spec)

    enc = MeshStripeEncoder(parse_mesh_spec("session:1", ["cpu"]), 2, 64, 32,
                            stripe_h=16)
    p = enc.dispatch([np.zeros((32, 64, 3), np.uint8), None])
    enc.harvest(p)
    assert enc.device_interval(p) is None


def test_refused_submits_are_the_jax_coordinators():
    """The same script of submits and ticks through both coordinators'
    facades: each submit is accepted (with its seq) or refused alike, so
    the capture loop closes the same spans ``dropped@submit``."""
    script = "ssTsTsssTTsTssssT"

    def drive(mod, rob):
        coord = mod.MeshEncodeCoordinator(
            "session:1", 2, 64, 48, slots_per_lane=2, max_lanes=1,
            enc_factory=lambda n: rob.FakeMeshEncoder(n))
        coord.stop()
        facade = coord.acquire(64, 48)
        coord.stop()
        got = []
        for op in script:
            if op == "s":
                got.append(facade.try_submit("frame"))
            else:
                coord._tick()
                got.append([seq for seq, _ in facade.poll()])
        return got

    port = drive(tcoord, trob)
    assert port == drive(jcoord, jrob)
    assert None in port


def test_solo_spans_hand_off_from_their_harvest_to_the_offer():
    """The port's solo pipeline (no lane): an ACKed span's ``handoff`` runs
    from the end of its ``pack`` to the start of its ``queue``, the same
    rule as a lane frame's."""
    rec = _serve(frames=8, env={})
    acked = [t for t in rec._completed() if t.terminal == "acked"]
    assert len(acked) >= 8
    for t in acked:
        assert "superseded" not in t.spans and "harvest_lag" not in t.spans
        assert t.spans["handoff"] == (t.spans["pack"][1],
                                      t.spans["queue"][0]), t.spans
