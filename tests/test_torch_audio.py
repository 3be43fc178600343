"""The port's audio plane (``selkies_tpu_torch/audio`` and its own
``native/audio.cpp``) against the JAX package's: every case of
``tests/test_audio.py`` runs on the port's ``audio/``, skipped exactly
where the JAX case skips (no libopus), and the port's server starts and
stops the audio pipeline and routes 0x02 microphone chunks as the JAX
server does."""

import asyncio
import json
import time

import numpy as np
import pytest

from torch_port_cases import case_names, load_cases, run_case

pytest.importorskip("jax")

from selkies_tpu import robustness as jrob  # noqa: E402
from selkies_tpu.audio import codec as jcodec  # noqa: E402
from selkies_tpu.server import data_server as jds  # noqa: E402
from selkies_tpu.settings import Settings as JSettings  # noqa: E402
from selkies_tpu_torch import robustness as trob  # noqa: E402
from selkies_tpu_torch.audio import codec as tcodec  # noqa: E402
from selkies_tpu_torch.server import data_server as tds  # noqa: E402
from selkies_tpu_torch.settings import Settings as TSettings  # noqa: E402

JAX_CASES = load_cases("test_audio.py", port=False)
PORT_CASES = load_cases("test_audio.py", port=True)


def _jax_skip_reason():
    """The JAX module's own skip condition, evaluated as it evaluates it."""
    marks = getattr(JAX_CASES, "pytestmark", [])
    for mark in marks if isinstance(marks, list) else [marks]:
        if mark.name == "skipif" and mark.args[0]:
            return mark.kwargs.get("reason", "skipped")
    return None


@pytest.mark.parametrize("case", case_names(JAX_CASES))
def test_audio_case(case):
    reason = _jax_skip_reason()
    if reason is not None:
        pytest.skip(reason)
    run_case(PORT_CASES, case, {})


def test_runtime_availability_equals_jax():
    assert tcodec.opus_available() == jcodec.opus_available()
    assert tcodec.pulse_available() == jcodec.pulse_available()


def test_port_builds_its_own_audio_runtime():
    from selkies_tpu_torch.native import audio_lib

    lib = audio_lib()
    if lib is None:
        pytest.skip("g++ or libdl unavailable")
    assert "build/torch_kernels/libaudio_host_" in lib._name


def test_opus_packets_equal_jax():
    """Both runtimes wrap the same libopus: the same PCM gives the same
    packets and the same decoded samples."""
    if not jcodec.opus_available():
        pytest.skip("libopus unavailable")
    rng = np.random.default_rng(3)
    pcm = (rng.standard_normal(960 * 2 * 5) * 3000).astype(np.int16)
    out = []
    for mod in (jcodec, tcodec):
        enc = mod.OpusEncoder(bitrate=128000)
        dec = mod.OpusDecoder()
        pkts = [enc.encode(pcm[k * 1920:(k + 1) * 1920]) for k in range(5)]
        out.append((pkts, [dec.decode(p).tobytes() for p in pkts]))
        enc.close()
        dec.close()
    assert out[0] == out[1]


class FakeAudioPipeline:
    """Records the server's hand-offs (start/stop/close/mic data)."""

    def __init__(self, log):
        self.log = log
        self.running = False

    async def start(self):
        self.log.append("start")
        self.running = True

    async def stop(self):
        self.log.append("stop")
        self.running = False

    def close(self):
        self.log.append("close")

    async def on_mic_data(self, data):
        self.log.append(("mic", bytes(data)))


class _NoEncoder:
    def try_submit(self, frame):
        return None

    submit = try_submit

    def poll(self):
        return []

    def flush(self):
        return []

    def close(self):
        pass


async def _audio_scenario(ds, settings_cls, rob, device):
    settings = settings_cls(argv=[], env={"SELKIES_PORT": "0"})
    kw = {"device": device} if device else {}
    server = ds.DataStreamingServer(
        settings, encoder_factory=lambda *a, **k: _NoEncoder(),
        source_factory=lambda *a, **k: None, host="127.0.0.1", **kw)
    log = []
    server.audio_pipeline = FakeAudioPipeline(log)
    ws = rob.InProcessClient()
    task = asyncio.create_task(server.ws_handler(ws))
    deadline = time.monotonic() + 5.0
    while len(ws.sent) < 2 and time.monotonic() < deadline:
        await asyncio.sleep(0.01)
    for msg in ["STOP_AUDIO", b"\x02" + b"\x01\x00" * 240, "START_AUDIO",
                b"\x02" + b"\x05\x00" * 16]:
        ws.feed(msg)
        await asyncio.sleep(0.05)
    texts = [t for t in ws.texts() if t.startswith("AUDIO_")]
    await ws.close()
    await asyncio.wait_for(task, 5.0)
    log.append("left")
    await server.stop()
    return log, texts


def test_server_audio_hand_offs_equal_jax():
    jax = asyncio.run(_audio_scenario(jds, JSettings, jrob, None))
    port = asyncio.run(_audio_scenario(tds, TSettings, trob, "cpu"))
    assert port == jax
    log, texts = port
    # the first client starts it, STOP/START_AUDIO stop and start it, the
    # mic chunks reach it whatever its state, the last client's leaving
    # stops it, and the server's stop stops and closes it
    assert log == ["start", "stop", ("mic", b"\x01\x00" * 240), "start",
                   ("mic", b"\x05\x00" * 16), "stop", "left", "stop",
                   "close"]
    assert texts == ["AUDIO_STOPPED", "AUDIO_STARTED"]


def test_main_wires_audio_only_when_enabled_and_opus_loads(monkeypatch):
    from selkies_tpu_torch import audio
    from selkies_tpu_torch.server import main as tmain

    def wired(enabled, opus):
        monkeypatch.setattr(audio, "opus_available", lambda: opus)
        server = tds.DataStreamingServer(TSettings(argv=[], env={
            "SELKIES_PORT": "0"}), device="cpu")
        settings = TSettings(argv=[], env={
            "SELKIES_AUDIO_ENABLED": "true" if enabled else "false"})
        tmain._wire_audio(settings, server)
        return server.audio_pipeline

    assert wired(False, True) is None
    assert wired(True, False) is None
    assert isinstance(wired(True, True), audio.AudioPipeline)
