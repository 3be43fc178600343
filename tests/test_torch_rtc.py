"""The port's web plane (``selkies_tpu_torch/rtc``: ``turn.py`` and
``signaling.py``) against the JAX package's: the cases of
``tests/test_rtc.py`` for TURN credentials, the RTC config round trip,
the signaling relay, the duplicate uid, the HTTP endpoints, basic auth,
rooms and the files plane with its hostile names run against the port's
copies (the JAX package's signaling client talks to the port's server).
The RTC config monitors and the turn-rest service belong to the WebRTC
mode, which is not ported yet, and their cases wait for it."""

import sys
import types

import pytest

from torch_port_cases import case_names, load_cases, run_case

pytest.importorskip("jax")
pytest.importorskip("websockets")

from selkies_tpu import rtc as jrtc  # noqa: E402
from selkies_tpu_torch import rtc as trtc  # noqa: E402
from selkies_tpu_torch.rtc import turn as tturn  # noqa: E402

#: the cases of test_rtc.py this slice ports (the rest need the monitors,
#: the signaling client's WebRTC side or turn_rest)
PORTED = {
    "test_hmac_credentials_verify", "test_hmac_credentials_sanitizes_colons",
    "test_rtc_config_roundtrip", "test_parse_rtc_config_escapes_special_chars",
    "test_signaling_session_relay", "test_signaling_rejects_duplicate_uid",
    "test_signaling_http_endpoints", "test_signaling_basic_auth",
    "test_signaling_rooms", "test_files_download_plane",
    "test_files_plane_hostile_names",
}

# the port's turn/signaling names under the import the cases make; the
# WebRTC-mode names stay the JAX package's (the client drives the server)
_names = types.ModuleType("_torch_rtc_names")
for _n in ("build_rtc_config", "generate_rtc_config", "hmac_credentials",
           "parse_rtc_config", "SignalingServer"):
    setattr(_names, _n, getattr(trtc, _n))
for _n in ("HMACRTCMonitor", "RTCConfigFileMonitor", "SignalingClient"):
    setattr(_names, _n, getattr(jrtc, _n))
sys.modules["_torch_rtc_names"] = _names

JAX_CASES = load_cases("test_rtc.py", port=False)
PORT_CASES = load_cases("test_rtc.py", port=True, replace=[
    ("from selkies_tpu.rtc import (", "from _torch_rtc_names import ("),
    ("from selkies_tpu.rtc.turn_rest import TurnRestService",
     "TurnRestService = None"),
])


def test_ported_cases_exist():
    assert PORTED <= set(case_names(JAX_CASES))
    assert PORT_CASES.SignalingServer is trtc.SignalingServer


@pytest.mark.parametrize("case", sorted(PORTED))
def test_rtc_case(case, tmp_path):
    run_case(PORT_CASES, case, {"tmp_path": tmp_path})


def test_turn_functions_equal_jax():
    from selkies_tpu.rtc import turn as jturn

    for secret, user, ttl, now in (("s3cret", "alice", 3600, 1_000_000),
                                   ("k", "a:b:c", 60, 5),
                                   ("", "", 0, 0)):
        assert vars(tturn.hmac_credentials(
            secret, user, ttl_seconds=ttl, now=now)) == vars(
                jturn.hmac_credentials(secret, user, ttl_seconds=ttl,
                                       now=now))
    for host, port, proto, tls in (("turn.example.com", 3478, "udp", False),
                                   ("10.0.0.1", 443, "tcp", True)):
        creds = jturn.hmac_credentials("x", "u", now=7)
        cfg_t = tturn.build_rtc_config(host, port, creds, protocol=proto,
                                       turn_tls=tls)
        assert cfg_t == jturn.build_rtc_config(host, port, creds,
                                               protocol=proto, turn_tls=tls)
        assert tturn.parse_rtc_config(cfg_t) == jturn.parse_rtc_config(cfg_t)
    assert tturn.DEFAULT_RTC_CONFIG == jturn.DEFAULT_RTC_CONFIG
    assert sorted(trtc.__all__) == sorted(
        n for n in jrtc.__all__ if hasattr(trtc, n))
