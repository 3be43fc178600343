"""The port's WebRTC session plumbing (``selkies_tpu_torch/rtc``) against
the JAX package's: every case of ``tests/test_rtc.py`` (TURN credentials,
the RTC config round trip and its monitors, the signaling relay, client
and server, the duplicate uid, the HTTP endpoints, basic auth, rooms, the
files plane with its hostile names, the turn-rest service) runs against
the port's copies, and the TURN helpers give the JAX package's results."""

import sys
import types

import pytest

from torch_port_cases import case_names, load_cases, run_case

pytest.importorskip("jax")
pytest.importorskip("websockets")

from selkies_tpu import rtc as jrtc  # noqa: E402
from selkies_tpu_torch import rtc as trtc  # noqa: E402
from selkies_tpu_torch.rtc import turn as tturn  # noqa: E402

#: every case of test_rtc.py
PORTED = {
    "test_hmac_credentials_verify", "test_hmac_credentials_sanitizes_colons",
    "test_rtc_config_roundtrip", "test_parse_rtc_config_escapes_special_chars",
    "test_hmac_monitor_fires_immediately", "test_file_monitor_detects_change",
    "test_signaling_session_relay", "test_signaling_rejects_duplicate_uid",
    "test_signaling_http_endpoints", "test_signaling_basic_auth",
    "test_signaling_rooms", "test_files_download_plane",
    "test_files_plane_hostile_names", "test_turn_rest_service",
}

# the port's names under the import the cases make
_names = types.ModuleType("_torch_rtc_names")
for _n in ("build_rtc_config", "generate_rtc_config", "hmac_credentials",
           "parse_rtc_config", "SignalingServer", "HMACRTCMonitor",
           "RTCConfigFileMonitor", "SignalingClient"):
    setattr(_names, _n, getattr(trtc, _n))
sys.modules["_torch_rtc_names"] = _names

JAX_CASES = load_cases("test_rtc.py", port=False)
PORT_CASES = load_cases("test_rtc.py", port=True, replace=[
    ("from selkies_tpu.rtc import (", "from _torch_rtc_names import ("),
])


def test_ported_cases_exist():
    assert PORTED == set(case_names(JAX_CASES))
    assert PORT_CASES.SignalingServer is trtc.SignalingServer
    assert PORT_CASES.SignalingClient is trtc.SignalingClient
    assert PORT_CASES.HMACRTCMonitor is trtc.HMACRTCMonitor
    from selkies_tpu_torch.rtc.turn_rest import TurnRestService

    assert PORT_CASES.TurnRestService is TurnRestService


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
    assert trtc.__all__ == jrtc.__all__
