"""The port's copy of the WebRTC session plumbing (from
``selkies_tpu/rtc``): TURN credentials and RTC config (``turn.py``), the
RTC config monitors (``monitors.py``), the combined static web +
``/turn`` + ``/health`` + ``/files`` + signaling server (``signaling.py``)
and its client (``signaling_client.py``). The turn-rest credential
service (``turn_rest.py``, on ``aiohttp``) is imported from its module."""

from .turn import (
    DEFAULT_RTC_CONFIG,
    TurnCredentials,
    build_rtc_config,
    fetch_cloudflare_turn,
    fetch_turn_rest,
    generate_rtc_config,
    hmac_credentials,
    parse_rtc_config,
)
from .monitors import HMACRTCMonitor, RESTRTCMonitor, RTCConfigFileMonitor
from .signaling import SignalingServer
from .signaling_client import SignalingClient, SignalingError, SignalingNoPeerError

__all__ = [
    "DEFAULT_RTC_CONFIG",
    "TurnCredentials",
    "build_rtc_config",
    "fetch_cloudflare_turn",
    "fetch_turn_rest",
    "generate_rtc_config",
    "hmac_credentials",
    "parse_rtc_config",
    "HMACRTCMonitor",
    "RESTRTCMonitor",
    "RTCConfigFileMonitor",
    "SignalingServer",
    "SignalingClient",
    "SignalingError",
    "SignalingNoPeerError",
]
