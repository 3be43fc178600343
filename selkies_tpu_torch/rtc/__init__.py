"""The port's copy of the websocket mode's HTTP plane (from
``selkies_tpu/rtc``): TURN credentials and RTC config (``turn.py``) and
the combined static web + ``/turn`` + ``/health`` + ``/files`` +
signaling server (``signaling.py``). The RTC config monitors, the
signaling client and the turn-rest service belong to the WebRTC mode and
are not ported yet."""

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
from .signaling import SignalingServer

__all__ = [
    "DEFAULT_RTC_CONFIG",
    "TurnCredentials",
    "build_rtc_config",
    "fetch_cloudflare_turn",
    "fetch_turn_rest",
    "generate_rtc_config",
    "hmac_credentials",
    "parse_rtc_config",
    "SignalingServer",
]
