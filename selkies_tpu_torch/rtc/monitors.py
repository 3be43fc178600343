"""Periodic RTC-config sources.

Each monitor owns one way of obtaining an RTC config (local HMAC minting, a
turn-rest endpoint, a JSON file on disk) and invokes
``on_rtc_config(stun_servers, turn_servers, rtc_config_json)`` whenever a
fresh config is available.

Parity: ``legacy/webrtc.py:62-185`` (HMACRTCMonitor / RESTRTCMonitor /
RTCConfigFileMonitor). Design differences from the reference, on purpose:

  * the reference busy-polls ``time.time() % period == 0`` every 0.5 s;
    we sleep the period directly and fire immediately on start so consumers
    have a config before the first session.
  * the file monitor uses mtime polling instead of a watchdog observer
    (no inotify dependency; 1 s resolution is ample for a config file).
"""

from __future__ import annotations

import asyncio
import logging
import os
from typing import Awaitable, Callable, List, Optional, Union

from .turn import fetch_turn_rest, generate_rtc_config, parse_rtc_config

logger = logging.getLogger("selkies_tpu_torch.rtc.monitors")

RTCConfigCallback = Callable[[List[str], List[str], str], Union[None, Awaitable[None]]]


async def _emit(cb: Optional[RTCConfigCallback], stun, turn, cfg) -> None:
    if cb is None:
        logger.warning("unhandled on_rtc_config")
        return
    result = cb(stun, turn, cfg)
    if asyncio.iscoroutine(result):
        await result


class _PeriodicMonitor:
    """Shared run loop: produce a config now, then every ``period`` seconds."""

    def __init__(self, period: float = 60.0, enabled: bool = True):
        self.period = period
        self.enabled = enabled
        self.running = False
        self.on_rtc_config: Optional[RTCConfigCallback] = None

    async def _produce(self):  # -> (stun_uris, turn_uris, rtc_config_json)
        raise NotImplementedError

    async def start(self) -> None:
        if not self.enabled:
            return
        self.running = True
        while self.running:
            try:
                stun, turn, cfg = await self._produce()
                await _emit(self.on_rtc_config, stun, turn, cfg)
            except Exception as exc:
                logger.warning("RTC config monitor fetch failed: %s", exc)
            # sleep in small slices so stop() takes effect promptly
            remaining = self.period
            while self.running and remaining > 0:
                step = min(0.25, remaining)
                await asyncio.sleep(step)
                remaining -= step

    async def stop(self) -> None:
        self.running = False


class HMACRTCMonitor(_PeriodicMonitor):
    """Re-mints coturn HMAC credentials locally on a timer."""

    def __init__(
        self,
        turn_host: str,
        turn_port,
        turn_shared_secret: str,
        turn_username: str,
        turn_protocol: str = "udp",
        turn_tls: bool = False,
        stun_host: Optional[str] = None,
        stun_port=None,
        period: float = 60.0,
        enabled: bool = True,
    ):
        super().__init__(period, enabled)
        self.turn_host = turn_host
        self.turn_port = turn_port
        self.turn_shared_secret = turn_shared_secret
        self.turn_username = turn_username
        self.turn_protocol = turn_protocol
        self.turn_tls = turn_tls
        self.stun_host = stun_host
        self.stun_port = stun_port

    async def _produce(self):
        cfg = generate_rtc_config(
            self.turn_host,
            self.turn_port,
            self.turn_shared_secret,
            self.turn_username,
            self.turn_protocol,
            self.turn_tls,
            self.stun_host,
            self.stun_port,
        )
        return parse_rtc_config(cfg)


class RESTRTCMonitor(_PeriodicMonitor):
    """Polls a turn-rest endpoint for fresh credentials."""

    def __init__(
        self,
        turn_rest_uri: str,
        turn_rest_username: str,
        turn_rest_username_auth_header: str = "x-auth-user",
        turn_protocol: str = "udp",
        turn_rest_protocol_header: str = "x-turn-protocol",
        turn_tls: bool = False,
        turn_rest_tls_header: str = "x-turn-tls",
        period: float = 60.0,
        enabled: bool = True,
    ):
        super().__init__(period, enabled)
        self.turn_rest_uri = turn_rest_uri
        self.turn_rest_username = turn_rest_username.replace(":", "-")
        self.turn_rest_username_auth_header = turn_rest_username_auth_header
        self.turn_protocol = turn_protocol
        self.turn_rest_protocol_header = turn_rest_protocol_header
        self.turn_tls = turn_tls
        self.turn_rest_tls_header = turn_rest_tls_header

    async def _produce(self):
        return await asyncio.to_thread(
            fetch_turn_rest,
            self.turn_rest_uri,
            self.turn_rest_username,
            self.turn_rest_username_auth_header,
            self.turn_protocol,
            self.turn_rest_protocol_header,
            self.turn_tls,
            self.turn_rest_tls_header,
        )


class RTCConfigFileMonitor:
    """Watches an RTC-config JSON file by mtime; fires on start and on change."""

    def __init__(self, rtc_file: str, enabled: bool = True, poll_interval: float = 1.0):
        self.rtc_file = rtc_file
        self.enabled = enabled
        self.poll_interval = poll_interval
        self.running = False
        self.on_rtc_config: Optional[RTCConfigCallback] = None
        self._last_mtime: Optional[float] = None

    async def _read_and_emit(self) -> None:
        try:
            with open(self.rtc_file, "rb") as f:
                data = f.read()
            stun, turn, cfg = parse_rtc_config(data)
        except Exception as exc:
            logger.warning("could not read RTC config file %s: %s", self.rtc_file, exc)
            return
        await _emit(self.on_rtc_config, stun, turn, cfg)

    async def start(self) -> None:
        if not self.enabled:
            return
        self.running = True
        while self.running:
            try:
                mtime = os.stat(self.rtc_file).st_mtime
            except OSError:
                mtime = None
            if mtime is not None and mtime != self._last_mtime:
                self._last_mtime = mtime
                await self._read_and_emit()
            await asyncio.sleep(self.poll_interval)

    async def stop(self) -> None:
        self.running = False
