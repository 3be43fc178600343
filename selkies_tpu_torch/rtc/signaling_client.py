"""In-process signaling client (gst-examples grammar).

Parity: ``legacy/webrtc_signalling.py`` — HELLO registration, SESSION
setup, JSON ``{"sdp": ...}`` / ``{"ice": ...}`` relay, callback surface
(`on_connect`, `on_session`, `on_sdp`, `on_ice`, `on_error`,
`on_disconnect`).
"""

from __future__ import annotations

import asyncio
import base64
import json
import logging
import ssl
from typing import Awaitable, Callable, Optional, Union

import websockets
import websockets.asyncio.client

logger = logging.getLogger("selkies_tpu_torch.rtc.signaling_client")

MaybeAsync = Union[None, Awaitable[None]]


class SignalingError(Exception):
    pass


class SignalingNoPeerError(SignalingError):
    pass


async def _call(cb: Optional[Callable], *args) -> None:
    if cb is None:
        return
    result = cb(*args)
    if asyncio.iscoroutine(result):
        await result


class SignalingClient:
    def __init__(
        self,
        server: str,
        uid: str,
        peer_id: Optional[str] = None,
        meta: Optional[dict] = None,
        enable_https: bool = False,
        basic_auth_user: Optional[str] = None,
        basic_auth_password: Optional[str] = None,
        retry_interval: float = 2.0,
    ):
        self.server = server
        self.uid = str(uid)
        self.peer_id = str(peer_id) if peer_id is not None else None
        self.meta = meta
        self.enable_https = enable_https
        self.basic_auth_user = basic_auth_user
        self.basic_auth_password = basic_auth_password
        self.retry_interval = retry_interval
        self.conn = None

        self.on_connect: Optional[Callable[[], MaybeAsync]] = None
        self.on_disconnect: Optional[Callable[[], MaybeAsync]] = None
        self.on_session: Optional[Callable[[Optional[str], dict], MaybeAsync]] = None
        self.on_sdp: Optional[Callable[[str, str], MaybeAsync]] = None
        self.on_ice: Optional[Callable[[int, str], MaybeAsync]] = None
        self.on_error: Optional[Callable[[Exception], MaybeAsync]] = None

    async def connect(self) -> None:
        sslctx = None
        if self.enable_https:
            sslctx = ssl.create_default_context(purpose=ssl.Purpose.SERVER_AUTH)
            sslctx.check_hostname = False
            sslctx.verify_mode = ssl.CERT_NONE
        headers = None
        if self.basic_auth_user is not None:
            auth64 = base64.b64encode(
                f"{self.basic_auth_user}:{self.basic_auth_password or ''}".encode()
            ).decode()
            headers = [("Authorization", f"Basic {auth64}")]
        while True:
            try:
                self.conn = await websockets.asyncio.client.connect(
                    self.server, additional_headers=headers, ssl=sslctx
                )
                break
            except ConnectionRefusedError:
                await asyncio.sleep(self.retry_interval)
        hello = f"HELLO {self.uid}"
        if self.meta:
            hello += " " + base64.b64encode(json.dumps(self.meta).encode()).decode()
        await self.conn.send(hello)

    async def setup_call(self) -> None:
        await self.conn.send(f"SESSION {self.peer_id}")

    async def send_sdp(self, sdp_type: str, sdp: str) -> None:
        await self.conn.send(json.dumps({"sdp": {"type": sdp_type, "sdp": sdp}}))

    async def send_ice(self, mlineindex: int, candidate: str) -> None:
        await self.conn.send(
            json.dumps({"ice": {"candidate": candidate, "sdpMLineIndex": mlineindex}})
        )

    async def send_raw(self, msg: str) -> None:
        await self.conn.send(msg)

    async def stop(self) -> None:
        if self.conn is not None:
            await self.conn.close()

    async def start(self) -> None:
        try:
            async for message in self.conn:
                await self._dispatch(message)
        except websockets.exceptions.ConnectionClosed:
            pass
        await _call(self.on_disconnect)

    async def _dispatch(self, message: str) -> None:
        if message == "HELLO":
            await _call(self.on_connect)
        elif message.startswith("SESSION_OK"):
            toks = message.split()
            meta = json.loads(base64.b64decode(toks[1])) if len(toks) > 1 else {}
            await _call(self.on_session, self.peer_id, meta)
        elif message.startswith("ERROR"):
            if "not found" in message:
                await _call(self.on_error, SignalingNoPeerError(message))
            else:
                await _call(self.on_error, SignalingError(message))
        else:
            try:
                data = json.loads(message)
            except json.JSONDecodeError:
                await _call(self.on_error, SignalingError(f"bad JSON: {message!r}"))
                return
            if data.get("sdp"):
                await _call(self.on_sdp, data["sdp"].get("type"), data["sdp"].get("sdp"))
            elif data.get("ice"):
                await _call(
                    self.on_ice, data["ice"].get("sdpMLineIndex"), data["ice"].get("candidate")
                )
            else:
                await _call(self.on_error, SignalingError(f"unhandled message: {message!r}"))
