"""turn-rest: a tiny HTTP service minting time-limited coturn HMAC
credentials as browser-shaped RTC config JSON.

Parity with ``addons/turn-rest/app.py`` (Flask in the reference; aiohttp
here — Flask is not in this image and an async server matches the rest of
the framework). Same request contract:

  GET/POST /  with  ?username=&protocol=&tls=  or headers
  ``x-auth-user`` / ``x-turn-username``, ``x-turn-protocol``, ``x-turn-tls``
  → RTC config JSON carrying ``exp:user`` + HMAC-SHA1 credential.
"""

from __future__ import annotations

import os
from typing import Optional

from aiohttp import web

from .turn import build_rtc_config, hmac_credentials


class TurnRestService:
    def __init__(
        self,
        shared_secret: Optional[str] = None,
        turn_host: Optional[str] = None,
        turn_port: Optional[str] = None,
        stun_host: Optional[str] = None,
        stun_port: Optional[str] = None,
        turn_protocol: Optional[str] = None,
        turn_tls: Optional[str] = None,
        ttl_seconds: int = 86400,
    ):
        env = os.environ.get
        self.shared_secret = shared_secret or env("TURN_SHARED_SECRET", "changeme")
        self.turn_host = (turn_host or env("TURN_HOST", "localhost")).lower()
        self.turn_port = turn_port or env("TURN_PORT", "3478")
        if not str(self.turn_port).isdigit():
            self.turn_port = "3478"
        self.stun_host = (stun_host or env("STUN_HOST", self.turn_host)).lower()
        self.stun_port = stun_port or env("STUN_PORT", self.turn_port)
        if not str(self.stun_port).isdigit():
            self.stun_host, self.stun_port = "stun.l.google.com", "19302"
        self.turn_protocol_default = turn_protocol or env("TURN_PROTOCOL", "udp")
        self.turn_tls_default = turn_tls or env("TURN_TLS", "false")
        self.ttl_seconds = ttl_seconds

    async def handle(self, request: web.Request) -> web.Response:
        values = dict(request.query)
        if request.method == "POST":
            try:
                values.update(dict(await request.post()))
            except Exception:
                pass
        headers = request.headers

        user = (
            values.get("username")
            or headers.get("x-auth-user")
            or headers.get("x-turn-username")
            or "turn-rest"
        ).lower()
        protocol = (
            values.get("protocol") or headers.get("x-turn-protocol") or self.turn_protocol_default
        )
        protocol = "tcp" if protocol.lower() == "tcp" else "udp"
        tls_raw = values.get("tls") or headers.get("x-turn-tls") or self.turn_tls_default
        turn_tls = str(tls_raw).lower() == "true"

        creds = hmac_credentials(self.shared_secret, user, self.ttl_seconds)
        body = build_rtc_config(
            self.turn_host,
            self.turn_port,
            creds,
            protocol,
            turn_tls,
            self.stun_host,
            self.stun_port,
            self.ttl_seconds,
        )
        return web.Response(text=body, content_type="application/json")

    def make_app(self) -> web.Application:
        app = web.Application()
        app.router.add_route("GET", "/", self.handle)
        app.router.add_route("POST", "/", self.handle)
        return app

    async def start(self, host: str = "0.0.0.0", port: int = 8008) -> web.AppRunner:
        runner = web.AppRunner(self.make_app())
        await runner.setup()
        site = web.TCPSite(runner, host, port)
        await site.start()
        return runner


def main() -> None:  # pragma: no cover - console entry
    web.run_app(TurnRestService().make_app(), host="0.0.0.0", port=int(os.environ.get("PORT", "8008")))


if __name__ == "__main__":  # pragma: no cover
    main()
