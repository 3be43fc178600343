"""TURN/STUN credential generation and RTC-config handling.

Behavioral parity with the reference (cited, not copied):
  - HMAC time-limited credentials per the coturn ``--use-auth-secret``
    scheme (``legacy/signalling_web.py:51-85``, ``addons/turn-rest/app.py``):
    username is ``"<unix-expiry>:<user>"``, password is
    base64(HMAC-SHA1(shared_secret, username)).
  - RTC config JSON shape consumed by browsers and by ``parse_rtc_config``
    (``legacy/webrtc.py:187-266``): ``iceServers`` with a STUN url list and
    one TURN entry carrying username/credential.
  - REST fetcher headers ``x-auth-user`` / ``x-turn-protocol`` /
    ``x-turn-tls`` (``legacy/webrtc.py:227-264``).
  - Cloudflare TURN credential endpoint (``legacy/webrtc.py:266-290``).
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import http.client
import json
import time
import urllib.parse
from dataclasses import dataclass
from typing import List, Optional, Tuple

GOOGLE_STUN = ("stun.l.google.com", "19302")

DEFAULT_RTC_CONFIG = json.dumps(
    {
        "lifetimeDuration": "86400s",
        "iceServers": [{"urls": ["stun:%s:%s" % GOOGLE_STUN]}],
        "blockStatus": "NOT_BLOCKED",
        "iceTransportPolicy": "all",
    },
    indent=2,
)


@dataclass(frozen=True)
class TurnCredentials:
    """A minted time-limited TURN credential pair."""

    username: str
    password: str
    expires_at: int


def hmac_credentials(
    shared_secret: str, user: str, ttl_seconds: int = 86400, now: Optional[float] = None
) -> TurnCredentials:
    """Mint coturn REST-API credentials: ``exp:user`` + b64(HMAC-SHA1)."""
    user = user.replace(":", "-")
    exp = int(now if now is not None else time.time()) + ttl_seconds
    username = f"{exp}:{user}"
    digest = hmac.new(shared_secret.encode(), username.encode(), hashlib.sha1).digest()
    return TurnCredentials(username, base64.b64encode(digest).decode(), exp)


def _stun_url_list(turn_host: str, turn_port, stun_host=None, stun_port=None) -> List[str]:
    """STUN list: optional distinct STUN host first, TURN host, Google fallback."""
    urls = [f"stun:{turn_host}:{turn_port}"]
    if stun_host and stun_port and (stun_host != turn_host or str(stun_port) != str(turn_port)):
        urls.insert(0, f"stun:{stun_host}:{stun_port}")
    if (stun_host, str(stun_port)) != GOOGLE_STUN:
        urls.append("stun:%s:%s" % GOOGLE_STUN)
    return urls


def build_rtc_config(
    turn_host: str,
    turn_port,
    creds: TurnCredentials,
    protocol: str = "udp",
    turn_tls: bool = False,
    stun_host: Optional[str] = None,
    stun_port=None,
    ttl_seconds: int = 86400,
) -> str:
    """Browser-shaped RTCConfiguration JSON with one STUN and one TURN entry."""
    scheme = "turns" if turn_tls else "turn"
    cfg = {
        "lifetimeDuration": f"{ttl_seconds}s",
        "blockStatus": "NOT_BLOCKED",
        "iceTransportPolicy": "all",
        "iceServers": [
            {"urls": _stun_url_list(turn_host, turn_port, stun_host, stun_port)},
            {
                "urls": [f"{scheme}:{turn_host}:{turn_port}?transport={protocol}"],
                "username": creds.username,
                "credential": creds.password,
            },
        ],
    }
    return json.dumps(cfg, indent=2)


def generate_rtc_config(
    turn_host: str,
    turn_port,
    shared_secret: str,
    user: str,
    protocol: str = "udp",
    turn_tls: bool = False,
    stun_host: Optional[str] = None,
    stun_port=None,
) -> str:
    """Mint HMAC credentials and wrap them in RTC config JSON
    (reference ``signalling_web.py:51``)."""
    creds = hmac_credentials(shared_secret, user)
    return build_rtc_config(
        turn_host, turn_port, creds, protocol, turn_tls, stun_host, stun_port
    )


def parse_rtc_config(data) -> Tuple[List[str], List[str], str]:
    """Extract ``stun://`` and ``turn(s)://user:pass@host:port`` URI lists
    from RTC config JSON (reference ``legacy/webrtc.py:187``)."""
    if isinstance(data, bytes):
        data = data.decode()
    stun_uris: List[str] = []
    turn_uris: List[str] = []
    for server in json.loads(data).get("iceServers", []):
        for url in server.get("urls", []):
            scheme, _, rest = url.partition(":")
            host, _, port_q = rest.partition(":")
            port = port_q.split("?")[0]
            if scheme == "stun":
                stun_uris.append(f"stun://{host}:{port}")
            elif scheme in ("turn", "turns"):
                user = urllib.parse.quote(server["username"], safe="")
                cred = urllib.parse.quote(server["credential"], safe="")
                turn_uris.append(f"{scheme}://{user}:{cred}@{host}:{port}")
    return stun_uris, turn_uris, data


def fetch_turn_rest(
    uri: str,
    user: str,
    auth_header_username: str = "x-auth-user",
    protocol: str = "udp",
    header_protocol: str = "x-turn-protocol",
    turn_tls: bool = False,
    header_tls: str = "x-turn-tls",
    timeout: float = 10.0,
) -> Tuple[List[str], List[str], str]:
    """GET an RTC config from a turn-rest service, identifying via headers."""
    parsed = urllib.parse.urlparse(uri)
    conn_cls = (
        http.client.HTTPSConnection if parsed.scheme == "https" else http.client.HTTPConnection
    )
    conn = conn_cls(parsed.netloc, timeout=timeout)
    request_path = (parsed.path or "/") + (f"?{parsed.query}" if parsed.query else "")
    try:
        conn.request(
            "GET",
            request_path,
            headers={
                auth_header_username: user,
                header_protocol: protocol,
                header_tls: "true" if turn_tls else "false",
            },
        )
        resp = conn.getresponse()
        body = resp.read()
        if resp.status >= 400:
            raise RuntimeError(f"turn-rest fetch failed: {resp.status} {resp.reason}")
    finally:
        conn.close()
    if not body:
        raise RuntimeError("turn-rest returned an empty body")
    return parse_rtc_config(body)


def fetch_cloudflare_turn(turn_token_id: str, api_token: str, ttl: int = 86400, timeout: float = 10.0) -> dict:
    """POST to the Cloudflare Calls credential generator
    (reference ``legacy/webrtc.py:266``)."""
    host = "rtc.live.cloudflare.com"
    path = f"/v1/turn/keys/{turn_token_id}/credentials/generate"
    conn = http.client.HTTPSConnection(host, timeout=timeout)
    try:
        conn.request(
            "POST",
            path,
            json.dumps({"ttl": ttl}),
            headers={
                "authorization": f"Bearer {api_token}",
                "content-type": "application/json",
            },
        )
        resp = conn.getresponse()
        body = resp.read()
        if resp.status >= 400:
            raise RuntimeError(f"cloudflare TURN fetch failed: {resp.status}")
    finally:
        conn.close()
    return json.loads(body)
