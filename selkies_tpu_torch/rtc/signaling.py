"""Combined HTTP static-file + WebSocket signaling server.

Speaks the gst-examples signaling grammar the reference uses
(``legacy/signalling_web.py:326-520``):

  client → ``HELLO <uid> [meta_b64]``          register
  server → ``HELLO``                           ack
  client → ``SESSION <peer_id>``               request 1:1 session
  server → ``SESSION_OK [meta_b64]``           both peers now relay-only
  client → ``ROOM <room_id>`` /
           ``ROOM_PEER_MSG <peer> <msg>``      multi-party rooms
  server → ``ROOM_OK <peers>`` / ``ROOM_PEER_JOINED/LEFT <uid>``
  anything else inside a session is relayed verbatim to the paired peer.

HTTP side (same socket, via websockets' ``process_request``):
  ``/health``   liveness;  ``/turn``  RTC config JSON (HMAC-minted per
  request when a shared secret is set, else a static config);  any other
  path is served from ``web_root`` with path-traversal containment and
  optional basic auth — reference ``legacy/signalling_web.py:197-264``.
"""

from __future__ import annotations

import asyncio
import base64
import http
import json
import logging
import mimetypes
import os
from typing import Dict, Optional, Set, Tuple

import websockets
import websockets.asyncio.server
from websockets.datastructures import Headers
from websockets.http11 import Response

from .turn import generate_rtc_config

logger = logging.getLogger("selkies_tpu_torch.rtc.signaling")


class SignalingServer:
    #: whole-body Response API: bound what a single /files download pins
    MAX_DOWNLOAD_BYTES = 256 * 1024 * 1024

    def __init__(
        self,
        addr: str = "0.0.0.0",
        port: int = 8080,
        web_root: Optional[str] = None,
        health_path: str = "/health",
        keepalive_timeout: float = 30.0,
        enable_basic_auth: bool = False,
        basic_auth_user: str = "",
        basic_auth_password: str = "",
        turn_shared_secret: str = "",
        turn_host: str = "",
        turn_port: str = "",
        turn_protocol: str = "udp",
        turn_tls: bool = False,
        stun_host: Optional[str] = None,
        stun_port=None,
        turn_auth_header_name: str = "x-auth-user",
        rtc_config: Optional[str] = None,
        files_root: Optional[str] = None,
    ):
        self.addr = addr
        self.port = port
        self.web_root = os.path.realpath(web_root) if web_root else None
        #: downloadable-files tree (the reference dashboard's "Download
        #: Files" iframe points at ./files/ — legacy FILE_MANAGER_PATH)
        self.files_root = os.path.realpath(files_root) if files_root else None
        self.health_path = health_path.rstrip("/")
        self.keepalive_timeout = keepalive_timeout
        self.enable_basic_auth = enable_basic_auth
        self.basic_auth_user = basic_auth_user
        self.basic_auth_password = basic_auth_password
        self.turn_shared_secret = turn_shared_secret
        self.turn_host = turn_host
        self.turn_port = turn_port
        self.turn_protocol = turn_protocol
        self.turn_tls = turn_tls
        self.stun_host = stun_host
        self.stun_port = stun_port
        self.turn_auth_header_name = turn_auth_header_name
        self.rtc_config = rtc_config

        # uid -> (ws, status, meta); status: None | 'session' | room_id
        self.peers: Dict[str, list] = {}
        self.sessions: Dict[str, str] = {}
        self.rooms: Dict[str, Set[str]] = {}

        self.server = None
        self._stop: Optional[asyncio.Future] = None

    # ------------------------------------------------------------- HTTP

    @staticmethod
    def _response(status: http.HTTPStatus, body: bytes, headers: Optional[Headers] = None) -> Response:
        hdrs = Headers([("Connection", "close"), ("Content-Length", str(len(body)))])
        if headers is None or "Content-Type" not in headers:
            hdrs["Content-Type"] = "text/plain; charset=utf-8"
        if headers:
            for k, v in headers.raw_items():
                if k in hdrs:
                    del hdrs[k]
                hdrs[k] = v
        return Response(status.value, status.phrase, hdrs, body)

    def _check_basic_auth(self, request) -> bool:
        auth = request.headers.get("authorization", "")
        if not auth.lower().startswith("basic "):
            return False
        try:
            user, pw = base64.b64decode(auth.split(None, 1)[1]).decode().split(":", 1)
        except Exception:
            return False
        import hmac as hmac_mod

        return hmac_mod.compare_digest(
            user.encode(), self.basic_auth_user.encode()) \
            & hmac_mod.compare_digest(
                pw.encode(), self.basic_auth_password.encode())

    async def process_request(self, connection, request):
        path = request.path
        if self.enable_basic_auth and not self._check_basic_auth(request):
            hdrs = Headers()
            hdrs["WWW-Authenticate"] = 'Basic realm="restricted", charset="UTF-8"'
            return self._response(http.HTTPStatus.UNAUTHORIZED, b"Authorization required", hdrs)

        stripped = path.split("?")[0].rstrip("/")
        if stripped == "/ws" or stripped.endswith("/signalling"):
            return None  # proceed with the WebSocket upgrade

        if path.rstrip("/") == self.health_path:
            return self._response(http.HTTPStatus.OK, b"OK\n")

        if path.rstrip("/") == "/turn":
            return self._turn_response(request)

        if path.split("?")[0] == "/files" or path.split("?")[0].startswith("/files/"):
            return await asyncio.to_thread(self._files_response, path)

        # disk I/O off the event loop: a big asset read must not stall
        # concurrent SDP/ICE relays
        return await asyncio.to_thread(self._static_response, path)

    def _turn_response(self, request) -> Response:
        hdrs = Headers()
        hdrs["Content-Type"] = "application/json"
        if self.turn_shared_secret:
            user = request.headers.get(self.turn_auth_header_name, "") or "anonymous"
            body = generate_rtc_config(
                self.turn_host,
                self.turn_port,
                self.turn_shared_secret,
                user,
                self.turn_protocol,
                self.turn_tls,
                self.stun_host,
                self.stun_port,
            ).encode()
            return self._response(http.HTTPStatus.OK, body, hdrs)
        if self.rtc_config:
            cfg = self.rtc_config
            return self._response(
                http.HTTPStatus.OK, cfg.encode() if isinstance(cfg, str) else cfg, hdrs
            )
        return self._response(http.HTTPStatus.NOT_FOUND, b"404 NOT FOUND")

    def _files_response(self, path: str) -> Response:
        """File-download plane: directory listings + attachment serving
        from ``files_root`` (reference: dashboard "Download Files" iframe
        at ./files/, FILE_MANAGER_PATH at reference selkies.py:98-103)."""
        import html
        import urllib.parse

        if self.files_root is None:
            return self._response(http.HTTPStatus.NOT_FOUND,
                                  b"file downloads disabled")
        rel = urllib.parse.unquote(path.split("?")[0][len("/files"):])
        if "\x00" in rel:
            # realpath raises ValueError on embedded NULs; hostile paths
            # must 404, not 500
            return self._response(http.HTTPStatus.NOT_FOUND, b"404 NOT FOUND")
        full = os.path.realpath(
            os.path.join(self.files_root, rel.lstrip("/")))
        if os.path.commonpath((self.files_root, full)) != self.files_root:
            return self._response(http.HTTPStatus.NOT_FOUND, b"404 NOT FOUND")
        if os.path.isdir(full):
            rows = []
            base = "/files" + (rel.rstrip("/") if rel.strip("/") else "")

            def href(path: str) -> str:
                # quote THEN escape: a hostile directory name must neither
                # break out of the attribute nor smuggle markup
                return html.escape(urllib.parse.quote(path, safe="/"))

            if full != self.files_root:
                rows.append('<li><a href="%s/">../</a></li>'
                            % href(os.path.dirname(base.rstrip("/"))))
            try:
                names = sorted(os.listdir(full))
            except OSError:
                return self._response(http.HTTPStatus.NOT_FOUND,
                                      b"404 NOT FOUND")
            for name in names:
                p = os.path.join(full, name)
                try:
                    if os.path.isdir(p):
                        rows.append(f'<li><a href="{href(base + "/" + name)}/">'
                                    f'{html.escape(name)}/</a></li>')
                    else:
                        size = os.path.getsize(p)
                        rows.append(
                            f'<li><a href="{href(base + "/" + name)}" download>'
                            f'{html.escape(name)}</a>'
                            f' <small>({size:,} B)</small></li>')
                except OSError:
                    continue    # dangling symlink / raced deletion
            body = (
                "<!DOCTYPE html><meta charset=utf-8>"
                "<style>body{font:14px system-ui;background:#101214;"
                "color:#d7dadd;padding:14px}a{color:#9ecbff}"
                "li{margin:3px 0}</style>"
                f"<h3>Files — {html.escape(rel or '/')}</h3>"
                "<ul>" + "".join(rows) + "</ul>").encode()
            hdrs = Headers()
            hdrs["Content-Type"] = "text/html; charset=utf-8"
            return self._response(http.HTTPStatus.OK, body, hdrs)
        if os.path.isfile(full):
            import re as _re

            try:
                size = os.path.getsize(full)
            except OSError:
                return self._response(http.HTTPStatus.NOT_FOUND,
                                      b"404 NOT FOUND")
            # the Response API is whole-body; cap what one request may pin
            # in memory rather than letting a Desktop disk image OOM the
            # streaming host
            if size > self.MAX_DOWNLOAD_BYTES:
                return self._response(
                    http.HTTPStatus.REQUEST_ENTITY_TOO_LARGE,
                    b"file exceeds the download size limit")
            mime = mimetypes.guess_type(full)[0] or "application/octet-stream"
            with open(full, "rb") as f:
                body = f.read()
            # header values must stay single-line and quote-free: strip
            # control characters and quotes from the advertised filename
            safe_name = _re.sub(r'[\x00-\x1f"\\\x7f]', "_",
                                os.path.basename(full)) or "download"
            hdrs = Headers()
            hdrs["Content-Type"] = mime
            hdrs["Content-Disposition"] = (
                'attachment; filename="%s"' % safe_name)
            return self._response(http.HTTPStatus.OK, body, hdrs)
        return self._response(http.HTTPStatus.NOT_FOUND, b"404 NOT FOUND")

    def _static_response(self, path: str) -> Response:
        if self.web_root is None:
            return self._response(http.HTTPStatus.NOT_FOUND, b"404 NOT FOUND")
        path = path.split("?")[0]
        if path == "/":
            path = "/index.html"
        full = os.path.realpath(os.path.join(self.web_root, path.lstrip("/")))
        if (
            os.path.commonpath((self.web_root, full)) != self.web_root
            or not os.path.isfile(full)
        ):
            return self._response(http.HTTPStatus.NOT_FOUND, b"404 NOT FOUND")
        mime = mimetypes.guess_type(full)[0] or "application/octet-stream"
        with open(full, "rb") as f:
            body = f.read()
        hdrs = Headers()
        hdrs["Content-Type"] = mime
        return self._response(http.HTTPStatus.OK, body, hdrs)

    # ------------------------------------------------------- WS signaling

    async def _recv_with_keepalive(self, ws):
        while True:
            try:
                return await asyncio.wait_for(ws.recv(), self.keepalive_timeout)
            except asyncio.TimeoutError:
                await ws.ping()

    async def _hello(self, ws) -> Tuple[str, Optional[dict]]:
        toks = (await ws.recv()).split(maxsplit=2)
        if len(toks) < 2 or toks[0] != "HELLO":
            await ws.close(code=1002, reason="invalid protocol")
            raise ValueError("invalid hello")
        uid = toks[1]
        if not uid or uid in self.peers or uid.split() != [uid]:
            await ws.close(code=1002, reason="invalid peer uid")
            raise ValueError(f"invalid uid {uid!r}")
        meta = json.loads(base64.b64decode(toks[2])) if len(toks) > 2 else None
        await ws.send("HELLO")
        return uid, meta

    async def _cleanup_session(self, uid: str) -> None:
        other = self.sessions.pop(uid, None)
        if other is None:
            return
        if self.sessions.pop(other, None) is not None and other in self.peers:
            ws_other = self.peers.pop(other)[0]
            await ws_other.close()

    async def _cleanup_room(self, uid: str, room_id: str) -> None:
        members = self.rooms.get(room_id)
        if not members or uid not in members:
            return
        members.remove(uid)
        for pid in members:
            try:
                await self.peers[pid][0].send(f"ROOM_PEER_LEFT {uid}")
            except Exception:
                pass

    async def _remove_peer(self, uid: str) -> None:
        await self._cleanup_session(uid)
        entry = self.peers.pop(uid, None)
        if entry is not None:
            ws, status, _ = entry
            if status and status != "session":
                await self._cleanup_room(uid, status)
            await ws.close()

    async def _handle_peer(self, ws, uid: str) -> None:
        while True:
            msg = await self._recv_with_keepalive(ws)
            if not isinstance(msg, str):
                await ws.send("ERROR binary frames not supported")
                continue
            entry = self.peers.get(uid)
            if entry is None:  # partner teardown removed us mid-flight
                return
            status = entry[1]
            if status == "session":
                other = self.sessions.get(uid)
                peer = self.peers.get(other) if other is not None else None
                if peer is not None:
                    await peer[0].send(msg)
            elif status is not None:  # in a room
                if msg.startswith("ROOM_PEER_MSG"):
                    try:
                        _, other, payload = msg.split(maxsplit=2)
                    except ValueError:
                        await ws.send("ERROR invalid ROOM_PEER_MSG")
                        continue
                    if other not in self.peers or self.peers[other][1] != status:
                        await ws.send(f"ERROR peer {other!r} not in the room")
                        continue
                    await self.peers[other][0].send(f"ROOM_PEER_MSG {uid} {payload}")
                else:
                    await ws.send("ERROR invalid msg, already in room")
            elif msg.startswith("SESSION"):
                try:
                    _, callee = msg.split(maxsplit=1)
                except ValueError:
                    await ws.send("ERROR invalid SESSION command")
                    continue
                if callee not in self.peers:
                    await ws.send(f"ERROR peer {callee!r} not found")
                    continue
                if self.peers[callee][1] is not None:
                    await ws.send(f"ERROR peer {callee!r} busy")
                    continue
                meta = self.peers[callee][2]
                meta64 = (
                    base64.b64encode(json.dumps(meta).encode()).decode() if meta else ""
                )
                # register the session before the await so a concurrent
                # SESSION to either peer sees them as busy
                self.peers[uid][1] = "session"
                self.peers[callee][1] = "session"
                self.sessions[uid] = callee
                self.sessions[callee] = uid
                await ws.send(f"SESSION_OK {meta64}".rstrip())
            elif msg.startswith("ROOM"):
                try:
                    _, room_id = msg.split(maxsplit=1)
                except ValueError:
                    await ws.send("ERROR invalid ROOM command")
                    continue
                if room_id == "session" or room_id.split() != [room_id]:
                    await ws.send(f"ERROR invalid room id {room_id!r}")
                    continue
                members = self.rooms.setdefault(room_id, set())
                # join before the first await so concurrent joiners see us
                existing = sorted(members)
                members.add(uid)
                self.peers[uid][1] = room_id
                await ws.send(("ROOM_OK " + " ".join(existing)).rstrip())
                for pid in existing:
                    peer = self.peers.get(pid)
                    if peer is not None:
                        await peer[0].send(f"ROOM_PEER_JOINED {uid}")
            else:
                logger.info("ignoring unknown message %r from %r", msg, uid)

    async def _ws_handler(self, ws) -> None:
        try:
            uid, meta = await self._hello(ws)
        except Exception:
            return
        self.peers[uid] = [ws, None, meta]
        try:
            await self._handle_peer(ws, uid)
        except websockets.exceptions.ConnectionClosed:
            pass
        finally:
            await self._remove_peer(uid)

    # --------------------------------------------------------- lifecycle

    async def run(self) -> None:
        self._stop = asyncio.get_running_loop().create_future()
        async with websockets.asyncio.server.serve(
            self._ws_handler,
            self.addr,
            self.port,
            process_request=self.process_request,
            max_queue=16,
        ) as self.server:
            # report the bound port (0 → ephemeral) for tests
            self.port = self.server.sockets[0].getsockname()[1]
            await self._stop

    async def stop(self) -> None:
        if self._stop and not self._stop.done():
            self._stop.set_result(None)
