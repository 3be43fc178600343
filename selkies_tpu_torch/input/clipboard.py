"""Clipboard bridging backends.

Reference behavior: read/write the X selection through ``xclip`` subprocesses
with optional binary (image) MIME targets, polled every 0.5 s for outbound
sync (input_handler.py:1313-1404).  Here the transport is a backend object:
``XclipClipboard`` shells out like the reference, ``MemoryClipboard`` is an
in-process store for tests and headless operation.
"""

from __future__ import annotations

import asyncio
import logging
import shutil
from typing import Optional, Tuple

logger = logging.getLogger("selkies_tpu_torch.input.clipboard")

#: binary MIME types we will offer/accept, most-preferred first
BINARY_TARGETS = ("image/png", "image/jpeg", "image/webp", "image/bmp")


class ClipboardBackend:
    async def read(self, use_binary: bool = False
                   ) -> Tuple[Optional[bytes], str]:
        """Return (data, mime_type); data is None when empty/unavailable."""
        raise NotImplementedError

    async def write(self, data: bytes, mime_type: str = "text/plain") -> bool:
        raise NotImplementedError


class MemoryClipboard(ClipboardBackend):
    def __init__(self) -> None:
        self.data: bytes = b""
        self.mime_type: str = "text/plain"

    async def read(self, use_binary: bool = False
                   ) -> Tuple[Optional[bytes], str]:
        if not self.data:
            return None, "text/plain"
        if not use_binary and self.mime_type != "text/plain":
            return None, "text/plain"
        return self.data, self.mime_type

    async def write(self, data: bytes, mime_type: str = "text/plain") -> bool:
        self.data = bytes(data)
        self.mime_type = mime_type
        return True


class XclipClipboard(ClipboardBackend):
    """X selection via ``xclip`` subprocesses (same tool as the reference)."""

    def __init__(self, selection: str = "clipboard",
                 timeout: float = 2.0) -> None:
        if shutil.which("xclip") is None:
            raise RuntimeError("xclip not on PATH")
        self.selection = selection
        self.timeout = timeout

    async def _run(self, args, stdin_data: Optional[bytes] = None
                   ) -> Tuple[int, bytes]:
        proc = await asyncio.create_subprocess_exec(
            *args,
            stdin=asyncio.subprocess.PIPE if stdin_data is not None else None,
            stdout=asyncio.subprocess.PIPE,
            stderr=asyncio.subprocess.DEVNULL)
        try:
            out, _ = await asyncio.wait_for(
                proc.communicate(stdin_data), timeout=self.timeout)
        except asyncio.TimeoutError:
            proc.kill()
            return 1, b""
        return proc.returncode or 0, out or b""

    async def _targets(self) -> Tuple[str, ...]:
        rc, out = await self._run(
            ["xclip", "-selection", self.selection, "-o", "-t", "TARGETS"])
        if rc != 0:
            return ()
        return tuple(out.decode("ascii", "ignore").split())

    async def read(self, use_binary: bool = False
                   ) -> Tuple[Optional[bytes], str]:
        if use_binary:
            targets = await self._targets()
            for mime in BINARY_TARGETS:
                if mime in targets:
                    rc, out = await self._run(
                        ["xclip", "-selection", self.selection,
                         "-o", "-t", mime])
                    if rc == 0 and out:
                        return out, mime
        rc, out = await self._run(
            ["xclip", "-selection", self.selection, "-o"])
        if rc != 0 or not out:
            return None, "text/plain"
        return out, "text/plain"

    async def write(self, data: bytes, mime_type: str = "text/plain") -> bool:
        args = ["xclip", "-selection", self.selection, "-i"]
        if mime_type != "text/plain":
            args += ["-t", mime_type]
        rc, _ = await self._run(args, stdin_data=bytes(data))
        return rc == 0


def open_clipboard_backend() -> ClipboardBackend:
    try:
        return XclipClipboard()
    except Exception as e:
        logger.info("xclip unavailable (%s); using MemoryClipboard", e)
        return MemoryClipboard()
