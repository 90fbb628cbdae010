"""Minimal RESP2 (Redis Serialization Protocol) client — zero dependencies.

A stdlib-only copy of ``tpubloom/server/resp.py`` (the port may not import
``tpubloom``), for :class:`tpubloom_torch.checkpoint.RedisSink`; a serving
plane of the port reuses it.

Parity: the reference's transport layer is the redis-rb gem speaking RESP
over TCP/unix socket (SURVEY.md §1 L4). Here Redis is demoted to an async
checkpoint sink (BASELINE: "Redis persistence degrades to an async
checkpoint of the device bit-array"), and this hand-rolled client covers
exactly the commands the checkpoint path needs (PING/SET/GET/DEL/EXISTS) —
the package depends on no redis client library, and a full client would
be scope creep.

The wire format written by SET is the reference's own storage format: the
Redis string bitmap under ``key_name`` (see ``utils.packing``), so a stock
redis-server populated by this sink is readable by the reference's ``:ruby``
driver and vice versa.
"""

from __future__ import annotations

import socket
from typing import Optional


class RespError(RuntimeError):
    """Server-side -ERR reply."""


class RespClient:
    """Blocking RESP2 client over TCP (or unix socket path)."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 6379,
        *,
        unix_path: Optional[str] = None,
        timeout: float = 10.0,
    ):
        if unix_path:
            self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            self._sock.settimeout(timeout)
            self._sock.connect(unix_path)
        else:
            self._sock = socket.create_connection((host, port), timeout=timeout)
        self._buf = b""

    # -- wire format --------------------------------------------------------

    def _encode(self, *args: bytes | str | int) -> bytes:
        out = [b"*%d\r\n" % len(args)]
        for a in args:
            if isinstance(a, str):
                a = a.encode()
            elif isinstance(a, int):
                a = str(a).encode()
            out.append(b"$%d\r\n%s\r\n" % (len(a), a))
        return b"".join(out)

    def _read_line(self) -> bytes:
        while b"\r\n" not in self._buf:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise ConnectionError("redis connection closed")
            self._buf += chunk
        line, self._buf = self._buf.split(b"\r\n", 1)
        return line

    def _read_exact(self, n: int) -> bytes:
        while len(self._buf) < n:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise ConnectionError("redis connection closed")
            self._buf += chunk
        data, self._buf = self._buf[:n], self._buf[n:]
        return data

    def _read_reply(self):
        line = self._read_line()
        kind, rest = line[:1], line[1:]
        if kind == b"+":
            return rest
        if kind == b"-":
            raise RespError(rest.decode(errors="replace"))
        if kind == b":":
            return int(rest)
        if kind == b"$":
            n = int(rest)
            if n == -1:
                return None
            data = self._read_exact(n)
            self._read_exact(2)  # trailing \r\n
            return data
        if kind == b"*":
            n = int(rest)
            if n == -1:
                return None
            return [self._read_reply() for _ in range(n)]
        raise RespError(f"unexpected RESP type byte {kind!r}")

    def command(self, *args):
        self._sock.sendall(self._encode(*args))
        return self._read_reply()

    # -- the commands the checkpoint sink needs -----------------------------

    def ping(self) -> bool:
        return self.command("PING") == b"PONG"

    def set(self, key: str, value: bytes) -> bool:
        return self.command("SET", key, value) == b"OK"

    def get(self, key: str) -> Optional[bytes]:
        return self.command("GET", key)

    def delete(self, key: str) -> int:
        return self.command("DEL", key)

    def exists(self, key: str) -> int:
        return self.command("EXISTS", key)

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
