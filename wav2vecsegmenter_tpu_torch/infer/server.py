"""Live segmentation server: concurrent PCM connections, one batched card.

Counterpart of ``wav2vecsegmenter_tpu/infer/server.py``, with its wire
protocol.  Clients connect over TCP (or a unix socket), send one JSON
header line then raw s16le mono 16 kHz PCM, and receive a JSON line per
committed segment the moment it finalizes.  All connections multiplex
through ONE :class:`~.online.MultiStreamSegmenter`, so every tick's filled
windows across clients run in batched encoder forwards: the card serves
the whole pool, not one stream at a time.

Wire protocol (newline-delimited JSON control plane, binary data plane):

  client -> server:  {"name": "talk7"}\\n        header (name optional;
                     may also carry per-connection algorithm overrides,
                     see _HEADER_ALGO_KEYS)
                     <raw s16le mono 16 kHz PCM ...>
                     shutdown(SHUT_WR) / FIN      end of stream
  server -> client:  {"type": "segment", "name", "offset", "duration",
                      "stream_pos_s", "lag_s"}\\n      per commit
                     {"type": "end", "name", "n_segments",
                      "audio_secs"}\\n                  after the tail flush
                     {"type": "error", "error"}\\n     bad header / above
                     max_conns capacity; after an error the server shuts
                     its write side and lingers reading until the peer's
                     EOF (immediate close would RST the unread error line)

Operational behavior: a SIGTERM/SIGINT'd daemon (or any serve_forever
exit) DRAINS first — every active stream gets its final partial window,
tail segments, and end line before the socket closes.  ``stats_every_s``
logs a periodic ops line (active connections, interval audio vs wall =
aggregate serving xRT, lifetime totals); ``max_conns`` caps the pool.

The event loop is a single thread (selectors), whichever thread calls
:meth:`SegmentationServer.serve_forever`: socket reads are non-blocking,
encoder calls are synchronous (each ``run_batch`` enters inference mode
itself, in the loop's thread) — batching makes them serve every stream at
once, and PCM arrives at real time, far slower than the encoder runs.  The
segmentation semantics are OnlineSegmenter's.
"""

from __future__ import annotations

import json
import logging
import os
import selectors
import socket
import time

import numpy as np

from ..constants import INPUT_SAMPLE_RATE
from .online import MultiStreamSegmenter

logger = logging.getLogger("wav2vecsegmenter_tpu_torch")

_RECV = 1 << 16

# header keys a client may set; everything else is rejected loudly.  The
# algorithm keys are per-connection because the encoder forward is
# algorithm-independent — mixed-algorithm connections still batch together.
_HEADER_ALGO_KEYS = frozenset({
    "algorithm", "max_segment_length", "min_segment_length",
    "min_pause_length", "threshold", "max_lerp_range", "min_lerp_range",
    "moving_average_window",
})


class _Conn:
    """Per-connection state: header parsing, torn-sample carry, name."""

    def __init__(self, sock: socket.socket, sid: int):
        self.sock = sock
        self.sid = sid
        self.name = f"conn{sid}"
        self.header = b""
        self.header_done = False
        self.overrides: dict = {}
        self.registered = False
        self.carry = b""
        self.samples = 0
        self.n_segments = 0
        self.closed = False
        self.draining = False  # error sent; lingering until peer EOF
        self.drain_deadline = 0.0

    def take_pcm(self, data: bytes) -> np.ndarray:
        """Header-then-PCM framing; returns new float32 samples."""
        if not self.header_done:
            self.header += data
            if b"\n" not in self.header:
                if len(self.header) > 1 << 20:
                    raise ValueError("header line never terminated")
                return np.zeros(0, np.float32)
            line, _, rest = self.header.partition(b"\n")
            if line.strip():
                meta = json.loads(line)
                if not isinstance(meta, dict):
                    raise ValueError("header must be a JSON object")
                if meta.get("name"):
                    self.name = str(meta.pop("name"))
                else:
                    meta.pop("name", None)
                unknown = set(meta) - _HEADER_ALGO_KEYS
                if unknown:
                    raise ValueError(f"unknown header keys: {sorted(unknown)}")
                self.overrides = meta
            self.header_done = True
            data, self.header = rest, b""
        data = self.carry + data
        n2 = len(data) // 2 * 2
        data, self.carry = data[:n2], data[n2:]
        if not data:
            return np.zeros(0, np.float32)
        chunk = np.frombuffer(data, "<i2").astype(np.float32) / 32768.0
        self.samples += len(chunk)
        return chunk

    def send_line(self, obj: dict) -> None:
        if self.closed:
            return
        try:
            self.sock.sendall((json.dumps(obj) + "\n").encode())
        except OSError:
            self.closed = True


class SegmentationServer:
    """Serve live segmentation over a listening socket.

    ``engine`` + ``stream_kwargs`` configure the shared
    MultiStreamSegmenter (segment_length, algorithm, thresholds...).
    Call :meth:`serve_forever` (blocks; ``shutdown()`` from another
    thread stops it) — or drive :meth:`step` yourself in tests.
    """

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 0,
                 unix_path: str | None = None, max_batch: int = 8,
                 backlog: int = 64, stats_every_s: float = 0.0,
                 max_conns: int = 0, **stream_kwargs):
        # 0 = unlimited; above the cap new connections get a JSON error
        # line and an immediate close instead of degrading the whole pool
        self.max_conns = int(max_conns or 0)
        self.mux = MultiStreamSegmenter(engine, max_batch=max_batch,
                                        **stream_kwargs)
        # periodic ops line: active conns, interval audio ingested vs wall
        # (aggregate serving xRT), totals.  0 disables.
        self.stats_every_s = float(stats_every_s or 0.0)
        self._stats_t0 = time.monotonic()
        self._stats_samples = 0
        self.total_samples = 0
        self.total_segments = 0
        self.total_conns = 0
        self._unix_path = unix_path
        if unix_path:
            self._lsock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            try:
                self._lsock.bind(unix_path)
            except OSError:
                # a previous server's stale socket file: if nothing is
                # listening there, replace it; if something is, re-raise
                probe = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                try:
                    probe.connect(unix_path)
                except OSError:
                    os.unlink(unix_path)
                    self._lsock.bind(unix_path)
                else:
                    raise OSError(
                        f"another server is listening on {unix_path}")
                finally:
                    probe.close()
            self.address = unix_path
        else:
            self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self._lsock.bind((host, port))
            self.address = self._lsock.getsockname()
        self._lsock.listen(backlog)
        self._lsock.setblocking(False)
        self._sel = selectors.DefaultSelector()
        self._sel.register(self._lsock, selectors.EVENT_READ, None)
        self._conns: dict[int, _Conn] = {}
        self._next_sid = 0
        self._running = False
        self._closed = False

    # ------------------------------------------------------------------
    def serve_forever(self, poll_s: float = 0.05) -> None:
        self._running = True
        try:
            while self._running:
                self.step(poll_s)
        finally:
            self.drain()
            self.close()

    def shutdown(self) -> None:
        self._running = False

    def drain(self) -> None:
        """Gracefully flush every active connection: run its final partial
        window, deliver the tail segments and the end line, then close —
        clients of a shutting-down server get complete streams instead of a
        dropped socket mid-stream."""
        for conn in list(self._conns.values()):
            self._finish(conn)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for conn in list(self._conns.values()):
            self._drop(conn)
        self._sel.close()
        self._lsock.close()
        if self._unix_path:
            try:
                os.unlink(self._unix_path)
            except OSError:
                pass

    # ------------------------------------------------------------------
    def step(self, poll_s: float = 0.05) -> None:
        """One event-loop pass: drain readable sockets, feed the mux with
        everything that arrived, deliver commits, flush ended streams."""
        chunks: dict[int, list[np.ndarray]] = {}
        ended: list[_Conn] = []
        for key, _ in self._sel.select(poll_s):
            if key.data is None:
                self._accept()
                continue
            conn: _Conn = key.data
            try:
                data = conn.sock.recv(_RECV)
            except BlockingIOError:
                continue
            except OSError:
                data = b""
            if conn.draining:
                # error already sent: discard the peer's in-flight bytes
                # until EOF, then close (see _abort)
                if not data:
                    self._drop(conn)
                continue
            if data:
                try:
                    chunk = conn.take_pcm(data)
                    if conn.header_done and not conn.registered:
                        # register at header time so per-connection
                        # algorithm overrides reach the stream
                        self.mux.add_stream(conn.sid, **conn.overrides)
                        conn.registered = True
                except (ValueError, TypeError, NotImplementedError,
                        json.JSONDecodeError) as e:
                    conn.send_line({"type": "error", "error": str(e)})
                    self._abort(conn)
                    continue
                if len(chunk):
                    self._stats_samples += len(chunk)
                    self.total_samples += len(chunk)
                    chunks.setdefault(conn.sid, []).append(chunk)
            else:  # EOF / FIN: stream is over
                ended.append(conn)

        if chunks:
            committed = self.mux.feed({
                sid: np.concatenate(parts) if len(parts) > 1 else parts[0]
                for sid, parts in chunks.items()
            })
            for sid, segs in committed.items():
                self._deliver(self._conns[sid], segs)

        for conn in ended:
            self._finish(conn)

        # expire draining connections whose peer never sent EOF
        for conn in list(self._conns.values()):
            if conn.draining and time.monotonic() > conn.drain_deadline:
                self._drop(conn)

        if self.stats_every_s:
            wall = time.monotonic() - self._stats_t0
            if wall >= self.stats_every_s:
                audio_s = self._stats_samples / INPUT_SAMPLE_RATE
                logger.info(
                    "serve stats: %d active, %.1fs audio in %.1fs "
                    "(%.0fx RT aggregate); totals: %d conns, %.1fs audio, "
                    "%d segments",
                    len(self._conns), audio_s, wall,
                    audio_s / wall if wall > 0 else 0.0,
                    self.total_conns,
                    self.total_samples / INPUT_SAMPLE_RATE,
                    self.total_segments)
                self._stats_t0 = time.monotonic()
                self._stats_samples = 0

    # ------------------------------------------------------------------
    def _accept(self) -> None:
        try:
            sock, _ = self._lsock.accept()
        except OSError:
            return
        if self.max_conns and len(self._conns) >= self.max_conns:
            try:
                sock.sendall((json.dumps(
                    {"type": "error",
                     "error": f"server at capacity ({self.max_conns} "
                              "connections)"}) + "\n").encode())
            except OSError:
                pass
            sock.close()
            return
        sock.setblocking(False)
        conn = _Conn(sock, self._next_sid)
        self._next_sid += 1
        self.total_conns += 1
        self._conns[conn.sid] = conn
        self._sel.register(sock, selectors.EVENT_READ, conn)

    def _deliver(self, conn: _Conn, segs) -> None:
        pos_s = conn.samples / INPUT_SAMPLE_RATE
        for s in segs:
            conn.n_segments += 1
            self.total_segments += 1
            conn.send_line({
                "type": "segment",
                "name": conn.name,
                "offset": s.offset,
                "duration": s.duration,
                "stream_pos_s": round(pos_s, 3),
                "lag_s": round(pos_s - (s.offset + s.duration), 3),
            })

    def _finish(self, conn: _Conn) -> None:
        if not conn.registered:  # FIN before a complete header
            conn.send_line({"type": "end", "name": conn.name,
                            "n_segments": 0, "audio_secs": 0.0})
            self._drop(conn)
            return
        self._deliver(conn, self.mux.finish(conn.sid))
        conn.send_line({
            "type": "end",
            "name": conn.name,
            "n_segments": conn.n_segments,
            "audio_secs": round(conn.samples / INPUT_SAMPLE_RATE, 3),
        })
        self._drop(conn)

    def _abort(self, conn: _Conn) -> None:
        """Lingering close after an error line: shut the write side and
        keep reading until the peer's EOF — an immediate close() while the
        peer's PCM is still in flight would RST the connection and can
        destroy the just-sent error line before the peer reads it."""
        try:
            conn.sock.shutdown(socket.SHUT_WR)
        except OSError:
            self._drop(conn)
            return
        conn.draining = True
        conn.drain_deadline = time.monotonic() + 10.0

    def _drop(self, conn: _Conn) -> None:
        if conn.sid in self._conns:
            del self._conns[conn.sid]
            try:
                self._sel.unregister(conn.sock)
            except (KeyError, ValueError):
                pass
            try:
                conn.sock.close()
            except OSError:
                pass
            conn.closed = True


def segment_stream_client(address, pcm: bytes, name: str = "",
                          chunk_bytes: int = 32000,
                          pace_s: float = 0.0,
                          header: dict | None = None) -> list[dict]:
    """Minimal reference client (also used by tests): stream ``pcm`` to a
    running server, return every JSON line received (segments + end).
    ``header`` adds per-connection fields (e.g. algorithm overrides)."""
    if isinstance(address, str):
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    else:
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        address = tuple(address)
    sock.connect(address)
    meta = dict(header or {})
    if name:
        meta["name"] = name
    sock.sendall((json.dumps(meta) + "\n").encode())
    buf = b""
    lines: list[dict] = []

    def drain(block: bool) -> bool:
        nonlocal buf
        sock.setblocking(block)
        try:
            while True:
                data = sock.recv(_RECV)
                if not data:
                    return False
                buf += data
                if block:
                    break
        except BlockingIOError:
            pass
        except OSError:
            return False  # reset mid-read: keep whatever arrived
        finally:
            sock.setblocking(True)
        return True

    for i in range(0, len(pcm), chunk_bytes):
        try:
            sock.sendall(pcm[i: i + chunk_bytes])
        except OSError:
            break  # server shut the stream (e.g. header rejected)
        if pace_s:
            time.sleep(pace_s)
        drain(block=False)
    try:
        sock.shutdown(socket.SHUT_WR)
    except OSError:
        pass
    while drain(block=True):
        pass
    for line in buf.splitlines():
        if line.strip():
            lines.append(json.loads(line))
    return lines
