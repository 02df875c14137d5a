"""Wire-protocol front door: sockets in, :class:`ReductionService` behind
(counterpart of ``repro.serving.server``; clients of either package drive
it, the frames being the same).

:class:`ReductionServer` accepts connections on a Unix-domain socket and/or
localhost TCP, parses :mod:`repro_torch.serving.protocol` frames, admits each
request into the shared :class:`~repro_torch.serving.service.ReductionService`
(quicklook / fetch-KV ride the ``interactive`` priority lane, reduction the
``bulk`` lane), and demultiplexes responses back per connection — requests
from one connection resolve out of order without blocking each other, and
requests from *different* connections coalesce into the same stacked
engine buckets exactly as in-process threads do.

Fault containment is the design center (this is a trust boundary):

  * every frame field is validated before any allocation or dispatch; a
    malformed frame gets an ``OP_ERROR`` response naming the field and —
    when the failure means framing sync is lost (bad length prefix, torn
    body, wrong magic/version) — the connection is closed, never the
    server;
  * a client dying mid-request just ends its reader loop: its socket is
    reclaimed, its in-flight responses are dropped on the floor
    (``send_failures``), and every other connection keeps streaming;
  * per-connection byte/frame counters are pushed into the service's
    :attr:`~repro_torch.serving.service.ServiceStats.connections` so overload
    and abuse are observable per peer.

Results stay where the service computed them (on the card, for a card's
engine) until a response is serialised: :func:`~.protocol.dumps_payload`
is where they become host numpy.
"""

from __future__ import annotations

import itertools
import os
import socket
import tempfile
import threading
from pathlib import Path
from typing import Any, Callable

import numpy as np

from . import protocol as P
from .service import INTERACTIVE, ReductionService

_BACKLOG = 64
# the accept loops wake this often to see a close: closing (or shutting
# down) a listening socket does not wake a thread blocked in accept() on
# every kernel, and close() would otherwise wait out its join
_ACCEPT_POLL_S = 0.25


class _Connection:
    """One accepted peer: its socket, write lock, and identity."""

    def __init__(self, conn_id: str, sock: socket.socket):
        self.id = conn_id
        self.sock = sock
        self.wlock = threading.Lock()
        self.alive = True

    def close(self) -> None:
        self.alive = False
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


class ReductionServer:
    """Serve a :class:`ReductionService` over UDS and/or localhost TCP.

    Parameters
    ----------
    service:
        The service to front.  ``None`` builds a private one from
        ``service_kwargs`` and closes it with the server.
    unix_path:
        Unix-domain socket path.  ``None`` with ``tcp=None`` auto-creates
        one under a temp directory (see :attr:`unix_address`); pass
        ``False`` to disable the UDS listener.
    tcp:
        ``(host, port)`` for a TCP listener, ``port=0`` picks a free port
        (see :attr:`tcp_address`).  The default binds no TCP socket; hosts
        outside the loopback are refused — the wire protocol is
        *unauthenticated* and must not be exposed off-host.
    max_frame:
        Per-frame byte ceiling (oversized length prefixes are rejected
        before allocation).
    request_timeout:
        Admission timeout forwarded to the service for each request.
    """

    def __init__(
        self,
        service: ReductionService | None = None,
        *,
        unix_path: Any = None,
        tcp: tuple[str, int] | None = None,
        max_frame: int = P.MAX_FRAME_BYTES,
        request_timeout: float | None = None,
        **service_kwargs: Any,
    ):
        self._own_service = service is None
        self.service = service if service is not None else ReductionService(
            **service_kwargs
        )
        self.max_frame = int(max_frame)
        self.request_timeout = request_timeout
        self._closing = False
        self._lock = threading.Lock()
        self._conn_seq = itertools.count(1)
        self._conns: dict[str, _Connection] = {}
        self._threads: list[threading.Thread] = []
        self._listeners: list[socket.socket] = []
        self._tmpdir: tempfile.TemporaryDirectory | None = None
        # server-local counters (connection byte counters live in the
        # service so ServiceStats is the one-stop snapshot)
        self._m = {
            "accepted": 0, "reclaimed": 0, "requests": 0, "responses": 0,
            "protocol_errors": 0, "send_failures": 0, "torn_frames": 0,
        }

        self.unix_address: str | None = None
        self.tcp_address: tuple[str, int] | None = None
        if unix_path is None and tcp is None:
            self._tmpdir = tempfile.TemporaryDirectory(prefix="hpdr-serve-")
            unix_path = Path(self._tmpdir.name) / "hpdr.sock"
        if unix_path not in (None, False):
            ls = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            ls.bind(str(unix_path))
            ls.listen(_BACKLOG)
            ls.settimeout(_ACCEPT_POLL_S)
            self.unix_address = str(unix_path)
            self._listeners.append(ls)
            self._spawn(self._accept_loop, ls, "unix")
        if tcp is not None:
            host, port = tcp
            if host not in ("127.0.0.1", "localhost", "::1"):
                raise ValueError(
                    f"refusing non-loopback bind {host!r}: the wire protocol "
                    "is unauthenticated (use an ssh tunnel or a mesh proxy)"
                )
            ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            ls.bind((host, port))
            ls.listen(_BACKLOG)
            ls.settimeout(_ACCEPT_POLL_S)
            self.tcp_address = ls.getsockname()
            self._listeners.append(ls)
            self._spawn(self._accept_loop, ls, "tcp")

    # ---------------------------------------------------------------- accept

    def _spawn(self, fn: Callable, *args: Any) -> None:
        t = threading.Thread(target=fn, args=args, daemon=True,
                             name="hpdr-server")
        t.start()
        self._threads.append(t)

    def _accept_loop(self, listener: socket.socket, kind: str) -> None:
        while not self._closing:
            try:
                sock, _addr = listener.accept()  # a blocking socket
            except socket.timeout:
                continue  # look at _closing again
            except OSError:
                return  # listener closed
            conn = _Connection(f"{kind}:{next(self._conn_seq)}", sock)
            with self._lock:
                if self._closing:
                    conn.close()
                    return
                self._conns[conn.id] = conn
                self._m["accepted"] += 1
            self.service.note_connection(conn.id, opened=True)
            self._spawn(self._reader_loop, conn)

    # ---------------------------------------------------------------- reader

    def _reader_loop(self, conn: _Connection) -> None:
        """Frame pump for one connection; exits only when the peer is gone."""
        try:
            while not self._closing:
                try:
                    frame = P.recv_frame(conn.sock, max_frame=self.max_frame)
                except P.ProtocolError as e:
                    with self._lock:
                        self._m["protocol_errors"] += 1
                        if e.field == "truncated":
                            self._m["torn_frames"] += 1
                    self.service.note_connection(conn.id, protocol_errors=1)
                    rid = getattr(e, "request_id", 0)
                    if e.field in ("length", "truncated", "magic", "version"):
                        # framing sync is lost (or the peer doesn't speak
                        # HPRW at all): tell it why, then hang up
                        self._send_error(conn, rid, e)
                        return
                    # body-level fault in a well-delimited frame: report and
                    # keep the connection — the next frame is readable
                    self._send_error(conn, rid, e)
                    continue
                except OSError:
                    return  # socket reclaimed under us
                if frame is None:
                    return  # clean EOF
                self.service.note_connection(
                    conn.id, frames_rx=1,
                    rx_bytes=4 + P.HEADER_BYTES
                    + len(frame.tenant.encode()) + len(frame.payload),
                )
                with self._lock:
                    self._m["requests"] += 1
                try:
                    self._handle(conn, frame)
                except P.ProtocolError as e:
                    with self._lock:
                        self._m["protocol_errors"] += 1
                    self.service.note_connection(conn.id, protocol_errors=1)
                    self._send_error(conn, frame.request_id, e)
                except Exception as e:
                    self._send_error(conn, frame.request_id, e)
        finally:
            self._reclaim(conn)

    def _reclaim(self, conn: _Connection) -> None:
        with self._lock:
            known = self._conns.pop(conn.id, None) is not None
            if known:
                self._m["reclaimed"] += 1
        conn.close()
        if known:
            self.service.note_connection(conn.id, closed=True)

    # -------------------------------------------------------------- dispatch

    def _handle(self, conn: _Connection, frame: P.Frame) -> None:
        op, rid, tenant = frame.opcode, frame.request_id, frame.tenant
        svc = self.service
        if op == P.OP_PING:
            self._send(conn, rid, frame.payload)
            return
        if op == P.OP_STATS:
            self._send(conn, rid, P.dumps_json(svc.stats().as_dict()))
            return
        if op == P.OP_RELEASE_KV:
            extra = P.loads_json(frame.payload)
            svc.release_kv(extra["session"], tenant=tenant)
            self._send(conn, rid, P.dumps_json({}))
            return

        if op == P.OP_COMPRESS:
            entries, extra = P.loads_payload(frame.payload)
            tree = {k: np.asarray(v) for k, v in entries.items()}
            select = _wire_select(extra)
            sub = svc.submit_compress(
                tree, select, tenant=tenant, timeout=self.request_timeout
            )
            on_ok = lambda res: P.dumps_payload(res[0], {"stats": res[1]})
        elif op == P.OP_DECOMPRESS:
            entries, _extra = P.loads_payload(frame.payload)
            # the restored tree has the entries' flat structure; each leaf's
            # shape and dtype come from its container (the reference builds
            # an empty array of each, which bfloat16 cannot be without
            # ml_dtypes)
            sub = svc.submit_decompress(
                entries, dict(entries), tenant=tenant,
                timeout=self.request_timeout,
            )
            on_ok = lambda tree: P.dumps_payload(dict(tree))
        elif op == P.OP_COMPRESS_STREAM:
            entries, extra = P.loads_payload(frame.payload)
            kwargs = dict(extra.get("params", {}))
            sub = svc.submit_compress_stream(
                np.asarray(entries["data"]), extra.get("method", "zfp"),
                tenant=tenant,
                chunk_size=extra.get("chunk_size", "auto"),
                window=extra.get("window", "auto"),
                timeout=self.request_timeout, **kwargs,
            )
            on_ok = lambda res: P.dumps_payload(
                {"stream": res[0]}, {"info": res[1]}
            )
        elif op == P.OP_DECOMPRESS_STREAM:
            entries, extra = P.loads_payload(frame.payload)
            source = extra.get("path") or entries.get("stream")
            if source is None:
                raise P.ProtocolError(
                    "decompress_stream needs a 'path' extra or a 'stream' "
                    "entry",
                    field="payload",
                )
            sel = extra.get("chunks")
            sub = svc.submit_decompress_stream(
                source, chunks=tuple(sel) if sel else None,
                tenant=tenant, timeout=self.request_timeout,
            )
            on_ok = lambda res: P.dumps_payload(
                {"array": res[0]}, {"info": res[1]}
            )
        elif op == P.OP_QUICKLOOK:
            extra = P.loads_json(frame.payload)
            sub = svc.submit_quicklook(
                extra["path"], err=extra.get("err"),
                tiers=extra.get("tiers"), tenant=tenant,
                timeout=self.request_timeout,
            )
            on_ok = lambda res: P.dumps_payload(
                {"array": res[0]}, {"info": res[1]}
            )
        elif op == P.OP_FETCH_KV:
            extra = P.loads_json(frame.payload)
            sub = svc.submit_fetch_kv(
                extra["session"], tenant=tenant, timeout=self.request_timeout
            )
            on_ok = lambda flat: P.dumps_payload(dict(flat))
        elif op == P.OP_PARK_KV:
            entries, extra = P.loads_payload(frame.payload)
            cache = {k: np.asarray(v) for k, v in entries.items()}
            sub = svc.submit_park_kv(
                extra["session"], cache, tenant=tenant,
                timeout=self.request_timeout,
            )
            on_ok = lambda res: P.dumps_payload(None, {"stats": res})
        else:  # response opcodes arriving as requests
            raise P.ProtocolError(
                f"opcode {frame.opcode_name!r} is not a request",
                field="opcode",
            )

        sub.add_done_callback(
            lambda s, c=conn, r=rid, f=on_ok: self._complete(c, r, s, f)
        )

    def _complete(self, conn: _Connection, rid: int, sub, serialize) -> None:
        exc = sub.exception()
        if exc is not None:
            self._send_error(conn, rid, exc)
            return
        try:
            payload = serialize(sub.result())
        except Exception as e:
            self._send_error(conn, rid, e)
            return
        self._send(conn, rid, payload)

    # ------------------------------------------------------------- responses

    def _send(self, conn: _Connection, rid: int, payload: bytes,
              *, opcode: int = P.OP_OK, flags: int = 0) -> None:
        blob = P.encode_frame(opcode, rid, payload, tenant="", flags=flags)
        try:
            with conn.wlock:
                conn.sock.sendall(blob)
        except OSError:
            # the peer died between request and response: its reader loop
            # reclaims the socket, this response just evaporates
            with self._lock:
                self._m["send_failures"] += 1
            conn.close()
            return
        with self._lock:
            self._m["responses"] += 1
        self.service.note_connection(conn.id, frames_tx=1, tx_bytes=len(blob))

    def _send_error(self, conn: _Connection, rid: int,
                    exc: BaseException) -> None:
        self._send(conn, rid, P.error_payload(exc),
                   opcode=P.OP_ERROR, flags=P.FLAG_ERROR)

    # --------------------------------------------------------------- metrics

    def stats(self) -> dict[str, Any]:
        with self._lock:
            out = dict(self._m)
            out["open_connections"] = len(self._conns)
        return out

    # ------------------------------------------------------------- lifecycle

    def close(self, timeout: float | None = None) -> None:
        """Stop accepting, drop connections, close an owned service."""
        self._closing = True
        for ls in self._listeners:
            try:
                ls.close()
            except OSError:
                pass
        with self._lock:
            conns = list(self._conns.values())
        for conn in conns:
            self._reclaim(conn)
        for t in self._threads:
            t.join(timeout if timeout is not None else 5.0)
        if self.unix_address and os.path.exists(self.unix_address):
            try:
                os.unlink(self.unix_address)
            except OSError:
                pass
        if self._own_service:
            self.service.close(timeout)
        if self._tmpdir is not None:
            self._tmpdir.cleanup()

    def __enter__(self) -> "ReductionServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _wire_select(extra: dict):
    """Uniform codec selector from a request's ``method``/``params`` extra.

    Callables can't cross the wire, so remote compress requests name one
    ``(method, params)`` applied to every leaf; with no method the
    service-side default policy decides per leaf.
    """
    method = extra.get("method")
    if not method:
        return None
    params = dict(extra.get("params", {}))

    def select(key: str, arr: np.ndarray):
        del key, arr
        return method, dict(params)

    return select
