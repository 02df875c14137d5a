"""Blocking wire client for :class:`~repro_torch.serving.server.ReductionServer`
(counterpart of ``repro.serving.client``; it drives a server of either
package, the frames being the same).

:class:`ReductionClient` speaks the :mod:`repro_torch.serving.protocol` frame
format over a Unix-domain socket or localhost TCP.  It is deliberately
simple — one request in flight per client, synchronous result — because
the *server* side is where concurrency lives: run N clients (threads or
processes) and their requests coalesce into shared engine buckets.

Reliability model:

  * transport faults (connect refused, reset, torn response) are retried
    up to ``retries`` times with exponential backoff, reconnecting a
    fresh socket each time;
  * :class:`~repro_torch.serving.service.ServiceOverloaded` is retried the same
    way — overload is transient by construction;
  * server-reported application errors (bad codec, unknown session, quota
    exceeded) are raised immediately with the server's message — a retry
    would just fail identically;
  * a response whose ``request_id`` does not echo the request's is a
    protocol violation: the connection is dropped and the request retried
    on a new one.
"""

from __future__ import annotations

import socket
import time
from typing import Any

import numpy as np

from . import protocol as P
from .service import ServiceOverloaded


class ReductionClient:
    """Blocking client for one server address.

    Parameters
    ----------
    address:
        A UDS path (``str`` / ``os.PathLike``) or a ``(host, port)`` tuple
        for TCP — match the server's :attr:`unix_address` /
        :attr:`tcp_address`.
    tenant:
        Tenant name stamped on every request frame (quota accounting and
        per-tenant stats happen server-side under this name).
    timeout:
        Socket timeout per send/recv, seconds.
    retries:
        Transport-fault retry budget per request (0 disables retry).
    backoff:
        Initial retry sleep, doubled per attempt.
    """

    def __init__(
        self,
        address: Any,
        *,
        tenant: str = "default",
        timeout: float = 30.0,
        retries: int = 3,
        backoff: float = 0.05,
        max_frame: int = P.MAX_FRAME_BYTES,
    ):
        self.address = address
        self.tenant = str(tenant)
        self.timeout = float(timeout)
        self.retries = int(retries)
        self.backoff = float(backoff)
        self.max_frame = int(max_frame)
        self._sock: socket.socket | None = None
        self._rid = 0
        self._m = {"requests": 0, "retries": 0, "reconnects": 0}

    # ------------------------------------------------------------- transport

    def _connect(self) -> socket.socket:
        if isinstance(self.address, tuple):
            sock = socket.create_connection(self.address,
                                            timeout=self.timeout)
        else:
            sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            sock.settimeout(self.timeout)
            sock.connect(str(self.address))
        return sock

    def _drop(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _roundtrip(self, opcode: int, payload: bytes) -> P.Frame:
        """Send one frame, block for its echo-id response, retrying."""
        self._rid += 1
        rid = self._rid
        blob = P.encode_frame(opcode, rid, payload, tenant=self.tenant)
        self._m["requests"] += 1
        delay = self.backoff
        last: Exception | None = None
        for attempt in range(self.retries + 1):
            if attempt:
                self._m["retries"] += 1
                time.sleep(delay)
                delay *= 2
            try:
                if self._sock is None:
                    self._sock = self._connect()
                    self._m["reconnects"] += 1
                self._sock.sendall(blob)
                frame = P.recv_frame(self._sock, max_frame=self.max_frame)
                if frame is None:
                    raise P.ProtocolError(
                        "server closed the connection before responding",
                        field="truncated",
                    )
                if frame.request_id != rid:
                    raise P.ProtocolError(
                        f"response id {frame.request_id} != request id "
                        f"{rid}",
                        field="request_id",
                    )
            except (ConnectionError, socket.timeout, OSError) as e:
                self._drop()
                last = e
                continue
            except P.ProtocolError as e:
                # torn/mismatched response: the stream is unusable, but the
                # request may still succeed on a fresh connection
                self._drop()
                last = e
                continue
            if frame.flags & P.FLAG_ERROR or frame.opcode == P.OP_ERROR:
                try:
                    P.raise_error_payload(frame.payload)
                except ServiceOverloaded as e:
                    last = e  # transient by definition — retry
                    continue
            return frame
        raise last if last is not None else RuntimeError("retry loop empty")

    # --------------------------------------------------------------- service

    def ping(self, payload: bytes = b"") -> bytes:
        """Liveness check; the server echoes ``payload`` back verbatim."""
        return self._roundtrip(P.OP_PING, payload).payload

    def stats(self) -> dict:
        """Fetch the server's :class:`ServiceStats` snapshot as a dict."""
        return P.loads_json(self._roundtrip(P.OP_STATS, b"").payload)

    def compress(self, tree: dict, *, method: str | None = None,
                 **params: Any) -> tuple[dict, dict]:
        """Compress a flat ``{key: array}`` dict (numpy arrays or tensors, on
        the host or the card); returns ``(comp, stats)``.

        ``method``/``params`` pick one codec for every leaf; omit them to
        let the server's default policy choose per leaf.  ``comp`` values
        are :class:`~repro_torch.core.container.Compressed` — byte-identical to
        the in-process :meth:`ReductionService.compress` result.
        """
        extra: dict[str, Any] = {}
        if method is not None:
            extra = {"method": method, "params": params}
        payload = P.dumps_payload(dict(tree), extra)
        frame = self._roundtrip(P.OP_COMPRESS, payload)
        flat, ex = P.loads_payload(frame.payload)
        return flat, ex.get("stats", {})

    def decompress(self, comp: dict) -> dict:
        """Restore a flat dict of :class:`Compressed` back to arrays."""
        payload = P.dumps_payload(dict(comp))
        frame = self._roundtrip(P.OP_DECOMPRESS, payload)
        flat, _ = P.loads_payload(frame.payload)
        return flat

    def compress_stream(self, data: np.ndarray, method: str = "zfp", *,
                        chunk_size: int | str = "auto",
                        window: int | str = "auto",
                        **params: Any) -> tuple[bytes, dict]:
        """Chunked-stream compress; returns ``(stream_bytes, info)``."""
        payload = P.dumps_payload(
            {"data": data},
            {"method": method, "chunk_size": chunk_size, "window": window,
             "params": params},
        )
        frame = self._roundtrip(P.OP_COMPRESS_STREAM, payload)
        flat, ex = P.loads_payload(frame.payload)
        return flat["stream"], ex.get("info", {})

    def decompress_stream(self, source: Any, *,
                          chunks: tuple[int, int] | None = None,
                          ) -> tuple[np.ndarray, dict]:
        """Decode a stream (bytes, or a *server-visible* file path).

        Returns ``(array, info)``; ``chunks=(lo, hi)`` restores only that
        range.  Concurrent requests for the same stream coalesce
        server-side — each chunk decodes once.
        """
        extra: dict[str, Any] = {"chunks": list(chunks) if chunks else None}
        if isinstance(source, (bytes, bytearray, memoryview)):
            payload = P.dumps_payload({"stream": bytes(source)}, extra)
        else:
            extra["path"] = str(source)
            payload = P.dumps_payload(None, extra)
        frame = self._roundtrip(P.OP_DECOMPRESS_STREAM, payload)
        flat, ex = P.loads_payload(frame.payload)
        return flat["array"], ex.get("info", {})

    def quicklook(self, path: Any, *, err: float | None = None,
                  tiers: int | None = None) -> tuple[np.ndarray, dict]:
        """Low-precision preview of a progressive file (interactive lane)."""
        payload = P.dumps_json(
            {"path": str(path), "err": err, "tiers": tiers}
        )
        frame = self._roundtrip(P.OP_QUICKLOOK, payload)
        flat, ex = P.loads_payload(frame.payload)
        return flat["array"], ex.get("info", {})

    def park_kv(self, session_id: str, cache: dict) -> dict:
        """Park a flat ``{name: array}`` KV cache; returns park stats."""
        payload = P.dumps_payload(dict(cache), {"session": str(session_id)})
        frame = self._roundtrip(P.OP_PARK_KV, payload)
        _, ex = P.loads_payload(frame.payload)
        return ex.get("stats", {})

    def fetch_kv(self, session_id: str) -> dict:
        """Fetch a parked session's compressed containers (interactive)."""
        payload = P.dumps_json({"session": str(session_id)})
        frame = self._roundtrip(P.OP_FETCH_KV, payload)
        flat, _ = P.loads_payload(frame.payload)
        return flat

    def release_kv(self, session_id: str) -> None:
        """Release a parked session's pages and quota."""
        self._roundtrip(P.OP_RELEASE_KV,
                        P.dumps_json({"session": str(session_id)}))

    # --------------------------------------------------------------- helpers

    def client_stats(self) -> dict:
        """Local transport counters (requests / retries / reconnects)."""
        return dict(self._m)

    def close(self) -> None:
        self._drop()

    def __enter__(self) -> "ReductionClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
