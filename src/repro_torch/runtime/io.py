"""Aggregated parallel-I/O writer — coalesced, aligned segment files.

A copy of ``repro.runtime.io`` (numpy and the standard library only): the
port writes the same files and reads the reference's, without importing it.
Its errors are the port's :class:`~repro_torch.core.container.ContainerError`.

The paper's at-scale I/O result (up to 4x parallel-write acceleration,
Figs. 17-18) comes from *aggregation*: many small per-leaf/per-chunk
compressed blobs are coalesced into a few large, aligned writes instead of
one syscall (or one file) per object.  This module is the framework's
node-local analogue of the ADIOS2 aggregating writer:

  * :class:`AggregatedWriter` — append-only segment file writer.  ``add``
    places each named blob at the next aligned offset and buffers it into a
    large write buffer (a zero-copy iovec list); full buffers are flushed
    with one gathered positional ``pwritev`` on a dedicated flush thread,
    so serialization of leaf *i+1* overlaps the disk write of leaf *i*.
    ``close`` appends a JSON **segment directory** plus a fixed trailer, so
    a reader can locate (and integrity-check) any segment without scanning
    the file.
  * :class:`AggregatedReader` — the decode side: parses the trailer once,
    then serves exact-range ``os.pread`` calls per segment — a restore that
    needs three leaves touches exactly three byte ranges.
  * the multi-host shard-set layer (:func:`shard_file_name`,
    :func:`stitch_shard_directories`, :class:`ShardSetReader`): per-host
    segment files stitched into one global view.

The directory is *additive*: the bytes before it are whatever the caller
streamed (e.g. a framed ``HPDS`` chunk stream, or back-to-back ``HPDR``
containers), so readers that predate the directory still parse the file as
a plain byte stream and simply ignore the trailer.

Trailer layout (fixed 24 bytes at EOF)::

    [directory JSON] [uint64 dir_offset] [uint64 dir_nbytes] [b"HPDRSEG1"]
"""

from __future__ import annotations

import json
import os
import threading
import zlib
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Any, Iterator

import numpy as np

TRAILER_MAGIC = b"HPDRSEG1"
_TRAILER_FIXED = 8 + 8 + len(TRAILER_MAGIC)
DIRECTORY_VERSION = 1
DEFAULT_ALIGN = 4096
DEFAULT_BUFFER = 4 << 20


def _container_error(msg: str) -> Exception:
    # runtime-layer module: core.container is imported lazily so importing
    # repro_torch.runtime.io never drags the whole core package (and torch)
    # in at module-import time
    from ..core.container import ContainerError

    return ContainerError(msg)


def align_up(n: int, align: int) -> int:
    return n if align <= 1 else -(-n // align) * align


def _pread_full(fd: int, nbytes: int, offset: int) -> bytes | bytearray:
    """Positional read of ``nbytes`` that survives short reads: one
    ``os.pread`` returns at most 0x7ffff000 bytes on Linux, so a segment
    past 2 GiB takes several.  Fewer bytes come back only at the end of the
    file (the caller reports the truncation)."""
    data = os.pread(fd, nbytes, offset)
    if len(data) == nbytes or not data:
        return data
    buf = bytearray(nbytes)
    got = len(data)
    buf[:got] = data
    del data
    while got < nbytes:
        part = os.pread(fd, nbytes - got, offset + got)
        if not part:
            return bytes(buf[:got])
        buf[got:got + len(part)] = part
        got += len(part)
    return buf


def _pwrite_full(fd: int, data: bytes, offset: int) -> None:
    """Positional write that survives short writes (signals, quotas, NFS).

    A partial transfer silently recorded as complete would only surface at
    restore time as a crc mismatch — after the data is already lost — so
    the writer loops until every byte lands and raises on a zero-progress
    write.
    """
    view = memoryview(data)
    while view:
        n = os.pwrite(fd, view, offset)
        if n <= 0:
            raise OSError(f"pwrite wrote {n} of {len(view)} bytes")
        view = view[n:]
        offset += n


#: Linux IOV_MAX is 1024; stay under it per gathered write
_IOV_MAX = 1024


def _pwritev_full(fd: int, buffers: list, offset: int) -> None:
    """Gathered positional write of a buffer list, zero intermediate copies.

    The coalescing buffer is a *list* of caller blobs (plus padding runs);
    joining them into one ``bytes`` before ``pwrite`` would memcpy the
    entire payload a second time.  ``os.pwritev`` writes the scatter list
    directly from the caller's buffers.  Short writes advance through the
    iovec (slicing only the one partially-written buffer); platforms
    without ``pwritev`` fall back to per-buffer ``pwrite``.
    """
    bufs = [memoryview(b) for b in buffers if len(b)]
    if not hasattr(os, "pwritev"):  # pragma: no cover - non-Linux fallback
        for b in bufs:
            _pwrite_full(fd, b, offset)
            offset += len(b)
        return
    while bufs:
        iov = bufs[:_IOV_MAX]
        n = os.pwritev(fd, iov, offset)
        if n <= 0:
            raise OSError(f"pwritev wrote {n} bytes")
        offset += n
        consumed = 0
        while iov and n >= len(iov[0]):
            n -= len(iov[0])
            iov.pop(0)
            consumed += 1
        del bufs[:consumed]
        if n:  # partial buffer: keep its unwritten tail at the head
            bufs[0] = bufs[0][n:]


class AggregatedWriter:
    """Coalescing aligned segment writer with an async flush lane.

    ``add(name, blob)`` assigns the blob the next ``align``-rounded offset
    and appends it (plus padding) to an in-memory write buffer; once the
    buffer exceeds ``buffer_bytes`` it is handed to the single flush thread
    as one positional ``pwrite`` — large, aligned, order-independent
    writes, which is what parallel filesystems reward.  ``parallel=False``
    degrades to synchronous writes (same bytes, same layout).

    ``meta`` rides in the directory verbatim (JSON-able) — stream headers,
    step numbers, anything a reader needs before touching segments.

    Durability knobs (both default off — pure streaming writers pay
    nothing):  ``fsync=True`` fsyncs the file (and, with ``atomic``, its
    parent directory) before close returns; ``atomic=True`` stages the
    whole file — data, directory, trailer — under a temp name and commits
    it with one ``os.replace``, so a crash mid-close never leaves ``path``
    parsing as a valid segment file with a stale or truncated directory.
    """

    def __init__(
        self,
        path: str | Path,
        *,
        align: int = DEFAULT_ALIGN,
        buffer_bytes: int = DEFAULT_BUFFER,
        parallel: bool = True,
        meta: dict | None = None,
        fsync: bool = False,
        atomic: bool = False,
    ):
        self.path = Path(path)
        self.align = max(1, int(align))
        self.buffer_bytes = int(buffer_bytes)
        self.meta = dict(meta or {})
        self.fsync = bool(fsync)
        self.atomic = bool(atomic)
        # atomic mode: every byte — data, directory, trailer — lands in a
        # temp file that is renamed over `path` only after a fully-written
        # (and optionally fsynced) trailer.  A crash mid-close can never
        # leave `path` parsing as a valid segment file with a stale or
        # partial directory: either the old file is intact or the new one
        # is complete.
        self._write_path = (
            self.path.with_name(f"{self.path.name}.tmp{os.getpid()}")
            if self.atomic
            else self.path
        )
        self._fd = os.open(
            str(self._write_path), os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644
        )
        self._offset = 0          # logical end-of-data offset
        # coalescing buffer: a LIST of caller blobs + padding runs, written
        # with one gathered pwritev per flush — zero intermediate memcpy
        # (the naive bytearray accumulator copied every payload byte twice
        # before the syscall, which on a page-cached filesystem cost more
        # than the syscalls it saved)
        self._buf: list[bytes] = []
        self._buf_len = 0
        self._buf_off = 0         # file offset of the buffer's first byte
        self._segments: dict[str, dict] = {}
        self._flusher: ThreadPoolExecutor | None = (
            ThreadPoolExecutor(1, thread_name_prefix="hpdr-io-flush")
            if parallel
            else None
        )
        self._pending: list[Future] = []
        self._lock = threading.Lock()
        self._closed = False
        self.stats = {"segments": 0, "data_bytes": 0, "pad_bytes": 0,
                      "writes": 0, "async_writes": 0}

    # ------------------------------------------------------------ write path

    def write_raw(self, raw: bytes) -> int:
        """Append unaligned preamble bytes (e.g. a stream header); returns
        the offset they were placed at.  Not recorded as a segment."""
        off = self._offset
        self._buf.append(bytes(raw))
        self._buf_len += len(raw)
        self._offset += len(raw)
        self._maybe_flush()
        return off

    def add(self, name: str, blob: bytes) -> int:
        """Append one named segment at the next aligned offset; returns the
        absolute file offset the segment starts at."""
        if self._closed:
            raise ValueError("writer is closed")
        if name in self._segments:
            raise ValueError(f"duplicate segment {name!r}")
        blob = bytes(blob)
        target = align_up(self._offset, self.align)
        pad = target - self._offset
        if pad:
            self._buf.append(b"\x00" * pad)
            self._buf_len += pad
            self.stats["pad_bytes"] += pad
        self._buf.append(blob)
        self._buf_len += len(blob)
        self._offset = target + len(blob)
        self._segments[name] = {
            "offset": target,
            "nbytes": len(blob),
            "crc32": zlib.crc32(blob) & 0xFFFFFFFF,
        }
        self.stats["segments"] += 1
        self.stats["data_bytes"] += len(blob)
        self._maybe_flush()
        return target

    def _maybe_flush(self) -> None:
        if self._buf_len >= self.buffer_bytes:
            self.flush()

    def flush(self) -> None:
        """Hand the current buffer list to the flush lane as one pwritev."""
        if not self._buf:
            return
        chunk, off = self._buf, self._buf_off
        self._buf = []
        self._buf_len = 0
        self._buf_off = self._offset
        self.stats["writes"] += 1
        if self._flusher is not None:
            self.stats["async_writes"] += 1
            self._pending.append(
                self._flusher.submit(_pwritev_full, self._fd, chunk, off)
            )
        else:
            _pwritev_full(self._fd, chunk, off)

    # -------------------------------------------------------------- lifecycle

    def directory(self) -> dict:
        return {
            "version": DIRECTORY_VERSION,
            "align": self.align,
            "segments": {k: dict(v) for k, v in self._segments.items()},
            "meta": self.meta,
        }

    def close(self) -> dict:
        """Flush everything, append directory + trailer; returns the
        directory dict (what :class:`AggregatedReader` will see)."""
        if self._closed:
            return self.directory()
        directory = self.directory()
        dbytes = json.dumps(directory).encode()
        trailer = (
            dbytes
            + np.uint64(self._offset).tobytes()
            + np.uint64(len(dbytes)).tobytes()
            + TRAILER_MAGIC
        )
        self._buf.append(trailer)
        self._buf_len += len(trailer)
        self._offset += len(trailer)
        self.flush()
        for f in self._pending:
            f.result()
        if self._flusher is not None:
            self._flusher.shutdown(wait=True)
        if self.fsync:
            os.fsync(self._fd)
        os.close(self._fd)
        if self.atomic:
            os.replace(self._write_path, self.path)
            if self.fsync:
                # the rename is only durable once the parent directory
                # entry is — fsync it so a crash cannot roll the commit back
                dfd = os.open(str(self.path.parent), os.O_RDONLY)
                try:
                    os.fsync(dfd)
                finally:
                    os.close(dfd)
        self._closed = True
        return directory

    def __enter__(self) -> "AggregatedWriter":
        return self

    def __exit__(self, exc_type, *exc) -> None:
        if exc_type is not None and not self._closed:
            # abandon WITHOUT writing a directory: a torn write must never
            # look like a committed file.  Queued flushes are cancelled but
            # a pwrite already running cannot be — drain the flush thread
            # before closing the fd, or the close races the in-flight
            # write (and a recycled fd number could corrupt another file).
            for f in self._pending:
                f.cancel()
            if self._flusher is not None:
                self._flusher.shutdown(wait=True)
            os.close(self._fd)
            if self.atomic:
                try:  # abandon the temp file; `path` was never touched
                    os.unlink(self._write_path)
                except OSError:
                    pass
            self._closed = True
            return
        self.close()


class AggregatedReader:
    """Exact-range ``pread`` access to an aggregated segment file."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self._fd = os.open(str(self.path), os.O_RDONLY)
        self._lock = threading.Lock()
        self._closed = False
        self.preads = 0  # observable for "reads exactly what it needs" tests
        self.pread_bytes = 0  # bytes actually fetched (progressive-prefix stat)
        try:
            self.directory = self._read_directory()
        except Exception:
            os.close(self._fd)
            self._closed = True
            raise
        self.segments: dict[str, dict] = self.directory["segments"]
        self.meta: dict = self.directory.get("meta", {})

    def _read_directory(self) -> dict:
        size = os.fstat(self._fd).st_size
        if size < _TRAILER_FIXED:
            raise _container_error(
                f"{self.path}: no segment directory (file too short)"
            )
        tail = os.pread(self._fd, _TRAILER_FIXED, size - _TRAILER_FIXED)
        if tail[-len(TRAILER_MAGIC):] != TRAILER_MAGIC:
            raise _container_error(
                f"{self.path}: no segment directory trailer"
            )
        dir_off = int(np.frombuffer(tail[:8], np.uint64)[0])
        dir_len = int(np.frombuffer(tail[8:16], np.uint64)[0])
        if dir_off + dir_len + _TRAILER_FIXED > size:
            raise _container_error(
                f"{self.path}: segment directory out of bounds"
            )
        raw = os.pread(self._fd, dir_len, dir_off)
        try:
            directory = json.loads(raw.decode())
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise _container_error(
                f"{self.path}: corrupt segment directory: {e}"
            ) from e
        if directory.get("version") != DIRECTORY_VERSION:
            raise _container_error(
                f"{self.path}: unsupported directory version "
                f"{directory.get('version')!r}"
            )
        return directory

    # ------------------------------------------------------------- read path

    def names(self) -> list[str]:
        return list(self.segments)

    def __contains__(self, name: str) -> bool:
        return name in self.segments

    def __iter__(self) -> Iterator[str]:
        return iter(self.segments)

    def pread(self, offset: int, nbytes: int) -> bytes | bytearray:
        raw = _pread_full(self._fd, nbytes, offset)
        with self._lock:
            self.preads += 1
            self.pread_bytes += len(raw)
        return raw

    def read(self, name: str, *, verify: bool = True) -> bytes:
        """One segment's exact bytes (crc-checked unless ``verify=False``)."""
        try:
            seg = self.segments[name]
        except KeyError:
            raise _container_error(
                f"{self.path}: no segment {name!r} in directory"
            ) from None
        raw = self.pread(int(seg["offset"]), int(seg["nbytes"]))
        if len(raw) != int(seg["nbytes"]):
            raise _container_error(
                f"{self.path}: segment {name!r} truncated "
                f"({len(raw)} bytes < {seg['nbytes']})"
            )
        if verify:
            crc = zlib.crc32(raw) & 0xFFFFFFFF
            if crc != int(seg["crc32"]):
                raise _container_error(
                    f"{self.path}: segment {name!r} crc32 {crc:#010x} != "
                    f"recorded {int(seg['crc32']):#010x}"
                )
        return raw

    # -------------------------------------------------------------- lifecycle

    def close(self) -> None:
        if not self._closed:
            os.close(self._fd)
            self._closed = True

    def __enter__(self) -> "AggregatedReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self) -> None:  # pragma: no cover - GC safety net
        try:
            self.close()
        except Exception:
            pass


def has_directory(path: str | Path) -> bool:
    """Cheap probe: does ``path`` end in an aggregated-segment trailer?"""
    try:
        size = os.path.getsize(path)
        if size < _TRAILER_FIXED:
            return False
        with open(path, "rb") as f:
            f.seek(size - len(TRAILER_MAGIC))
            return f.read(len(TRAILER_MAGIC)) == TRAILER_MAGIC
    except OSError:
        return False


# ---------------------------------------------------------------------------
# multi-host shard sets (per-host aggregated files + global manifest)
# ---------------------------------------------------------------------------


def shard_file_name(host_id: int) -> str:
    """Canonical per-host shard file name: ``leaves-<host>.hpdr``."""
    return f"leaves-{int(host_id):04d}.hpdr"


def stitch_shard_directories(
    directory: str | Path, shard_files: dict[str, str]
) -> dict:
    """Merge per-host shard segment directories into one global view.

    The coordinator's half of the multi-host save: opens each host's shard
    (trailer parse only — zero segment preads), validates it, and returns::

        {"shards": {host: {"file", "segments": {...}, "meta": {...}}},
         "segments": total, "data_bytes": total}

    Any shard whose trailer is missing/corrupt raises ``ContainerError``
    naming that shard — a torn host write fails the global commit loudly.
    """
    directory = Path(directory)
    out: dict = {"shards": {}, "segments": 0, "data_bytes": 0}
    for host, fname in sorted(shard_files.items(), key=lambda kv: str(kv[0])):
        with AggregatedReader(directory / fname) as r:
            segs = {k: dict(v) for k, v in r.segments.items()}
            out["shards"][str(host)] = {
                "file": fname,
                "segments": segs,
                "meta": dict(r.meta),
            }
            out["segments"] += len(segs)
            out["data_bytes"] += sum(int(s["nbytes"]) for s in segs.values())
    return out


class ShardSetReader:
    """Topology-aware reads across a set of per-host shard files.

    ``local`` names the shard owned by the calling host (or ``None`` when
    the reader has no locality — e.g. a single-process restore of a
    multi-host checkpoint).  Shards open *lazily*: a restore scoped to
    healthy shards never touches a corrupt one, and a same-topology restore
    opens exactly its local shard.  ``stats`` is the observable the
    locality tests assert on::

        {"local_preads": n, "cross_preads": n,
         "local_bytes": n, "cross_bytes": n,
         "shards_opened": [...], "preads_by_shard": {shard: n}}
    """

    def __init__(
        self,
        directory: str | Path,
        shard_files: dict[str, str],
        *,
        local: str | None = None,
    ):
        self.directory = Path(directory)
        self.shard_files = {str(k): v for k, v in shard_files.items()}
        self.local = str(local) if local is not None else None
        self._readers: dict[str, AggregatedReader] = {}
        self.stats: dict = {
            "local_preads": 0,
            "cross_preads": 0,
            "local_bytes": 0,
            "cross_bytes": 0,
            "shards_opened": [],
            "preads_by_shard": {},
        }

    def reader(self, shard: str) -> AggregatedReader:
        shard = str(shard)
        r = self._readers.get(shard)
        if r is None:
            fname = self.shard_files.get(shard)
            if fname is None:
                raise _container_error(
                    f"{self.directory}: no shard {shard!r} in manifest "
                    f"(shards: {sorted(self.shard_files)})"
                )
            r = AggregatedReader(self.directory / fname)
            self._readers[shard] = r
            self.stats["shards_opened"].append(shard)
        return r

    def read(self, shard: str, name: str, *, verify: bool = True) -> bytes:
        shard = str(shard)
        raw = self.reader(shard).read(name, verify=verify)
        local = shard == self.local
        self.stats["local_preads" if local else "cross_preads"] += 1
        self.stats["local_bytes" if local else "cross_bytes"] += len(raw)
        by = self.stats["preads_by_shard"]
        by[shard] = by.get(shard, 0) + 1
        return raw

    def close(self) -> None:
        for r in self._readers.values():
            r.close()
        self._readers.clear()

    def __enter__(self) -> "ShardSetReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def serialization_probe(
    nbytes: int,
    *,
    repeat: int = 3,
    clock=None,
) -> float:
    """Measure the host serialization cost the writer pays per segment.

    Times exactly the per-``add`` host work of :class:`AggregatedWriter` —
    a crc32 pass plus a copy into the (aligned) coalescing buffer — over a
    ``nbytes`` payload, best-of-``repeat``.  The calibration layer
    (``runtime/calibrate.py``) uses this to separate wire-framing cost
    from codec D2H cost when fitting the io-lane model.

    ``clock`` defaults to ``time.perf_counter``; tests inject a stub.
    Returns seconds (≥ 1 ns to keep downstream throughput fits finite).
    """
    import time as _time

    clock = clock or _time.perf_counter
    payload = np.random.default_rng(0).integers(
        0, 256, size=max(int(nbytes), 1), dtype=np.uint8
    ).tobytes()
    buf = bytearray(align_up(len(payload), DEFAULT_ALIGN))
    best = float("inf")
    for _ in range(max(1, int(repeat))):
        t0 = clock()
        zlib.crc32(payload)
        buf[: len(payload)] = payload
        t1 = clock()
        best = min(best, t1 - t0)
    return max(best, 1e-9)
