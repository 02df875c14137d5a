"""Portable HPDR byte container (v1 + v2) for compressed objects.

A copy of ``repro.core.container`` (pure numpy + json): the port writes the
same bytes and parses the reference's, without importing it.

A :class:`Compressed` is the method-tagged result of any registered codec:
JSON-able ``meta`` plus named numpy ``arrays`` (the sections).  The byte
layout is what the checkpoint manager, the serving engine's parked KV pages,
and the I/O benchmarks read and write.

v2 layout (written by default)::

    offset 0   magic  b"HPDR"
           4   uint32 version (= 2)
           8   uint64 header length H
          16   header JSON:
                 method, meta,
                 sections: {name: {dtype, shape, offset, nbytes}},
                 payload_bytes, crc32        # crc32 of the whole payload
        16+H   payload — sections back-to-back at their recorded offsets

Per-section offsets make single-section reads (e.g. a progressive prefix or
one array of a large stream) possible without parsing the other sections,
and the checksum turns torn writes into loud :class:`ValueError`s instead of
silently corrupt tensors.

v1 (the seed format: sorted sections, implicit offsets, no checksum) is
still read transparently; ``to_bytes(version=1)`` can still write it for
compatibility tests.  Unknown versions, truncated streams, and checksum
mismatches raise :class:`ContainerError` (a ``ValueError`` subclass) — the
version field is never ignored, and corruption is never silently decoded.
"""

from __future__ import annotations

import io
import json
import math
import zlib
from dataclasses import dataclass
from typing import Any

import numpy as np

MAGIC = b"HPDR"
CONTAINER_VERSION = 2
_HEADER_FIXED = 16  # magic + version + header-length words


class ContainerError(ValueError):
    """A malformed, truncated, or corrupt HPDR byte stream.

    Raised by every container/stream parser in the framework — a reader can
    catch this one type to handle any torn write, bit flip, or version
    mismatch.  Subclasses :class:`ValueError` so callers of the historical
    API keep working.
    """


def crc32_of(data: bytes | bytearray | memoryview) -> int:
    """The framework's canonical checksum: unsigned crc32 of ``data``.

    Shared by the container payload/section checksums, the aggregated-file
    segment directory, and the serving wire protocol's frame integrity
    field — one function so every layer hashes (and prints) checksums the
    same way.
    """
    return zlib.crc32(data) & 0xFFFFFFFF


def check_crc32(
    data: bytes | bytearray | memoryview,
    recorded: int,
    what: str,
    exc: type[Exception] = ContainerError,
) -> None:
    """Verify ``data`` against a recorded crc32; raise ``exc`` naming ``what``.

    The error message always carries both checksums in ``0x``-hex — torn
    writes and bit flips surface as loud, greppable mismatches rather than
    silently corrupt tensors (or, on the wire, silently corrupt frames).
    """
    crc = crc32_of(data)
    if crc != int(recorded):
        raise exc(
            f"corrupt {what}: crc32 {crc:#010x} != recorded {int(recorded):#010x}"
        )


def _bytes_view(a: Any) -> memoryview:
    """The bytes of ``a`` in C order (``tobytes()``'s), as a flat view; a
    copy only where ``a`` is not C-contiguous."""
    a = np.ascontiguousarray(a)
    return memoryview(a.reshape(-1).view(np.uint8))


def _frozen_view(raw: Any) -> memoryview:
    """A flat byte view of ``raw`` that nothing can change under it: of
    ``raw`` itself where it is ``bytes`` or a view of ``bytes``, else of a
    ``bytes`` copy (a ``bytearray`` or a reused buffer may be written
    after the parse)."""
    if isinstance(raw, memoryview) and isinstance(raw.obj, bytes):
        return raw.cast("B")
    return memoryview(raw if isinstance(raw, bytes) else bytes(raw))


def _jsonable(d: dict) -> dict:
    out = {}
    for k, v in d.items():
        if isinstance(v, (np.integer,)):
            v = int(v)
        elif isinstance(v, (np.floating,)):
            v = float(v)
        elif isinstance(v, tuple):
            v = list(v)
        out[k] = v
    return out


@dataclass
class Compressed:
    """Method-tagged compressed object with byte (de)serialization."""

    method: str
    meta: dict[str, Any]
    arrays: dict[str, np.ndarray]

    def nbytes(self) -> int:
        return sum(a.nbytes for a in self.arrays.values())

    def ratio(self) -> float:
        name = self.meta["dtype"]  # numpy knows bfloat16 only through ml_dtypes
        itemsize = 2 if name == "bfloat16" else np.dtype(name).itemsize
        orig = math.prod(self.meta["shape"]) * itemsize
        return orig / max(self.nbytes(), 1)

    # -- portable byte format (used by checkpoint/I-O layers) ---------------

    def to_bytes(self, version: int = CONTAINER_VERSION) -> bytes:
        if version == 1:
            return self._to_bytes_v1()
        if version != 2:
            raise ValueError(f"cannot write container version {version}")
        names = sorted(self.arrays)
        sections: dict[str, dict] = {}
        # the sections' bytes are views, checksummed in place and copied
        # once, into the result: a checkpoint's containers are host-bound
        parts, offset, crc = [], 0, 0
        for n in names:
            raw = _bytes_view(self.arrays[n])
            sections[n] = {
                "dtype": str(self.arrays[n].dtype),
                "shape": list(self.arrays[n].shape),
                "offset": offset,
                "nbytes": raw.nbytes,
                # per-section checksum (additive): lets a reader verify and
                # decode one section — e.g. a progressive component prefix —
                # without touching the rest of the payload
                "crc32": zlib.crc32(raw) & 0xFFFFFFFF,
            }
            crc = zlib.crc32(raw, crc)  # the payload's, section after section
            parts.append(raw)
            offset += raw.nbytes
        header = {
            "method": self.method,
            "meta": _jsonable(self.meta),
            "sections": sections,
            "payload_bytes": offset,
            "crc32": crc & 0xFFFFFFFF,
        }
        hbytes = json.dumps(header).encode()
        return b"".join([MAGIC, np.uint32(2).tobytes(), np.uint64(len(hbytes)).tobytes(),
                         hbytes, *parts])

    def _to_bytes_v1(self) -> bytes:
        buf = io.BytesIO()
        names = sorted(self.arrays)
        header = {
            "method": self.method,
            "meta": _jsonable(self.meta),
            "arrays": {
                n: {"dtype": str(self.arrays[n].dtype), "shape": list(self.arrays[n].shape)}
                for n in names
            },
        }
        hbytes = json.dumps(header).encode()
        buf.write(MAGIC)
        buf.write(np.uint32(1).tobytes())
        buf.write(np.uint64(len(hbytes)).tobytes())
        buf.write(hbytes)
        for n in names:
            buf.write(np.ascontiguousarray(self.arrays[n]).tobytes())
        return buf.getvalue()

    @classmethod
    def from_bytes(cls, raw: bytes) -> "Compressed":
        """Parse a container.  The arrays are read-only views of ``raw``
        where it is ``bytes`` (or a view of ``bytes``), else of a copy."""
        raw = _frozen_view(raw)
        if len(raw) < _HEADER_FIXED:
            raise ContainerError(
                f"truncated HPDR stream: {len(raw)} bytes < {_HEADER_FIXED}-byte header"
            )
        if raw[:4] != MAGIC:
            raise ContainerError("not an HPDR stream")
        version = int(np.frombuffer(raw[4:8], np.uint32)[0])
        if version not in (1, 2):
            raise ContainerError(
                f"unsupported HPDR container version {version} (supported: 1, 2)"
            )
        hlen = int(np.frombuffer(raw[8:16], np.uint64)[0])
        if len(raw) < _HEADER_FIXED + hlen:
            raise ContainerError("truncated HPDR stream: incomplete header")
        try:
            header = json.loads(bytes(raw[_HEADER_FIXED : _HEADER_FIXED + hlen]).decode())
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise ContainerError(f"corrupt HPDR header: {e}") from e
        if version == 1:
            return cls._from_bytes_v1(raw, header, _HEADER_FIXED + hlen)
        return cls._from_bytes_v2(raw, header, _HEADER_FIXED + hlen)

    @classmethod
    def _from_bytes_v1(cls, raw: bytes, header: dict, off: int) -> "Compressed":
        arrays = {}
        for n in sorted(header["arrays"]):
            spec = header["arrays"][n]
            dt = np.dtype(spec["dtype"])
            count = math.prod(spec["shape"]) if spec["shape"] else 1
            nb = count * dt.itemsize
            if off + nb > len(raw):
                raise ContainerError(
                    f"truncated HPDR stream: section {n!r} needs {nb} bytes "
                    f"at offset {off}, stream has {len(raw)}"
                )
            arrays[n] = np.frombuffer(raw[off : off + nb], dt).reshape(spec["shape"])
            off += nb
        return cls(method=header["method"], meta=header["meta"], arrays=arrays)

    @classmethod
    def _from_bytes_v2(cls, raw: bytes, header: dict, base: int) -> "Compressed":
        pbytes = header["payload_bytes"]
        if base + pbytes > len(raw):
            raise ContainerError(
                f"truncated HPDR stream: payload needs {pbytes} bytes, "
                f"stream has {len(raw) - base} after header"
            )
        payload = raw[base : base + pbytes]
        check_crc32(payload, header["crc32"], "HPDR payload")
        arrays = {}
        for n, spec in header["sections"].items():
            dt = np.dtype(spec["dtype"])
            lo, hi = spec["offset"], spec["offset"] + spec["nbytes"]
            if hi > pbytes:
                raise ContainerError(f"corrupt HPDR stream: section {n!r} out of bounds")
            arrays[n] = np.frombuffer(payload[lo:hi], dt).reshape(spec["shape"])
        return cls(method=header["method"], meta=header["meta"], arrays=arrays)


# ---------------------------------------------------------------------------
# partial reads: header peek + single-section fetch
# ---------------------------------------------------------------------------


def peek_header(raw: bytes) -> tuple[dict, int]:
    """Parse a v2 container's header without touching the payload.

    Returns ``(header, payload_base)``.  Only v2 streams carry a section
    directory with offsets; v1 streams raise — callers wanting v1 compat go
    through :meth:`Compressed.from_bytes`.
    """
    raw = bytes(raw)
    if len(raw) < _HEADER_FIXED:
        raise ContainerError(
            f"truncated HPDR stream: {len(raw)} bytes < {_HEADER_FIXED}-byte header"
        )
    if raw[:4] != MAGIC:
        raise ContainerError("not an HPDR stream")
    version = int(np.frombuffer(raw[4:8], np.uint32)[0])
    if version != 2:
        raise ContainerError(
            f"HPDR container version {version} has no section directory "
            "(partial reads need v2)"
        )
    hlen = int(np.frombuffer(raw[8:16], np.uint64)[0])
    if len(raw) < _HEADER_FIXED + hlen:
        raise ContainerError("truncated HPDR stream: incomplete header")
    try:
        header = json.loads(raw[_HEADER_FIXED : _HEADER_FIXED + hlen].decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ContainerError(f"corrupt HPDR header: {e}") from e
    return header, _HEADER_FIXED + hlen


def read_section_bytes(raw: bytes, name: str) -> bytes:
    """One section's exact payload bytes, verified without a full-payload scan.

    Sections written with a per-section ``crc32`` entry are checked alone —
    the bytes of other sections are never hashed or required to be intact.
    Index-less older v2 streams (no per-section checksum) fall back to one
    whole-payload crc verification on the host.  Corruption raises
    :class:`ContainerError` naming the section.
    """
    header, base = peek_header(raw)
    sec = header["sections"].get(name)
    if sec is None:
        raise ContainerError(f"no section {name!r} in HPDR stream")
    lo, hi = base + int(sec["offset"]), base + int(sec["offset"]) + int(sec["nbytes"])
    if hi > len(raw):
        raise ContainerError(
            f"truncated HPDR stream: section {name!r} needs bytes "
            f"[{lo}:{hi}), stream has {len(raw)}"
        )
    blob = raw[lo:hi]
    if "crc32" in sec:
        check_crc32(blob, sec["crc32"], f"HPDR section {name!r}")
        return blob
    # host fallback for streams predating per-section checksums: the only
    # integrity record is the whole-payload crc32, so verify that once
    pbytes = int(header["payload_bytes"])
    if base + pbytes > len(raw):
        raise ContainerError(
            f"truncated HPDR stream: payload needs {pbytes} bytes, "
            f"stream has {len(raw) - base} after header"
        )
    payload = raw[base : base + pbytes]
    check_crc32(
        payload, header["crc32"], f"HPDR payload (verifying section {name!r})"
    )
    return blob


def read_section(raw: bytes, name: str) -> np.ndarray:
    """Like :func:`read_section_bytes`, shaped as the recorded array."""
    header, _ = peek_header(raw)
    sec = header["sections"].get(name)
    if sec is None:
        raise ContainerError(f"no section {name!r} in HPDR stream")
    blob = read_section_bytes(raw, name)
    return np.frombuffer(blob, np.dtype(sec["dtype"])).reshape(sec["shape"])
