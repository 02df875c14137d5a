"""HPDR serving wire protocol: length-prefixed binary frames (counterpart of
``repro.serving.protocol``: the same frames and payloads, byte for byte, so
a client of either package drives a server of the other).

The reduction service (:mod:`repro_torch.serving.service`) scales within one
process; this module defines the byte protocol that lets *independent*
client processes — e.g. the per-host writers of the paper's Figs. 15/17/18
— share one engine through :class:`~repro_torch.serving.server.ReductionServer`.
Every message is one frame::

    offset 0   uint32  frame_len      # bytes that follow (length prefix)
           4   magic   b"HPRW"
           8   uint16  version (= 1)
          10   uint16  opcode
          12   uint64  request_id     # echoed verbatim on the response
          20   uint16  tenant_len
          22   uint16  flags          # bit 0: response is an error detail
          24   uint32  payload crc32
          28   tenant  utf-8 (tenant_len bytes)
     28+tlen   payload (frame_len - 24 - tenant_len bytes)

Validation mirrors the byte container's (:mod:`repro_torch.core.container`):
every field is checked on parse and failures raise a *typed*
:class:`ProtocolError` that names the offending field (``magic``,
``version``, ``opcode``, ``length``, ``tenant``, ``crc32``, ``payload``,
``truncated``, ``request_id``) — a fuzzer mutating any byte of a frame gets
a loud, field-attributed error, never a hang or a silently mis-parsed
request.  The crc32 is :func:`repro_torch.core.container.crc32_of` — the same
checksum (and the same mismatch wording) the container format uses.

Payloads are either raw bytes (opcode-defined), a JSON object, or the
*flat-dict* encoding produced by :func:`dumps_payload`: a JSON directory of
``(key, kind, offset, nbytes)`` entries followed by the concatenated blobs,
where each entry is an HPDR container (``kind="hpdr"``), an ``.npy`` array
(``"npy"``), or opaque bytes (``"bytes"``).  This is what carries pytrees
of arrays and compressed containers across the socket byte-identically.

A torch tensor in a payload goes to host numpy first (on the card, a D2H
copy).  A bfloat16 leaf is written as the reference writes its ``ml_dtypes``
arrays: ``.npy`` descr ``'<V2'`` over the raw 16-bit words, which numpy
reads back as an opaque ``|V2`` array (see :func:`npy_bytes`).
"""

from __future__ import annotations

import io
import json
import struct
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from ..core.container import Compressed, ContainerError, crc32_of

MAGIC = b"HPRW"
PROTOCOL_VERSION = 1

# Default ceiling on one frame's body.  A length prefix beyond the limit is
# rejected *before* any allocation — an adversarial (or bit-flipped) prefix
# cannot make the server reserve gigabytes or stall reading a frame that
# will never arrive.
MAX_FRAME_BYTES = 1 << 30

_PREFIX = struct.Struct("<I")
_HEADER = struct.Struct("<4sHHQHHI")
HEADER_BYTES = _HEADER.size  # 24

# request opcodes
OP_PING = 0x01
OP_COMPRESS = 0x02
OP_DECOMPRESS = 0x03
OP_COMPRESS_STREAM = 0x04
OP_DECOMPRESS_STREAM = 0x05
OP_QUICKLOOK = 0x06
OP_FETCH_KV = 0x07
OP_PARK_KV = 0x08
OP_RELEASE_KV = 0x09
OP_STATS = 0x0A
# response opcodes
OP_OK = 0x80
OP_ERROR = 0x81

OPCODE_NAMES = {
    OP_PING: "ping",
    OP_COMPRESS: "compress",
    OP_DECOMPRESS: "decompress",
    OP_COMPRESS_STREAM: "compress_stream",
    OP_DECOMPRESS_STREAM: "decompress_stream",
    OP_QUICKLOOK: "quicklook",
    OP_FETCH_KV: "fetch_kv",
    OP_PARK_KV: "park_kv",
    OP_RELEASE_KV: "release_kv",
    OP_STATS: "stats",
    OP_OK: "ok",
    OP_ERROR: "error",
}

FLAG_ERROR = 0x1


class ProtocolError(ContainerError):
    """A malformed, truncated, or corrupt wire frame.

    ``field`` names the frame field that failed validation — fuzz tests
    assert on it, and operators can aggregate protocol errors by field.
    Subclasses :class:`~repro_torch.core.container.ContainerError` so one
    ``except`` arm covers corruption at every layer (file, container,
    wire).
    """

    def __init__(self, message: str, *, field: str):
        super().__init__(f"{message} [field={field}]")
        self.field = field


@dataclass
class Frame:
    """One parsed wire frame."""

    opcode: int
    request_id: int
    payload: bytes = b""
    tenant: str = "default"
    flags: int = 0

    @property
    def opcode_name(self) -> str:
        return OPCODE_NAMES.get(self.opcode, f"0x{self.opcode:02x}")


def encode_frame(
    opcode: int,
    request_id: int,
    payload: bytes = b"",
    *,
    tenant: str = "default",
    flags: int = 0,
) -> bytes:
    """Serialise one frame, length prefix included."""
    if opcode not in OPCODE_NAMES:
        raise ProtocolError(f"unknown opcode 0x{opcode:02x}", field="opcode")
    tenant_b = tenant.encode("utf-8")
    if len(tenant_b) > 0xFFFF:
        raise ProtocolError(
            f"tenant name too long ({len(tenant_b)} bytes)", field="tenant"
        )
    header = _HEADER.pack(
        MAGIC, PROTOCOL_VERSION, opcode, request_id,
        len(tenant_b), flags, crc32_of(payload),
    )
    body = header + tenant_b + payload
    return _PREFIX.pack(len(body)) + body


def parse_frame(body: bytes, *, max_frame: int = MAX_FRAME_BYTES) -> Frame:
    """Parse one frame *body* (the bytes after the length prefix).

    Every field is validated; any mutation of a valid frame — truncation,
    bit flips in magic/version/opcode/tenant-length, a tampered checksum or
    payload — raises :class:`ProtocolError` naming the field.
    """
    if len(body) > max_frame:
        raise ProtocolError(
            f"frame body {len(body)} bytes exceeds limit {max_frame}",
            field="length",
        )
    if len(body) < HEADER_BYTES:
        raise ProtocolError(
            f"truncated frame: {len(body)} bytes < {HEADER_BYTES}-byte header",
            field="truncated",
        )
    magic, version, opcode, request_id, tenant_len, flags, crc = _HEADER.unpack(
        body[:HEADER_BYTES]
    )
    if magic != MAGIC:
        raise ProtocolError(f"bad frame magic {magic!r}", field="magic")
    if version != PROTOCOL_VERSION:
        raise ProtocolError(
            f"unsupported wire protocol version {version} "
            f"(speaking {PROTOCOL_VERSION})",
            field="version",
        )
    def _err(message: str, field: str) -> ProtocolError:
        # past the fixed header the request id is trustworthy enough to
        # address an error response to — attach it for the server
        e = ProtocolError(message, field=field)
        e.request_id = request_id
        return e

    if opcode not in OPCODE_NAMES:
        raise _err(f"unknown opcode 0x{opcode:02x}", field="opcode")
    if HEADER_BYTES + tenant_len > len(body):
        raise _err(
            f"tenant field ({tenant_len} bytes) overruns frame "
            f"({len(body)} bytes)",
            field="tenant",
        )
    try:
        tenant = body[HEADER_BYTES : HEADER_BYTES + tenant_len].decode("utf-8")
    except UnicodeDecodeError as e:
        raise _err(f"tenant is not valid utf-8: {e}", field="tenant") from e
    payload = body[HEADER_BYTES + tenant_len :]
    actual = crc32_of(payload)
    if actual != crc:
        raise _err(
            f"corrupt frame payload: crc32 {actual:#010x} != recorded "
            f"{crc:#010x}",
            field="crc32",
        )
    return Frame(
        opcode=opcode, request_id=request_id, payload=payload,
        tenant=tenant, flags=flags,
    )


def read_length_prefix(prefix: bytes, *, max_frame: int = MAX_FRAME_BYTES) -> int:
    """Validate a 4-byte length prefix; returns the frame body length.

    An oversized (or zero/undersized) prefix is rejected here, before any
    buffer is allocated for the body.
    """
    if len(prefix) != _PREFIX.size:
        raise ProtocolError(
            f"truncated length prefix ({len(prefix)} bytes)", field="truncated"
        )
    (n,) = _PREFIX.unpack(prefix)
    if n < HEADER_BYTES:
        raise ProtocolError(
            f"length prefix {n} smaller than the {HEADER_BYTES}-byte header",
            field="length",
        )
    if n > max_frame:
        raise ProtocolError(
            f"length prefix {n} exceeds frame limit {max_frame}", field="length"
        )
    return n


def recv_exact(sock, n: int) -> bytes | None:
    """Read exactly ``n`` bytes from a socket.

    Returns ``None`` on a clean EOF *before any byte* (peer closed between
    frames); raises :class:`ProtocolError` (``field="truncated"``) if the
    stream ends mid-read — a torn frame.
    """
    chunks: list[bytes] = []
    got = 0
    while got < n:
        chunk = sock.recv(min(n - got, 1 << 20))
        if not chunk:
            if got == 0:
                return None
            raise ProtocolError(
                f"connection closed mid-frame: got {got} of {n} bytes",
                field="truncated",
            )
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def recv_frame(sock, *, max_frame: int = MAX_FRAME_BYTES) -> Frame | None:
    """Read one frame from a blocking socket; ``None`` on clean EOF."""
    prefix = recv_exact(sock, _PREFIX.size)
    if prefix is None:
        return None
    n = read_length_prefix(prefix, max_frame=max_frame)
    body = recv_exact(sock, n)
    if body is None:
        raise ProtocolError(
            "connection closed between length prefix and frame body",
            field="truncated",
        )
    return parse_frame(body, max_frame=max_frame)


# ---------------------------------------------------------------------------
# payload encodings
# ---------------------------------------------------------------------------


def _deep_jsonable(obj: Any) -> Any:
    if isinstance(obj, dict):
        return {str(k): _deep_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_deep_jsonable(v) for v in obj]
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, (np.bool_,)):
        return bool(obj)
    return obj


def dumps_json(obj: Any) -> bytes:
    return json.dumps(_deep_jsonable(obj)).encode("utf-8")


def loads_json(payload: bytes) -> Any:
    try:
        return json.loads(payload.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ProtocolError(f"corrupt JSON payload: {e}", field="payload") from e


def npy_bytes(val: Any) -> bytes:
    """``np.save`` bytes of ``val`` (an array, or a tensor on the host or the
    card), as the reference writes them.

    The reference saves a bfloat16 array through ``ml_dtypes``, whose
    dtype's numpy descr is ``'<V2'``; numpy without ``ml_dtypes`` has no
    such dtype, so the port saves the 16-bit words as ``int16`` and writes
    ``'<V2'`` in place of ``'<i2'`` (same length: the header's padding, and
    so every byte, is the reference's).
    """
    if isinstance(val, torch.Tensor):
        bf16 = val.dtype == torch.bfloat16
        t = val.detach().view(torch.int16) if bf16 else val.detach()
        arr = t.contiguous().cpu().numpy()
    else:
        arr = np.asarray(val)
        bf16 = arr.dtype.name == "bfloat16"  # an ml_dtypes array
        if bf16:
            arr = arr.view(np.int16)
    buf = io.BytesIO()
    np.save(buf, arr, allow_pickle=False)
    raw = buf.getvalue()
    if bf16:  # format 1.0: a uint16 header length at 8; 2.0+: a uint32
        end = (10 + struct.unpack_from("<H", raw, 8)[0] if raw[6] == 1
               else 12 + struct.unpack_from("<I", raw, 8)[0])
        raw = raw[:end].replace(b"'descr': '<i2'", b"'descr': '<V2'", 1) + raw[end:]
    return raw


def dumps_payload(
    entries: dict[str, Any] | None = None, extra: dict | None = None
) -> bytes:
    """Flat-dict payload: JSON directory + concatenated per-entry blobs.

    ``entries`` values may be :class:`~repro_torch.core.container.Compressed`
    (serialised with :meth:`to_bytes` — the wire carries the *container
    bytes*, so socket and in-process results compare byte-identical),
    numpy arrays or torch tensors (``.npy``, see :func:`npy_bytes`), or raw
    ``bytes``.  ``extra`` is an arbitrary
    JSON-able side dict (request kwargs, response stats).
    """
    dir_entries, blobs = [], []
    off = 0
    for key, val in (entries or {}).items():
        if isinstance(val, Compressed):
            kind, blob = "hpdr", val.to_bytes()
        elif isinstance(val, (bytes, bytearray, memoryview)):
            kind, blob = "bytes", bytes(val)
        else:
            kind, blob = "npy", npy_bytes(val)
        dir_entries.append(
            {"key": key, "kind": kind, "offset": off, "nbytes": len(blob)}
        )
        off += len(blob)
        blobs.append(blob)
    header = dumps_json({"entries": dir_entries, "extra": extra or {}})
    out = io.BytesIO()
    out.write(_PREFIX.pack(len(header)))
    out.write(header)
    for blob in blobs:
        out.write(blob)
    return out.getvalue()


def loads_payload(payload: bytes) -> tuple[dict[str, Any], dict]:
    """Parse a :func:`dumps_payload` blob → ``(entries, extra)``.

    Corruption — truncated directory, out-of-bounds entry, un-parseable
    container/array blob — raises :class:`ProtocolError`
    (``field="payload"``).
    """
    if len(payload) < _PREFIX.size:
        raise ProtocolError(
            f"flat payload truncated at {len(payload)} bytes", field="payload"
        )
    (hlen,) = _PREFIX.unpack(payload[: _PREFIX.size])
    base = _PREFIX.size + hlen
    if base > len(payload):
        raise ProtocolError(
            f"flat payload directory ({hlen} bytes) overruns payload "
            f"({len(payload)} bytes)",
            field="payload",
        )
    header = loads_json(payload[_PREFIX.size : base])
    try:
        dir_entries = header["entries"]
        extra = header["extra"]
    except (TypeError, KeyError) as e:
        raise ProtocolError(
            f"flat payload directory missing {e}", field="payload"
        ) from e
    flat: dict[str, Any] = {}
    for entry in dir_entries:
        try:
            key, kind = entry["key"], entry["kind"]
            lo = base + int(entry["offset"])
            hi = lo + int(entry["nbytes"])
        except (TypeError, KeyError, ValueError) as e:
            raise ProtocolError(
                f"malformed flat payload entry {entry!r}: {e}", field="payload"
            ) from e
        if hi > len(payload) or lo < base:
            raise ProtocolError(
                f"flat payload entry {key!r} [{lo}:{hi}) out of bounds "
                f"({len(payload)} bytes)",
                field="payload",
            )
        blob = payload[lo:hi]
        try:
            if kind == "hpdr":
                flat[key] = Compressed.from_bytes(blob)
            elif kind == "npy":
                flat[key] = np.load(io.BytesIO(blob), allow_pickle=False)
            elif kind == "bytes":
                flat[key] = blob
            else:
                raise ValueError(f"unknown entry kind {kind!r}")
        except ProtocolError:
            raise
        except Exception as e:
            raise ProtocolError(
                f"corrupt flat payload entry {key!r} ({kind}): {e}",
                field="payload",
            ) from e
    return flat, extra


def error_payload(exc: BaseException) -> bytes:
    """Serialise an exception for an ``OP_ERROR`` response frame."""
    message = str(exc)
    fld = getattr(exc, "field", None)
    if fld is not None and message.endswith(f" [field={fld}]"):
        # strip the rendered suffix: the client re-raises with the same
        # field and would otherwise double it
        message = message[: -len(f" [field={fld}]")]
    detail: dict[str, Any] = {"error": type(exc).__name__, "message": message}
    if fld is not None:
        detail["field"] = fld
    return dumps_json(detail)


def raise_error_payload(payload: bytes) -> None:
    """Re-raise a server-side error from an ``OP_ERROR`` payload.

    Known types map back to their client-visible classes:
    :class:`ProtocolError` (with its ``field``),
    :class:`~repro_torch.serving.service.ServiceOverloaded`, and
    :class:`~repro_torch.core.container.ContainerError`; anything else surfaces
    as ``RuntimeError`` with the server-side type name prefixed.
    """
    from .service import ServiceOverloaded  # cycle-free at call time

    detail = loads_json(payload)
    name = detail.get("error", "RuntimeError")
    message = detail.get("message", "remote error")
    if name == "ProtocolError":
        raise ProtocolError(message, field=detail.get("field", "unknown"))
    if name == "ServiceOverloaded":
        raise ServiceOverloaded(message)
    if name == "ContainerError":
        raise ContainerError(message)
    raise RuntimeError(f"{name}: {message}")
