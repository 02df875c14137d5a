"""The port's wire protocol (``repro_torch.serving.protocol``) against the
reference's (``repro.serving.protocol``).

Frames, flat payloads and error payloads must be byte-identical for the
same inputs, each package must parse the other's, and every mutation of a
frame or payload must give the same outcome in both: a clean parse with the
same fields, or a ``ProtocolError`` naming the same field.  A bfloat16 leaf
is written as the reference's ``ml_dtypes`` array is (``.npy`` descr
``'<V2'``) and reads back, in both packages, as an opaque ``|V2`` array.
"""

import random
import socket
import struct

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import api as japi
from repro.core.container import Compressed as JCompressed
from repro.serving import protocol as JP
from repro.serving.service import ServiceOverloaded as JOverloaded
from repro_torch.core import api as tapi
from repro_torch.core.container import Compressed, ContainerError
from repro_torch.serving import protocol as P
from repro_torch.serving.service import ServiceOverloaded

TIMEOUT = 30.0

FRAME_CASES = [
    (P.OP_PING, 0, b"", "default", 0),
    (P.OP_COMPRESS, 42, b"xyz", "t0", 0),
    (P.OP_STATS, 2**64 - 1, b"\x00" * 1000, "", 0),
    (P.OP_PARK_KV, 7, bytes(range(256)), "tenant-ü", 0),
    (P.OP_ERROR, 9, b'{"error": "x"}', "", P.FLAG_ERROR),
    (P.OP_OK, 1, b"p" * 70000, "a" * 300, 0),
]


@pytest.mark.parametrize("case", FRAME_CASES, ids=lambda c: f"op{c[0]:#x}-{len(c[2])}")
def test_frames_byte_identical_and_cross_parse(case):
    op, rid, payload, tenant, flags = case
    ours = P.encode_frame(op, rid, payload, tenant=tenant, flags=flags)
    theirs = JP.encode_frame(op, rid, payload, tenant=tenant, flags=flags)
    assert ours == theirs
    for parse in (P.parse_frame, JP.parse_frame):
        f = parse(ours[4:])
        assert (f.opcode, f.request_id, f.payload, f.tenant, f.flags) == (
            op, rid, payload, tenant, flags)
    assert P.parse_frame(ours[4:]).opcode_name == JP.parse_frame(ours[4:]).opcode_name
    assert P.read_length_prefix(ours[:4]) == JP.read_length_prefix(ours[:4]) == len(ours) - 4


def test_protocol_constants_are_the_reference_s():
    assert (P.MAGIC, P.PROTOCOL_VERSION, P.MAX_FRAME_BYTES, P.HEADER_BYTES, P.FLAG_ERROR) == (
        JP.MAGIC, JP.PROTOCOL_VERSION, JP.MAX_FRAME_BYTES, JP.HEADER_BYTES, JP.FLAG_ERROR)
    assert P.OPCODE_NAMES == JP.OPCODE_NAMES
    assert issubclass(P.ProtocolError, ContainerError)


def _outcome(fn, *args, **kwargs):
    """``("ok", fields)`` or ``("error", field, request_id)`` — what a parse
    did, comparable across the two packages."""
    try:
        out = fn(*args, **kwargs)
    except (P.ProtocolError, JP.ProtocolError) as e:
        return ("error", e.field, getattr(e, "request_id", None))
    if isinstance(out, int):
        return ("ok", out)
    return ("ok", out.opcode, out.request_id, out.payload, out.tenant, out.flags)


def _mutations(base: bytes, rng: random.Random, n: int):
    for _ in range(n):
        b = bytearray(base)
        op = rng.randrange(3)
        if op == 0:
            b = b[: rng.randrange(len(b))]
        elif op == 1:
            for _ in range(rng.randrange(1, 4)):
                i = rng.randrange(len(b))
                b[i] ^= 1 << rng.randrange(8)
        else:
            i = rng.randrange(len(b))
            b[i : i + rng.randrange(1, 9)] = rng.randbytes(rng.randrange(9))
        yield bytes(b)


def test_fuzzed_frames_same_outcome_in_both_packages():
    rng = random.Random(0)
    base = P.encode_frame(P.OP_PING, 7, b"p" * 64, tenant="tenant-x")[4:]
    fields = set()
    for body in _mutations(base, rng, 600):
        ours = _outcome(P.parse_frame, body)
        assert ours == _outcome(JP.parse_frame, body)
        if ours[0] == "error":
            fields.add(ours[1])
    assert {"truncated", "magic", "crc32"} <= fields
    for prefix in (b"\x01\x02", struct.pack("<I", 3), struct.pack("<I", 0xFFFFFFFF),
                   struct.pack("<I", 64)):
        assert _outcome(P.read_length_prefix, prefix, max_frame=1 << 20) == _outcome(
            JP.read_length_prefix, prefix, max_frame=1 << 20)


def _bf16_pair(values):
    """The same bfloat16 leaf as the reference holds it (ml_dtypes numpy,
    via ``np.asarray`` of a JAX array) and as the port holds it (a tensor)."""
    ref = np.asarray(jnp.asarray(np.asarray(values, np.float32), jnp.bfloat16))
    return ref, torch.from_numpy(np.asarray(values, np.float32)).to(torch.bfloat16)


def _payload_pair():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(33, 47)).astype(np.float32)
    tc = tapi.compress(x, "zfp", rate=12, backend="torch")
    jc = japi.compress(x, "zfp", rate=12)
    assert tc.to_bytes() == jc.to_bytes()
    bf_ref, bf_ours = _bf16_pair(rng.normal(size=(5, 3)))
    arrays = {
        "f32": x[:3], "i64": np.arange(9, dtype=np.int64).reshape(3, 3),
        "u8": np.arange(5, dtype=np.uint8), "bool": np.array([True, False]),
        "scalar": np.float64(2.5), "empty": np.zeros((0, 4), np.int16),
        "f16": np.linspace(-1, 1, 7).astype(np.float16),
        "fortran": np.asfortranarray(x[:4, :5]),
    }
    extra = {"stats": {"ratio": np.float32(2.5), "n": np.int64(3), "ok": np.bool_(True)},
             "list": [1, 2.0, "x"]}
    ours = {"c": tc, "raw": b"\x00\x01\x02", **arrays, "bf16": bf_ours,
            "t_f32": torch.from_numpy(x[:3].copy()), "t_i32": torch.arange(6, dtype=torch.int32)}
    theirs = {"c": jc, "raw": b"\x00\x01\x02", **arrays, "bf16": bf_ref,
              "t_f32": x[:3].copy(), "t_i32": np.arange(6, dtype=np.int32)}
    return ours, theirs, extra


def test_payloads_byte_identical_and_cross_load():
    ours, theirs, extra = _payload_pair()
    blob = P.dumps_payload(ours, extra)
    assert blob == JP.dumps_payload(theirs, extra)
    assert P.dumps_payload() == JP.dumps_payload()
    for loads in (P.loads_payload, JP.loads_payload):
        flat, ex = loads(blob)
        assert ex == JP.loads_json(JP.dumps_json(extra))
        assert list(flat) == list(ours)
        assert flat["c"].to_bytes() == ours["c"].to_bytes()
        assert flat["raw"] == b"\x00\x01\x02"
        np.testing.assert_array_equal(flat["i64"], theirs["i64"])
        np.testing.assert_array_equal(flat["t_f32"], theirs["t_f32"])
        np.testing.assert_array_equal(flat["fortran"], theirs["fortran"])
        # bfloat16 reads back as opaque 16-bit words in both packages
        assert flat["bf16"].dtype == np.dtype("V2")
        np.testing.assert_array_equal(flat["bf16"].view(np.int16),
                                      ours["bf16"].view(torch.int16).numpy())
    flat, _ = P.loads_payload(blob)
    assert isinstance(flat["c"], Compressed)
    assert isinstance(JP.loads_payload(blob)[0]["c"], JCompressed)


def test_bf16_npy_bytes_are_the_reference_s():
    ref, ours = _bf16_pair(np.linspace(-3, 3, 4097).reshape(17, 241))
    assert P.npy_bytes(ours) == P.npy_bytes(ref) == JP.dumps_payload({"a": ref})[
        -len(P.npy_bytes(ours)):]
    assert b"'descr': '<V2'" in P.npy_bytes(ours)


def test_fuzzed_payloads_same_outcome_in_both_packages():
    ours, _theirs, extra = _payload_pair()
    blob = P.dumps_payload({k: ours[k] for k in ("c", "raw", "f32", "bf16")}, extra)
    rng = random.Random(1)
    for _ in range(300):
        b = bytearray(blob)
        if rng.random() < 0.5:
            b = b[: rng.randrange(len(b))]
        else:
            for _ in range(rng.randrange(1, 4)):
                i = rng.randrange(len(b))
                b[i] ^= 1 << rng.randrange(8)
        res = []
        for loads in (P.loads_payload, JP.loads_payload):
            try:
                flat, ex = loads(bytes(b))
            except (P.ProtocolError, JP.ProtocolError) as e:
                res.append(("error", e.field))
            else:
                res.append(("ok", list(flat), ex, {
                    k: v.to_bytes() if hasattr(v, "to_bytes") else (
                        v if isinstance(v, bytes) else (v.dtype.str, v.tobytes()))
                    for k, v in flat.items()}))
        assert res[0] == res[1]


@pytest.mark.parametrize("make", [
    lambda m: (P.ProtocolError(m, field="crc32"), JP.ProtocolError(m, field="crc32")),
    lambda m: (ServiceOverloaded(m), JOverloaded(m)),
    lambda m: (ContainerError(m), JP.ContainerError(m)),
    lambda m: (KeyError(m), KeyError(m)),
    lambda m: (ValueError(m), ValueError(m)),
], ids=["protocol", "overloaded", "container", "keyerror", "valueerror"])
def test_error_payloads_byte_identical_and_reraise_alike(make):
    ours, theirs = make("boom: something failed")
    blob = P.error_payload(ours)
    assert blob == JP.error_payload(theirs)
    got = []
    for raise_ in (P.raise_error_payload, JP.raise_error_payload):
        with pytest.raises(Exception) as ei:
            raise_(blob)
        got.append((type(ei.value).__name__, str(ei.value), getattr(ei.value, "field", None)))
    assert got[0] == got[1]
    assert str(got[0][1]).count("[field=") <= 1
    if isinstance(ours, ServiceOverloaded):
        with pytest.raises(ServiceOverloaded):
            P.raise_error_payload(blob)


def test_recv_frame_over_a_socket_pair():
    a, b = socket.socketpair()
    a.settimeout(TIMEOUT)
    b.settimeout(TIMEOUT)
    try:
        frames = [JP.encode_frame(JP.OP_COMPRESS, i, b"z" * (i * 5000), tenant=f"t{i}")
                  for i in range(4)]
        a.sendall(b"".join(frames))
        for i in range(4):
            f = P.recv_frame(b)
            assert (f.request_id, f.payload, f.tenant) == (i, b"z" * (i * 5000), f"t{i}")
        a.sendall(frames[1][:30])
        a.shutdown(socket.SHUT_WR)
        with pytest.raises(P.ProtocolError) as ei:
            P.recv_frame(b)
        assert ei.value.field == "truncated"
        assert P.recv_frame(b) is None  # clean EOF between frames
    finally:
        a.close()
        b.close()
