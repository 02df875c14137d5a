"""The port's wire server and client (``repro_torch.serving.server``,
``repro_torch.serving.client``) against the reference's.

A ``repro`` client drives a port server (engine
``ExecutionEngine(devices=[torch.device("cpu")], backend="torch")``) and a port
client drives a ``repro`` server: container bytes over either socket equal
the in-process results of both packages (ZFP byte for byte, as the codecs
are).  The port server's fault containment is the reference's: malformed
frames get a typed error naming the field (and a hang-up where framing is
lost), and clients killed in subprocesses mid-request or mid-response cost
only their own connection.  Every socket wait and subprocess has a timeout.
"""

import os
import random
import socket
import struct
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.serving import protocol as JP
from repro.serving.client import ReductionClient as JClient
from repro.serving.server import ReductionServer as JServer
from repro_torch.core import api as tapi
from repro_torch.core import engine as tengine
from repro_torch.core import progressive as tprog
from repro_torch.core.container import Compressed
from repro_torch.serving import protocol as P
from repro_torch.serving import ReductionClient, ReductionServer, ReductionService

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 30.0


@pytest.fixture(scope="module")
def eng():
    with tengine.ExecutionEngine(devices=[torch.device("cpu")], backend="torch") as e:
        yield e


def _sock_dir():
    """A short directory for socket files: a unix socket path must stay
    under ~100 bytes, which pytest's nested temporary paths can exceed."""
    return tempfile.TemporaryDirectory(prefix="hpw-")


@pytest.fixture(scope="module")
def server(eng, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("wire")
    svc = ReductionService(eng, max_queue=32, batch_window=0.002, spill_dir=tmp / "kv")
    with _sock_dir() as d, ReductionServer(svc, unix_path=Path(d) / "port.sock",
                                           tcp=("127.0.0.1", 0)) as srv:
        yield srv
    svc.close(TIMEOUT)


@pytest.fixture(scope="module")
def ref_server(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("refwire")
    with _sock_dir() as d, JServer(unix_path=Path(d) / "ref.sock", max_queue=32,
                                   batch_window=0.002, spill_dir=tmp / "kv") as srv:
        yield srv


@pytest.fixture(scope="module")
def prog_file(tmp_path_factory):
    field = np.sin(np.linspace(0, 6, 9 ** 3)).reshape(9, 9, 9).astype(np.float32)
    path = tmp_path_factory.mktemp("prog") / "field.hpdp"
    tprog.refactor(field, 1e-3, tiers=2, backend="torch").write(path)
    return path


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(64, 96)).astype(np.float32),
            "b": rng.normal(size=(96,)).astype(np.float32),
            "ids": np.arange(10, dtype=np.int32)}


def _blob(v) -> bytes:
    return v.to_bytes() if hasattr(v, "to_bytes") else np.asarray(v).tobytes()


def _exercise(cli, prog_path, session="s"):
    """One pass over every request kind; returns what came back."""
    out = {"ping": cli.ping(b"hello")}
    tree = _tree(1)
    out["compress_default"], _ = cli.compress(tree)
    out["compress_zfp"], stats = cli.compress(tree, method="zfp", rate=12)
    out["stats_ratio"] = stats["ratio"]
    out["decompress"] = cli.decompress(out["compress_zfp"])
    cache = {"k": np.random.default_rng(2).normal(size=(2, 1, 64, 2, 32)).astype(np.float32),
             "pos": np.arange(3, dtype=np.int32)}
    out["park"] = cli.park_kv(session, cache)
    out["fetch"] = cli.fetch_kv(session)
    cli.release_kv(session)
    x = np.random.default_rng(3).normal(size=(12, 40)).astype(np.float32)
    out["stream"], out["stream_info"] = cli.compress_stream(x, "zfp", rate=12, chunk_size=160,
                                                            window=2)
    out["stream_decoded"], _ = cli.decompress_stream(out["stream"], chunks=(1, 3))
    if prog_path is not None:
        out["quicklook"], out["quicklook_info"] = cli.quicklook(prog_path, tiers=1)
    out["server_stats"] = cli.stats()
    return out


def _check_same(a, b, quicklook=True):
    assert a["ping"] == b["ping"] == b"hello"
    for k in ("compress_default", "compress_zfp", "fetch"):
        assert list(a[k]) == list(b[k]), k
        for key in a[k]:
            assert _blob(a[k][key]) == _blob(b[k][key]), (k, key)
    assert a["stats_ratio"] == b["stats_ratio"]
    for key in a["decompress"]:
        assert np.asarray(a["decompress"][key]).tobytes() == np.asarray(
            b["decompress"][key]).tobytes(), key
    assert a["park"]["compressed_leaves"] == b["park"]["compressed_leaves"] == 1
    assert a["stream"] == b["stream"]
    assert a["stream_decoded"].tobytes() == b["stream_decoded"].tobytes()
    if quicklook:
        assert a["quicklook"].tobytes() == b["quicklook"].tobytes()


def test_reference_client_drives_port_server(server, prog_file):
    """Socket results from a ``repro`` client == the port service in process
    == a port client over TCP."""
    with JClient(server.unix_address, timeout=TIMEOUT) as jcli:
        theirs = _exercise(jcli, prog_file)
    with ReductionClient(server.tcp_address, timeout=TIMEOUT) as cli:
        ours = _exercise(cli, prog_file, session="s2")
    _check_same(theirs, ours)
    assert isinstance(ours["compress_zfp"]["w"], Compressed)
    svc = server.service
    flat, _ = svc.compress(_tree(1), lambda k, a: ("zfp", {"rate": 12}))
    for key in flat:
        assert _blob(flat[key]) == _blob(theirs["compress_zfp"][key]), key
    arr, info = svc.quicklook(prog_file, tiers=1)
    assert arr.numpy().tobytes() == theirs["quicklook"].tobytes()
    assert theirs["quicklook_info"]["bytes_fetched"] == info["bytes_fetched"]
    assert theirs["server_stats"]["connections"]["opened"] >= 1
    assert set(theirs["server_stats"]) == set(svc.stats().as_dict())


def test_port_client_drives_reference_server(ref_server, server):
    """The reverse: a port client on a ``repro`` server gets the bytes a
    ``repro`` client gets there, and the port server gives them too (ZFP
    and the raw leaves are byte-identical across packages)."""
    with ReductionClient(ref_server.unix_address, timeout=TIMEOUT) as cli:
        ours = _exercise(cli, None)
    with JClient(ref_server.unix_address, timeout=TIMEOUT) as jcli:
        theirs = _exercise(jcli, None, session="s2")
    _check_same(ours, theirs, quicklook=False)
    with ReductionClient(server.unix_address, timeout=TIMEOUT) as cli:
        port_side = _exercise(cli, None, session="s3")
    _check_same(ours, port_side, quicklook=False)


def test_bf16_leaf_over_the_wire_behaves_like_the_reference(server, ref_server):
    """A bfloat16 leaf crosses as ``'<V2'`` words; both servers pass it
    through raw (not numpy kind "f"), byte for byte, and both refuse to
    decode it back (``TypeError`` on the server, raised as RuntimeError)."""
    x = torch.linspace(-2, 2, 5000).to(torch.bfloat16).reshape(50, 100)
    got = []
    for addr in (server.unix_address, ref_server.unix_address):
        with ReductionClient(addr, timeout=TIMEOUT) as cli:
            comp, _ = cli.compress({"h": x})
            assert comp["h"].dtype == np.dtype("V2")
            got.append(comp["h"].tobytes())
            with pytest.raises(RuntimeError, match="TypeError"):
                cli.decompress(comp)
    assert got[0] == got[1] == x.view(torch.int16).numpy().tobytes()


# ---------------------------------------------------------------------------
# malformed frames: the port server's containment (the reference's cases)
# ---------------------------------------------------------------------------


def _raw_conn(server):
    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    sock.settimeout(TIMEOUT)
    sock.connect(server.unix_address)
    return sock


def _valid_frame(payload=b"hello", rid=7, tenant="fuzz"):
    return P.encode_frame(P.OP_PING, rid, payload, tenant=tenant)


def _assert_still_serving(server):
    with ReductionClient(server.unix_address, timeout=TIMEOUT) as cli:
        assert cli.ping(b"ok?") == b"ok?"


def test_server_rejects_oversized_length_prefix_and_hangs_up(server):
    sock = _raw_conn(server)
    try:
        sock.sendall(struct.pack("<I", 0xFFFFFFFF))
        frame = P.recv_frame(sock, max_frame=server.max_frame)
        assert frame is not None and frame.opcode == P.OP_ERROR
        with pytest.raises(P.ProtocolError) as ei:
            P.raise_error_payload(frame.payload)
        assert ei.value.field == "length"
        assert P.recv_frame(sock, max_frame=server.max_frame) is None
    finally:
        sock.close()
    _assert_still_serving(server)


def test_server_survives_bad_magic_then_serves_fresh_connection(server):
    sock = _raw_conn(server)
    try:
        junk = b"GET / HTTP/1.1\r\n\r\n"
        sock.sendall(struct.pack("<I", max(len(junk), P.HEADER_BYTES)))
        sock.sendall(junk.ljust(P.HEADER_BYTES, b"\x00"))
        frame = P.recv_frame(sock, max_frame=server.max_frame)
        assert frame is not None and frame.opcode == P.OP_ERROR
        with pytest.raises(P.ProtocolError) as ei:
            P.raise_error_payload(frame.payload)
        assert ei.value.field == "magic"
    finally:
        sock.close()
    _assert_still_serving(server)


def test_server_reports_crc_error_and_keeps_connection(server):
    sock = _raw_conn(server)
    try:
        blob = bytearray(_valid_frame(payload=b"x" * 32, rid=5))
        blob[-1] ^= 0x40
        sock.sendall(bytes(blob))
        frame = P.recv_frame(sock, max_frame=server.max_frame)
        assert frame is not None and frame.opcode == P.OP_ERROR and frame.request_id == 5
        with pytest.raises(P.ProtocolError) as ei:
            P.raise_error_payload(frame.payload)
        assert ei.value.field == "crc32"
        sock.sendall(_valid_frame(payload=b"alive", rid=6))
        frame = P.recv_frame(sock, max_frame=server.max_frame)
        assert (frame.opcode, frame.request_id, frame.payload) == (P.OP_OK, 6, b"alive")
    finally:
        sock.close()


def test_server_counts_protocol_errors_in_stats(server):
    before = server.service.stats().connections["protocol_errors"]
    sock = _raw_conn(server)
    try:
        blob = bytearray(_valid_frame(rid=9))
        blob[-1] ^= 0x01
        sock.sendall(bytes(blob))
        assert P.recv_frame(sock).opcode == P.OP_ERROR
    finally:
        sock.close()
    assert server.service.stats().connections["protocol_errors"] == before + 1
    assert server.stats()["protocol_errors"] >= 1


def test_server_fuzzed_frames_never_wedge_the_loop(server):
    rng = random.Random(2)
    base = _valid_frame(payload=b"q" * 48, tenant="fz")
    outcomes = {"error_frame": 0, "hangup": 0, "ok": 0}
    for _ in range(40):
        b = bytearray(base)
        op = rng.randrange(3)
        if op == 0:
            b = b[:4] + b[4: 4 + rng.randrange(len(b) - 4)]
            b[0:4] = struct.pack("<I", max(len(b) - 4 + 1, P.HEADER_BYTES))
        elif op == 1:
            i = rng.randrange(4, len(b))
            b[i] ^= 1 << rng.randrange(8)
        else:
            b[0:4] = struct.pack("<I", rng.choice([0, 1, 23, 0x7FFFFFFF]))
        sock = _raw_conn(server)
        try:
            sock.sendall(bytes(b))
            sock.shutdown(socket.SHUT_WR)
            frame = P.recv_frame(sock, max_frame=server.max_frame)
            if frame is None:
                outcomes["hangup"] += 1
            elif frame.opcode == P.OP_ERROR:
                outcomes["error_frame"] += 1
            else:
                outcomes["ok"] += 1
        except P.ProtocolError:
            outcomes["hangup"] += 1
        finally:
            sock.close()
    assert outcomes["error_frame"] > 0
    _assert_still_serving(server)
    _wait_stat(lambda: -server.stats()["open_connections"], -1)


def test_response_opcode_as_request_is_rejected(server):
    sock = _raw_conn(server)
    try:
        sock.sendall(JP.encode_frame(JP.OP_OK, 11, b"", tenant="fz"))
        frame = P.recv_frame(sock)
        assert frame.opcode == P.OP_ERROR
        with pytest.raises(P.ProtocolError) as ei:
            P.raise_error_payload(frame.payload)
        assert ei.value.field == "opcode"
    finally:
        sock.close()


# ---------------------------------------------------------------------------
# clients killed in subprocesses (the reference's fault tier)
# ---------------------------------------------------------------------------

# Client bodies run with ``python -c``: they build frames with the port's
# own protocol module, connect, and die at a chosen point.
_PREAMBLE = """
import os, socket, struct, sys
from repro_torch.serving import protocol as P
path = sys.argv[1]
sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
sock.settimeout(30)
sock.connect(path)
"""

# dies after half a frame: the server is left holding a torn read
_KILL_MID_REQUEST = _PREAMBLE + """
blob = P.encode_frame(P.OP_PING, 1, b"x" * 4096, tenant="fault")
sock.sendall(blob[: len(blob) // 2])
os._exit(1)
"""

# dies after a complete request, before reading the response
_KILL_MID_RESPONSE = _PREAMBLE + """
sock.sendall(P.encode_frame(P.OP_PING, 1, b"y" * 4096, tenant="fault"))
os._exit(1)
"""

# well-behaved: the port's client, one ping and one compress
_CLIENT_OK = """
import sys
import numpy as np
from repro_torch.serving import ReductionClient
with ReductionClient(sys.argv[1], timeout=30) as cli:
    assert cli.ping(b"ok") == b"ok"
    comp, _ = cli.compress({"w": np.ones((64, 64), np.float32)}, method="zfp")
    assert comp["w"].method == "zfp"
"""


def _spawn(body: str, server):
    return subprocess.Popen([sys.executable, "-c", body, server.unix_address],
                            cwd=ROOT, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                            env={**os.environ, "PYTHONPATH": str(ROOT / "src")})


def _run_client(body: str, server, expect_rc: int):
    proc = _spawn(body, server)
    _out, err = proc.communicate(timeout=120)
    assert proc.returncode == expect_rc, err.decode()[-2000:]


def _wait_stat(fn, target, timeout=TIMEOUT):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        v = fn()
        if v >= target:
            return v
        time.sleep(0.01)
    raise AssertionError(f"stat never reached {target}: last {fn()}")


def test_wellbehaved_port_client_in_a_subprocess(server):
    _run_client(_CLIENT_OK, server, expect_rc=0)


def test_client_killed_mid_request_is_contained(server):
    before = server.stats()
    with ReductionClient(server.unix_address, timeout=TIMEOUT) as bystander:
        assert bystander.ping(b"pre") == b"pre"
        _run_client(_KILL_MID_REQUEST, server, expect_rc=1)
        _wait_stat(lambda: server.stats()["torn_frames"], before["torn_frames"] + 1)
        _wait_stat(lambda: server.stats()["reclaimed"], before["reclaimed"] + 1)
        assert bystander.ping(b"post") == b"post"
        assert bystander.client_stats()["reconnects"] == 1
        assert server.service.stats().connections["open"] >= 1
    assert server.stats()["requests"] == before["requests"] + 2


def test_client_killed_mid_response_fails_only_that_request(server):
    before = server.stats()
    with ReductionClient(server.unix_address, timeout=TIMEOUT) as bystander:
        assert bystander.ping(b"pre") == b"pre"
        _run_client(_KILL_MID_RESPONSE, server, expect_rc=1)
        _wait_stat(lambda: server.stats()["requests"], before["requests"] + 2)
        _wait_stat(lambda: server.stats()["reclaimed"], before["reclaimed"] + 1)
        assert bystander.ping(b"post") == b"post"
        assert bystander.client_stats()["retries"] == 0
    assert server.stats()["send_failures"] >= before["send_failures"]


def test_kill_storm_then_full_service(server):
    before = server.stats()
    procs = [_spawn(_KILL_MID_REQUEST if i % 2 else _KILL_MID_RESPONSE, server)
             for i in range(6)]
    for p in procs:
        p.communicate(timeout=120)
    _wait_stat(lambda: server.stats()["reclaimed"], before["reclaimed"] + 6)
    with ReductionClient(server.unix_address, timeout=TIMEOUT) as cli:
        tree = {"w": np.random.default_rng(3).normal(size=(48, 48)).astype(np.float32)}
        comp, _ = cli.compress(tree, method="zfp")
        out = cli.decompress(comp)
        ref = server.service.decompress(comp, {"w": tree["w"]})
        assert np.asarray(out["w"]).tobytes() == ref["w"].numpy().tobytes()
    _wait_stat(lambda: -server.stats()["open_connections"], -1)


def test_server_close_stops_every_thread_promptly(eng, tmp_path):
    """``close`` ends the accept loops within their 0.25 s wait (the
    reference's close leaves them blocked in ``accept`` and waits out a 5 s
    join per listener) and reclaims open connections."""
    svc = ReductionService(eng, spill_dir=tmp_path / "kv")
    d = _sock_dir()
    srv = ReductionServer(svc, unix_path=Path(d.name) / "c.sock", tcp=("127.0.0.1", 0))
    cli = ReductionClient(srv.unix_address, timeout=TIMEOUT)
    assert cli.ping(b"x") == b"x"
    t0 = time.monotonic()
    srv.close(TIMEOUT)
    assert time.monotonic() - t0 < 2.0
    assert not any(t.is_alive() for t in srv._threads)
    assert not Path(srv.unix_address).exists()
    cli.close()
    svc.close(TIMEOUT)
    d.cleanup()
