"""The port's aggregated segment files and host topology against the
reference (``repro.runtime.io``, ``repro.launch.mesh``).

The same adds with the same ``align`` give byte-identical files from both
writers; each reader reads the other's files; a crc mismatch or a truncated
directory raises in both (the port with its own ``ContainerError``); the
shard-set layer stitches and reads the same view; both topologies assign
every leaf to the same host.
"""

import json
import zlib

import numpy as np
import pytest

from repro.core.container import ContainerError as JContainerError
from repro.launch import mesh as jmesh
from repro.runtime import io as jio
from repro_torch.core.container import ContainerError as TContainerError
from repro_torch.launch import mesh as tmesh
from repro_torch.runtime import io as tio

IO = {"port": tio, "ref": jio}
ERRORS = {"port": TContainerError, "ref": JContainerError}


def _blobs(seed: int = 0) -> list[tuple[str, bytes]]:
    rng = np.random.default_rng(seed)
    sizes = (0, 1, 4095, 4096, 4097, 70_000, 13)
    return [(f"leaf/{i:03d}", rng.integers(0, 256, n, dtype=np.uint8).tobytes())
            for i, n in enumerate(sizes)]


def _write(mod, path, align: int, parallel: bool, buffer_bytes: int, raw: bytes = b""):
    with mod.AggregatedWriter(path, align=align, parallel=parallel, buffer_bytes=buffer_bytes,
                              meta={"step": 7, "tag": "x"}) as w:
        if raw:
            w.write_raw(raw)
        offsets = [w.add(name, blob) for name, blob in _blobs()]
    return offsets, w.directory()


@pytest.mark.parametrize("align", [1, 64, 4096])
@pytest.mark.parametrize("parallel,buffer_bytes", [(True, 1 << 12), (False, 4 << 20)])
def test_writers_write_identical_files(tmp_path, align, parallel, buffer_bytes):
    out = {}
    for name, mod in IO.items():
        path = tmp_path / f"{name}.hpdr"
        offsets, directory = _write(mod, path, align, parallel, buffer_bytes, raw=b"HPDS-head")
        out[name] = (offsets, directory, path.read_bytes())
    assert out["port"][0] == out["ref"][0]
    assert out["port"][1] == out["ref"][1]
    assert out["port"][2] == out["ref"][2]
    assert tio.has_directory(tmp_path / "port.hpdr") and jio.has_directory(tmp_path / "ref.hpdr")


@pytest.mark.parametrize("writer,reader", [("port", "ref"), ("ref", "port")])
def test_readers_read_each_others_files(tmp_path, writer, reader):
    path = tmp_path / "seg.hpdr"
    _write(IO[writer], path, 4096, True, 1 << 12)
    with IO[reader].AggregatedReader(path) as r:
        assert r.names() == [name for name, _ in _blobs()]
        assert r.meta == {"step": 7, "tag": "x"}
        for name, blob in _blobs():
            assert name in r
            assert r.read(name) == blob
        assert r.preads == len(_blobs())
        assert r.pread_bytes == sum(len(b) for _, b in _blobs())


@pytest.mark.parametrize("package", ["port", "ref"])
def test_crc_mismatch_raises(tmp_path, package):
    path = tmp_path / "seg.hpdr"
    _, directory = _write(tio, path, 4096, False, 4 << 20)
    seg = directory["segments"]["leaf/005"]
    raw = bytearray(path.read_bytes())
    raw[int(seg["offset"]) + 17] ^= 0x10
    path.write_bytes(bytes(raw))
    with IO[package].AggregatedReader(path) as r:
        assert r.read("leaf/004") == _blobs()[4][1]
        with pytest.raises(ERRORS[package], match="leaf/005.*crc32"):
            r.read("leaf/005")
        assert r.read("leaf/005", verify=False) != _blobs()[5][1]
        with pytest.raises(ERRORS[package], match="no segment"):
            r.read("leaf/999")


@pytest.mark.parametrize("package", ["port", "ref"])
@pytest.mark.parametrize("cut", ["trailer", "directory", "tiny", "json"])
def test_truncated_directory_raises(tmp_path, package, cut):
    path = tmp_path / "seg.hpdr"
    _write(tio, path, 64, False, 4 << 20)
    raw = path.read_bytes()
    if cut == "trailer":      # the magic gone
        raw = raw[:-3]
    elif cut == "directory":  # data and trailer kept, the directory's head gone
        dir_off = int(np.frombuffer(raw[-24:-16], np.uint64)[0])
        raw = raw[:dir_off] + raw[dir_off + 40:]
    elif cut == "tiny":
        raw = raw[:10]
    else:                     # the directory's bytes no longer JSON
        dir_off = int(np.frombuffer(raw[-24:-16], np.uint64)[0])
        raw = raw[:dir_off] + b"#" + raw[dir_off + 1:]
    path.write_bytes(raw)
    with pytest.raises(ERRORS[package]):
        IO[package].AggregatedReader(path)
    assert tio.has_directory(path) == jio.has_directory(path)


def test_port_errors_are_the_port_container_error(tmp_path):
    path = tmp_path / "empty.hpdr"
    path.write_bytes(b"")
    with pytest.raises(TContainerError) as info:
        tio.AggregatedReader(path)
    assert not isinstance(info.value, JContainerError)


@pytest.mark.parametrize("package", ["port", "ref"])
def test_writer_abandons_a_torn_write(tmp_path, package):
    mod = IO[package]
    path = tmp_path / "seg.hpdr"
    path.write_bytes(b"old")
    with pytest.raises(RuntimeError):
        with mod.AggregatedWriter(path, atomic=True) as w:
            w.add("a", b"1234")
            raise RuntimeError("torn")
    assert path.read_bytes() == b"old"
    assert sorted(p.name for p in tmp_path.iterdir()) == ["seg.hpdr"]
    with mod.AggregatedWriter(path, atomic=True, fsync=True) as w:
        w.add("a", b"1234")
        with pytest.raises(ValueError, match="duplicate"):
            w.add("a", b"x")
    with tio.AggregatedReader(path) as r:
        assert r.read("a") == b"1234"


def test_shard_sets_stitch_and_read_like_the_reference(tmp_path):
    files = {}
    for host in range(2):
        files[str(host)] = tio.shard_file_name(host)
        assert files[str(host)] == jio.shard_file_name(host)
        with tio.AggregatedWriter(tmp_path / files[str(host)], meta={"host": host}) as w:
            for name, blob in _blobs(seed=host)[host:]:
                w.add(name, blob)
    stitched = tio.stitch_shard_directories(tmp_path, files)
    assert stitched == jio.stitch_shard_directories(tmp_path, files)
    readers = {p: IO[p].ShardSetReader(tmp_path, files, local="1") for p in IO}
    for name, blob in _blobs(seed=1)[1:3]:
        for r in readers.values():
            assert r.read("1", name) == blob
    for r in readers.values():
        assert r.read("0", "leaf/000") == _blobs(seed=0)[0][1]
    assert readers["port"].stats == readers["ref"].stats
    with pytest.raises(TContainerError, match="no shard"):
        readers["port"].read("7", "leaf/000")
    for r in readers.values():
        r.close()
    # a torn shard fails the stitch loudly, naming the file
    (tmp_path / files["1"]).write_bytes(b"torn")
    with pytest.raises(TContainerError, match=files["1"]):
        tio.stitch_shard_directories(tmp_path, files)


def test_serialization_probe():
    ticks = iter([0.0, 0.5, 1.0, 1.25])
    assert tio.serialization_probe(100, repeat=2, clock=lambda: next(ticks)) == 0.25
    assert tio.serialization_probe(1 << 16, repeat=1) > 0


def test_directory_is_json_with_crc32(tmp_path):
    path = tmp_path / "seg.hpdr"
    _, directory = _write(tio, path, 4096, True, 1 << 12)
    raw = path.read_bytes()
    dir_off, dir_len = (int(v) for v in np.frombuffer(raw[-24:-8], np.uint64))
    assert json.loads(raw[dir_off: dir_off + dir_len]) == directory
    for name, blob in _blobs():
        assert directory["segments"][name]["crc32"] == zlib.crc32(blob) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# host topology
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_hosts", [1, 2, 3, 8])
def test_topology_owner_matches_reference(n_hosts):
    keys = [f"layers/{i}/w{j}" for i in range(40) for j in "qkvo"] + ["embed", "", "é/ü"]
    for host in range(n_hosts):
        t = tmesh.HostTopology(host, n_hosts)
        j = jmesh.HostTopology(host, n_hosts)
        assert t.multi_host == j.multi_host == (n_hosts > 1)
        assert [t.owner(k) for k in keys] == [j.owner(k) for k in keys]
        assert [t.owns(k) for k in keys] == [j.owns(k) for k in keys]
    with pytest.raises(ValueError, match="out of range"):
        tmesh.HostTopology(n_hosts, n_hosts)


def test_detect_topology_env_override_and_default(monkeypatch):
    monkeypatch.setenv(tmesh.ENV_HOST_COUNT, "4")
    monkeypatch.setenv(tmesh.ENV_HOST_ID, "3")
    assert tmesh.detect_topology() == tmesh.HostTopology(3, 4)
    assert (tmesh.detect_topology().host_id, tmesh.detect_topology().n_hosts) == (
        jmesh.detect_topology().host_id, jmesh.detect_topology().n_hosts)
    monkeypatch.delenv(tmesh.ENV_HOST_COUNT)
    monkeypatch.delenv(tmesh.ENV_HOST_ID)
    assert tmesh.detect_topology() == tmesh.HostTopology(0, 1)


def test_port_reader_survives_short_preads(tmp_path, monkeypatch):
    """One ``os.pread`` returns at most 0x7ffff000 bytes on Linux, so a
    segment past 2 GiB (recurrentgemma-9b's embedding moments through zfp)
    comes back in several reads: with every pread capped at 1000 bytes the
    port's reader still returns each segment whole and counts one logical
    read a segment."""
    import os

    path = tmp_path / "seg.hpdr"
    _write(tio, path, 64, False, 4 << 20)
    real = os.pread
    monkeypatch.setattr(os, "pread", lambda fd, n, off: real(fd, min(n, 1000), off))
    with tio.AggregatedReader(path) as r:
        for name, blob in _blobs():
            assert r.read(name) == blob
        assert r.preads == len(_blobs())
        assert r.pread_bytes == sum(len(b) for _, b in _blobs())
