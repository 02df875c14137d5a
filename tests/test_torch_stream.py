"""The port's chunk-pipelined stream against the reference
(``repro.core.api.CompressorStream``, ``repro.core.pipeline.ChunkedPipeline``)
on the CPU, ``backend="torch"`` for the port and the reference's default
backend.

A small seeded field gives six chunks at the fixed chunking used here.  For
``zfp`` (rate 16), ``huffman-bytes`` and ``huffman`` the port's stream bytes
are the same at windows 1, 2 and 3, equal the one-shot encode of each chunk,
and equal the reference's stream byte for byte; ``mgard`` keeps within its
bound and cross-decodes.  Each package reads the other's ``to_bytes`` and
``to_file`` streams lazily (``materialized``, ``preads``).  The scheduler
cases are the reference's: compute overlaps the previous chunk's
serialization, the in-flight window is bounded, a failing chunk surfaces its
exception.  The reference's single-phase ``ChunkedPipeline(compress_fn,
...)`` writes the reference's chunk bytes and the two-phase stream's, and
round-trips through ``decompress_chunked``.  The plain Huffman decode costs
~0.5 s a stream on the CPU, so Huffman streams are decoded once each.
"""

import threading
import time

import numpy as np
import pytest
import torch

from repro.core import api as japi
from repro.core import pipeline as jpl
from repro_torch.core import api as tapi
from repro_torch.core import engine as tengine
from repro_torch.core import pipeline as tpl
from repro_torch.core.container import ContainerError
from repro_torch.runtime import executor as tex

EDGE = 24
ROWS = 4                            # rows of a chunk: six chunks
CHUNK = ROWS * EDGE * EDGE
CPU = [torch.device("cpu")]
EXACT = {"zfp": {"rate": 16}, "huffman-bytes": {}, "huffman": {}}


def _field() -> np.ndarray:
    rng = np.random.default_rng(7)
    g = np.linspace(0, 4 * np.pi, EDGE)
    f = np.sin(g)[:, None, None] * np.cos(g)[None, :, None] * np.sin(g)[None, None, :]
    return (f + 0.01 * rng.standard_normal((EDGE,) * 3)).astype(np.float32)


def _data(method: str) -> np.ndarray:
    if method == "huffman":  # small-alphabet integer keys
        return np.random.default_rng(8).integers(0, 60, (EDGE,) * 3).astype(np.int32)
    return _field()


def _tstream(method, window=2, **kw):
    return tapi.CompressorStream(method, mode="fixed", c_fixed_elems=CHUNK, window=window,
                                 backend="torch", **{**EXACT.get(method, {}), **kw})


def _jstream(method, window=2, **kw):
    return japi.CompressorStream(method, mode="fixed", c_fixed_elems=CHUNK, window=window,
                                 **{**EXACT.get(method, {}), **kw})


# ---------------------------------------------------------------------------
# stream bytes against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", sorted(EXACT))
def test_stream_bytes_equal_reference_at_every_window(method):
    data = _data(method)
    blobs = []
    for window in (1, 2, 3):
        res = _tstream(method, window).compress(data)
        assert len(res.chunks) == EDGE // ROWS > 2
        assert res.window == window and res.max_in_flight <= window
        assert res.boundaries == list(range(0, EDGE, ROWS))
        blobs.append(tapi.CompressorStream.to_bytes(res))
    assert blobs[0] == blobs[1] == blobs[2]
    jres = _jstream(method).compress(data)
    assert blobs[0] == japi.CompressorStream.to_bytes(jres)
    # every chunk is the one-shot encode of its rows
    res = tapi.CompressorStream.from_bytes(blobs[0])
    for i in (0, len(res.chunks) - 1):
        rows = data[res.boundaries[i]: res.boundaries[i] + ROWS]
        one = tapi.encode(tapi.make_spec(tapi.as_tensor(rows), method, backend="torch",
                                         **EXACT[method]), rows)
        assert res.chunks[i].to_bytes() == one.to_bytes()
    # the port decodes the reference's chunks exactly (the first and the
    # last: the plain Huffman decode costs ~0.5 s a chunk on the CPU)
    theirs = tapi.CompressorStream.from_bytes(japi.CompressorStream.to_bytes(jres))
    for i in (0, -1):
        np.testing.assert_array_equal(tapi.decode(theirs.chunks[i], "torch").numpy(),
                                      np.asarray(japi.decode(jres.chunks[i])))


def test_stream_frame_true_writes_the_same_bytes():
    data = _field()
    framed = _tstream("zfp", frame=True).compress(data)
    assert all(getattr(c, "_frame_bytes", None) for c in framed.chunks)
    assert tapi.CompressorStream.to_bytes(framed) == \
        tapi.CompressorStream.to_bytes(_tstream("zfp").compress(data))


def test_mgard_stream_within_bound_and_cross_decodes():
    """MGARD decomposes in floating point, so its keys may flip at rounding
    boundaries under another operation order: held to the bound both ways."""
    data = _field()[:16, :12, :12].copy()
    kw = {"mode": "fixed", "c_fixed_elems": ROWS * 12 * 12, "error_bound": 1e-2}
    tres = [tapi.CompressorStream("mgard", window=w, backend="torch", **kw).compress(data)
            for w in (1, 3)]
    raw = tapi.CompressorStream.to_bytes(tres[0])
    assert len(tres[0].chunks) == 4
    assert raw == tapi.CompressorStream.to_bytes(tres[1])   # window-independent
    jraw = japi.CompressorStream.to_bytes(japi.CompressorStream("mgard", **kw).compress(data))
    decoded = {
        "port": tapi.CompressorStream.decompress(tres[0], backend="torch").numpy(),
        "reference of the port's": np.asarray(japi.CompressorStream.decompress(
            japi.CompressorStream.from_bytes(raw))),
        "port of the reference's": tapi.CompressorStream.decompress(
            tapi.CompressorStream.from_bytes(jraw), backend="torch").numpy(),
    }
    for i, lo in enumerate(tres[0].boundaries):
        eb = tres[0].chunks[i].meta["error_bound"] * 1.0001
        for what, out in decoded.items():
            assert np.abs(out[lo:lo + ROWS] - data[lo:lo + ROWS]).max() <= eb, (what, i)


# ---------------------------------------------------------------------------
# framed bytes and files, read lazily across packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_from_bytes_reads_the_other_package_lazily(writer):
    data = _field()
    if writer == "port":
        raw = tapi.CompressorStream.to_bytes(_tstream("zfp").compress(data))
        res = japi.CompressorStream.from_bytes(raw)
    else:
        raw = japi.CompressorStream.to_bytes(_jstream("zfp").compress(data))
        res = tapi.CompressorStream.from_bytes(raw)
    assert res.chunks.materialized == 0
    first = res.chunks[0]
    assert res.chunks.materialized == 1 and res.chunks[-1] is res.chunks[5]
    assert res.chunks.materialized == 2
    assert first.method == "zfp" and res.shape == data.shape and res.axis == 0
    eager = (japi if writer == "port" else tapi).CompressorStream.from_bytes(raw, lazy=False)
    assert isinstance(eager.chunks, list) and len(eager.chunks) == 6


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_from_file_preads_only_what_it_needs(tmp_path, writer):
    data = _field()
    path = tmp_path / "stream.hpds"
    tres = _tstream("zfp").compress(data)
    if writer == "port":
        directory = tapi.CompressorStream.to_file(tres, path, align=512)
        read = japi.CompressorStream
    else:
        directory = japi.CompressorStream.to_file(_jstream("zfp").compress(data), path, align=512)
        read = tapi.CompressorStream
    assert all(seg["offset"] % 512 == 0 for seg in directory["segments"].values())
    res = read.from_file(path)
    assert res.chunks.materialized == 0
    first = res.chunks[0]                      # a prefix: one pread
    assert res.chunks.materialized == 1 and res.chunks.reader.preads == 1
    assert first.to_bytes() == tres.chunks[0].to_bytes()
    # the file's bytes are also a plain to_bytes frame, in both packages
    legacy = tapi.CompressorStream.from_bytes(path.read_bytes())
    assert [c.to_bytes() for c in legacy.chunks] == [c.to_bytes() for c in tres.chunks]
    res.chunks.reader.close()


def test_from_file_without_directory_falls_back(tmp_path):
    tres = _tstream("zfp").compress(_field())
    bare = tmp_path / "bare.hpds"
    bare.write_bytes(tapi.CompressorStream.to_bytes(tres))
    res = tapi.CompressorStream.from_file(bare)
    out = tapi.CompressorStream.decompress(res, backend="torch")
    np.testing.assert_array_equal(out.numpy(),
                                  tapi.CompressorStream.decompress(tres, backend="torch").numpy())


@pytest.mark.parametrize("raw,match", [
    (b"nope" + bytes(20), "not an HPDR"),
    (b"HPDS" + np.uint32(9).tobytes() + bytes(8), "version 9"),
    (b"HPDS" + np.uint32(1).tobytes() + np.uint64(99).tobytes() + b"{}", "truncated"),
    (b"HPDS" + np.uint32(1).tobytes() + np.uint64(2).tobytes() + b"{x", "corrupt"),
])
def test_from_bytes_rejects_bad_frames(raw, match):
    with pytest.raises(ContainerError, match=match):
        tapi.CompressorStream.from_bytes(raw)


def test_from_bytes_rejects_a_truncated_chunk():
    raw = tapi.CompressorStream.to_bytes(_tstream("zfp").compress(_field()))
    with pytest.raises(ContainerError, match="truncated"):
        tapi.CompressorStream.from_bytes(raw[:-1])


# ---------------------------------------------------------------------------
# the scheduler
# ---------------------------------------------------------------------------


def test_compute_overlaps_previous_serialization():
    """Chunk i's serialization blocks until chunk i+1's compute has started:
    only an overlapped scheduler satisfies every handshake."""
    n_chunks, rows, cols = 8, 8, 16
    data = np.arange(n_chunks * rows * cols, dtype=np.float32).reshape(n_chunks * rows, cols)
    started = [threading.Event() for _ in range(n_chunks)]
    handshakes = []

    def compute(chunk, slot):
        idx = int(chunk[0, 0]) // (rows * cols)
        started[idx].set()
        time.sleep(0.005)
        return idx

    def finish(idx, slot):
        if idx + 1 < n_chunks:
            handshakes.append((idx, started[idx + 1].wait(timeout=10.0)))
        return idx

    ex = tex.DeviceExecutor(CPU, max_workers=1)
    try:
        res = tpl.ChunkedPipeline(compute_fn=compute, finish_fn=finish, mode="fixed",
                                  c_fixed_elems=rows * cols, devices=CPU, executor=ex,
                                  window=2).run(data)
        assert res.chunks == list(range(n_chunks))
        assert sorted(i for i, _ok in handshakes) == list(range(n_chunks - 1))
        assert all(ok for _i, ok in handshakes)
        lanes = ex.lane_stats()
        assert lanes["compute"]["completed"] == lanes["io"]["completed"] == n_chunks
    finally:
        ex.shutdown()


@pytest.mark.parametrize("window", [1, 2, 3])
def test_in_flight_window_is_bounded(window):
    data = np.arange(12 * 8 * 16, dtype=np.float32).reshape(96, 16)

    def finish(payload, slot):
        time.sleep(0.01)          # serialization is the bottleneck
        return slot

    res = tpl.ChunkedPipeline(compute_fn=lambda c, s: c, finish_fn=finish, mode="fixed",
                              c_fixed_elems=8 * 16, devices=CPU, window=window).run(data)
    assert len(res.chunks) == 12 and 1 <= res.max_in_flight <= window
    assert res.chunks == [i % window for i in range(12)]   # the slots
    spans = [t.spans for t in res.timings]
    assert all(set(s) == {"h2d", "compute", "serialize"} for s in spans)
    assert res.lane_seconds()["serialize"] >= 12 * 0.01
    if window == 1:   # serial: chunk i+1 stages after chunk i serialised
        assert all(spans[i + 1]["h2d"][0] >= spans[i]["serialize"][1] for i in range(11))


def test_stream_compute_failure_propagates():
    def compute(chunk, slot):
        raise RuntimeError("boom")

    pipe = tpl.ChunkedPipeline(compute_fn=compute, finish_fn=lambda p, s: p, mode="fixed",
                               c_fixed_elems=8 * 16, devices=CPU)
    with pytest.raises(RuntimeError, match="boom"):
        pipe.run(np.zeros((32, 16), np.float32))


def test_stream_splits_the_largest_axis_and_takes_tensors():
    data = torch.from_numpy(_field()[:8].copy()).permute(1, 0, 2)   # (24, 8, 24), strided
    res = tapi.CompressorStream("zfp", mode="fixed", c_fixed_elems=2 * 8 * 24, backend="torch",
                                rate=16).compress(data)
    assert res.axis == 0 and res.shape == (24, 8, 24) and len(res.chunks) == 12
    other = data.permute(1, 2, 0)                                    # (8, 24, 24): axis 1
    flat = tapi.CompressorStream("zfp", mode="fixed", c_fixed_elems=8 * 24 * 6,
                                 backend="torch", rate=16).compress(other)
    assert flat.axis == 1 and flat.boundaries == [0, 6, 12, 18]
    for r, x in ((res, data), (flat, other)):
        out = tapi.CompressorStream.decompress(r, backend="torch")
        assert out.shape == x.shape
        assert float((out - x).abs().max()) <= 1e-3 * float(x.abs().max())
        first = tapi.compress(x.narrow(r.axis, 0, r.boundaries[1]).contiguous(), "zfp",
                              rate=16, backend="torch")
        assert r.chunks[0].to_bytes() == first.to_bytes()


def test_engine_stream_defaults_to_auto(tmp_path):
    from repro_torch.core import chunk_model as tcm
    from repro_torch.runtime import calibrate as tcal

    tcal.set_calibration_dir(tmp_path)
    try:
        store = tcal.load_store("torch")
        store.methods[tcal.method_key("huffman-bytes", "uint8")] = tcal.MethodCalibration(
            method="huffman-bytes", dtype="uint8",
            phi=tcm.PhiModel(alpha=0.0, beta0=1e9, gamma=1e9, c_threshold=4096.0),
            h2d=tcm.AffineCost(1e-5, 5e9), serialize=tcm.AffineCost(2e-5, 3e9),
            output_fraction=0.5)
        store.window_overhead_s = 1e-5
        with tengine.ExecutionEngine(devices=CPU, backend="torch") as eng:
            stream = eng.stream("huffman-bytes")
            assert stream.pipeline.auto_chunk and stream.pipeline.auto_window
            assert stream.backend == "torch"
            data = np.random.default_rng(2).integers(0, 7, 4096).astype(np.uint8)
            res = stream.compress(data)
            assert res.tuned["source"] == "calibrated"
            assert res.tuned["chunk_elems"] * (len(res.chunks) - 1) < data.size
            assert eng.executor.lane_stats()["io"]["completed"] == len(res.chunks)
            out = tapi.CompressorStream.decompress(res, backend="torch")
            np.testing.assert_array_equal(out.numpy(), data)
    finally:
        tcal.set_calibration_dir(None)


@pytest.mark.parametrize("window", [1, 2])
def test_single_phase_pipeline_writes_the_reference_s_bytes(window):
    """The reference's ``test_chunked_compress_roundtrip`` form: each chunk
    through ``compress_fn`` on the compute lane, its arrays on the host after
    the io lane; the chunks equal the reference's and the two-phase stream's
    at the same chunking, and decode back within the reference's bound."""
    data = _field()
    tres = tpl.ChunkedPipeline(lambda c: tapi.compress(c, "zfp", rate=16, backend="torch"),
                               mode="fixed", c_fixed_elems=CHUNK, devices=CPU,
                               window=window).run(data)
    jres = jpl.ChunkedPipeline(lambda c: japi.compress(c, "zfp", rate=16), mode="fixed",
                               c_fixed_elems=CHUNK, window=window).run(data)
    two = _tstream("zfp", window=window).compress(data)
    assert len(tres.chunks) == 6
    assert (tres.axis, tres.boundaries, tres.shape) == (jres.axis, jres.boundaries, jres.shape)
    assert (tres.boundaries, tres.shape) == (two.boundaries, two.shape)
    blobs = [c.to_bytes() for c in tres.chunks]
    assert blobs == [c.to_bytes() for c in jres.chunks] == [c.to_bytes() for c in two.chunks]
    assert all(isinstance(a, np.ndarray) for c in tres.chunks for a in c.arrays.values())
    out = tpl.decompress_chunked(tres, lambda c: tapi.decompress(c, backend="torch"))
    assert out.shape == data.shape and np.abs(out.numpy() - data).max() < 2e-3
    assert torch.equal(out, tapi.CompressorStream.decompress(two, backend="torch"))
    assert all(set(t.spans) == {"h2d", "compute", "serialize"} for t in tres.timings)


def test_single_phase_finish_moves_tensors_to_the_host():
    """A container whose ``arrays`` hold tensors comes out of the io lane
    with them on the host, values unchanged."""
    class Box:
        def __init__(self, chunk):
            self.arrays = {"sum": chunk.sum(0), "first": chunk[0].clone()}

    data = np.arange(16 * 8, dtype=np.float32).reshape(16, 8)   # cut along axis 0
    res = tpl.ChunkedPipeline(Box, mode="fixed", c_fixed_elems=2 * 8, devices=CPU).run(data)
    assert len(res.chunks) == 8
    for i, box in enumerate(res.chunks):
        assert all(a.device.type == "cpu" for a in box.arrays.values())
        np.testing.assert_array_equal(box.arrays["first"].numpy(), data[2 * i])


def test_pipeline_needs_compress_fn_or_the_two_phases():
    for pipe in (tpl.ChunkedPipeline, jpl.ChunkedPipeline):
        with pytest.raises(ValueError, match="need compress_fn or compute_fn/finish_fn"):
            pipe(mode="fixed")
    assert tpl.ChunkedPipeline(lambda c: c).compress_fn is not None


def test_stream_needs_a_card_unless_torch():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour where no CUDA card is present")
    with pytest.raises(ValueError, match="CUDA"):
        tapi.CompressorStream("zfp")
    with pytest.raises(ValueError, match="CUDA"):
        tpl.ChunkedPipeline(compute_fn=lambda c, s: c, finish_fn=lambda p, s: p).run(
            np.zeros((4, 4), np.float32))
