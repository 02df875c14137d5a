"""The stream's pipelined read-back (``CompressorStream.decompress`` on
``pipeline.reconstruct_chunked``) on the CPU, ``backend="torch"``.

It gives the values of the serial ``decompress_chunked`` bit for bit for
``mgard``, ``zfp`` and ``huffman`` at windows 1-3, with an uneven last chunk,
into a tensor it allocates or into the caller's ``out``; a wrong ``out``
raises before any work; the compress side's bytes and a checkpoint round
trip through the stream are unchanged; the pipeline's spans come one set a
chunk.  The ``gpu`` cases read ``out`` on the caller's stream right after
the call, with the last chunk's decode held back on the lane's stream, and
hold the MGARD transforms replayed from CUDA graphs to their eager run.
The JAX package is imported inside the tests that compare with it: the
card's machine has none.
"""

import functools

import numpy as np
import pytest
import torch

from repro_torch.core import api as tapi
from repro_torch.core import pipeline as tpl
from repro_torch.runtime import trace as ttrace

EDGE = 24
ROWS = 10                               # chunks of 10, 10 and 4 rows
CHUNK = ROWS * EDGE * EDGE
METHODS = {"mgard": {}, "zfp": {"rate": 16}, "huffman": {}}


def _data(method: str) -> np.ndarray:
    if method == "huffman":  # small-alphabet integer keys
        return np.random.default_rng(8).integers(0, 60, (EDGE,) * 3).astype(np.int32)
    rng = np.random.default_rng(7)
    g = np.linspace(0, 4 * np.pi, EDGE)
    f = np.sin(g)[:, None, None] * np.cos(g)[None, :, None] * np.sin(g)[None, None, :]
    return (f + 0.01 * rng.standard_normal((EDGE,) * 3)).astype(np.float32)


def _stream(method: str, window: int):
    return tapi.CompressorStream(method, mode="fixed", c_fixed_elems=CHUNK, window=window,
                                 backend="torch", **METHODS[method])


@functools.lru_cache(maxsize=None)
def _compressed(method: str, window: int):
    return _stream(method, window).compress(_data(method))


@functools.lru_cache(maxsize=None)
def _serial(method: str) -> torch.Tensor:
    """The serial read-back: each chunk decoded in turn, then concatenated."""
    return tpl.decompress_chunked(_compressed(method, 1),
                                  lambda c: tapi.decompress(c, backend="torch"))


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32) if x.dtype == torch.float32 else x


# ---------------------------------------------------------------------------
# values
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("given", [False, True], ids=["allocated", "out"])
@pytest.mark.parametrize("window", [1, 2, 3])
@pytest.mark.parametrize("method", sorted(METHODS))
def test_pipelined_read_back_equals_the_serial_one(method, window, given):
    res = _compressed(method, window)
    assert res.window == window and res.boundaries == [0, 10, 20]   # 10, 10, 4 rows
    want = _serial(method)
    out = torch.full(res.shape, 7, dtype=want.dtype) if given else None
    got = tapi.CompressorStream.decompress(res, backend="torch", out=out)
    if given:
        assert got is out
    assert got.shape == want.shape and got.dtype == want.dtype and got.is_contiguous()
    assert torch.equal(_bits(got), _bits(want))


def test_a_codec_without_an_eager_graph_decodes_whole_on_the_lane():
    """``mgard-progressive`` decodes each chunk through its own ``decode``."""
    data = _data("mgard")
    res = tapi.CompressorStream("mgard-progressive", mode="fixed", c_fixed_elems=CHUNK,
                                backend="torch").compress(data)
    want = tpl.decompress_chunked(res, lambda c: tapi.decompress(c, backend="torch"))
    got = tapi.CompressorStream.decompress(res, backend="torch")
    assert torch.equal(_bits(got), _bits(want))


def test_a_stream_read_back_from_bytes_restores_at_window_two(monkeypatch):
    res = _compressed("zfp", 3)
    again = tapi.CompressorStream.from_bytes(tapi.CompressorStream.to_bytes(res))
    assert again.window == 0 and again.chunks.materialized == 0
    windows = []
    real = tpl.reconstruct_chunked

    def spy(*args, window, **kwargs):
        windows.append(window)
        return real(*args, window=window, **kwargs)

    monkeypatch.setattr(tpl, "reconstruct_chunked", spy)
    got = tapi.CompressorStream.decompress(again, backend="torch")
    assert windows == [2] and again.chunks.materialized == 3
    assert torch.equal(_bits(got), _bits(_serial("zfp")))


@pytest.mark.parametrize("window", [1, 2])
def test_reconstruction_timings_and_window(window):
    """Each chunk's lanes are timed; at window 1 chunk i+1 stages only after
    chunk i's decode, at window 2 staging runs one chunk ahead."""
    res = _compressed("zfp", window)
    timings = []
    tapi.CompressorStream.decompress(res, backend="torch", timings=timings)
    assert len(timings) == 3 and all(set(t.spans) == {"h2d", "compute"} for t in timings)
    assert all(t.nbytes > 0 and t.serialize == 0.0 == t.d2h for t in timings)
    lanes = tpl.lane_seconds(timings)
    assert lanes["h2d"] > 0 and lanes["compute"] > 0 and lanes["serialize"] == 0.0
    assert 0 < tpl.overlap_efficiency(timings) <= 2.0 + 1e-9
    spans = [t.spans for t in timings]
    for i in range(len(spans) - window):
        assert spans[i + window]["h2d"][0] >= spans[i]["compute"][1]


# ---------------------------------------------------------------------------
# a wrong out raises before any work
# ---------------------------------------------------------------------------


def _wrong_outs(shape):
    return {
        "shape": torch.empty((shape[0] - 1,) + shape[1:]),
        "dtype": torch.empty(shape, dtype=torch.float64),
        "device": torch.empty(shape, device="meta"),
        "strided": torch.empty(shape[::-1]).permute(2, 1, 0),
        "not a tensor": np.empty(shape, np.float32),
    }


@pytest.mark.parametrize("fault", ["shape", "dtype", "device", "strided", "not a tensor"])
def test_a_wrong_out_raises_before_any_work(fault, monkeypatch):
    res = _compressed("zfp", 2)
    out = _wrong_outs(res.shape)[fault]

    def no_work(*args, **kwargs):
        raise AssertionError("the reconstruction started")

    monkeypatch.setattr(tpl, "reconstruct_chunked", no_work)
    monkeypatch.setattr(tapi, "_stage_chunk", no_work)
    with pytest.raises(ValueError, match="out"):
        tapi.CompressorStream.decompress(res, backend="torch", out=out)


def test_a_failing_chunk_surfaces_its_error(monkeypatch):
    res = _compressed("zfp", 2)
    real = tapi._decode_staged
    calls = []

    def fail_second(payload, sections):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("chunk lost")
        return real(payload, sections)

    monkeypatch.setattr(tapi, "_decode_staged", fail_second)
    with pytest.raises(RuntimeError, match="chunk lost"):
        tapi.CompressorStream.decompress(res, backend="torch")


# ---------------------------------------------------------------------------
# the compress side and the checkpoint manager are unchanged
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["zfp", "huffman"])
def test_stream_bytes_equal_the_reference_s(method):
    japi = pytest.importorskip("repro.core.api")
    ours = tapi.CompressorStream.to_bytes(_compressed(method, 2))
    theirs = japi.CompressorStream(method, mode="fixed", c_fixed_elems=CHUNK, window=2,
                                   **METHODS[method]).compress(_data(method))
    assert ours == japi.CompressorStream.to_bytes(theirs)


def test_mgard_stream_chunks_equal_one_shot_encodes():
    res = _compressed("mgard", 2)
    data = torch.from_numpy(_data("mgard"))
    for start, c in zip(res.boundaries, res.chunks):
        rows = c.meta["shape"][0]
        one = tapi.compress(data[start:start + rows].contiguous(), "mgard", backend="torch")
        assert c.to_bytes() == one.to_bytes()


def test_checkpoint_round_trip_through_the_stream(tmp_path, monkeypatch):
    """An exact checkpoint's leaf past ``LOSSLESS_CHUNK_BYTES`` (32 KiB here)
    is a stream of fixed chunks; its restore, now pipelined, equals the
    serial decode of the saved stream and the leaf, bit for bit."""
    from repro_torch.checkpoint import CheckpointManager, CheckpointPolicy, manager
    from repro_torch.core.engine import ExecutionEngine
    from repro_torch.runtime.io import AggregatedReader

    monkeypatch.setattr(manager, "LOSSLESS_CHUNK_BYTES", 32 << 10)
    rng = np.random.default_rng(3)
    tree = {"w": rng.normal(0.0, 0.02, (192, 160)).astype(np.float32),
            "b": rng.normal(0.0, 0.02, 64).astype(np.float32)}
    with ExecutionEngine(devices=[torch.device("cpu")], backend="torch") as eng:
        mgr = CheckpointManager(tmp_path / "ck", CheckpointPolicy(exact=True), engine=eng)
        meta = mgr.save(1, tree)
        entry = meta["leaves"]["w"]
        assert entry["stream"] and "stream" not in meta["leaves"]["b"]
        restored, _ = mgr.restore(1)
    with AggregatedReader(tmp_path / "ck" / "step_00000001" / meta["aggregate"]) as r:
        res = tapi.CompressorStream.from_bytes(r.read(entry["segment"]))
    assert res.boundaries == [0, 51, 102, 153, 191]  # the last chunk one row
    serial = tpl.decompress_chunked(res, lambda c: tapi.decompress(c, backend="torch"))
    assert torch.equal(restored["w"].view(torch.int32), serial.view(torch.int32))
    np.testing.assert_array_equal(restored["w"].numpy(), tree["w"])
    np.testing.assert_array_equal(restored["b"].numpy(), tree["b"])


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------


def test_pipeline_spans_one_set_a_chunk(monkeypatch):
    """The main thread names its work once a chunk (a spy on ``span``);
    under ``torch.profiler`` those ranges land in the trace, one a chunk.
    The lanes' work is timed by the run (``ChunkTiming``), not spanned."""
    data = _data("zfp")
    seen = []
    real = tpl.span

    def spy(name):
        seen.append(name)
        return real(name)

    monkeypatch.setattr(tpl, "span", spy)
    res = _stream("zfp", 2).compress(data)
    tapi.CompressorStream.decompress(res, backend="torch")
    n = len(res.chunks)
    counts = {k: seen.count(k) for k in set(seen)}
    assert counts == {"pipeline.stage": n, "pipeline.wait": 2 * (n - 2),
                      "pipeline.restore_stage": n}

    monkeypatch.setattr(tpl, "span", real)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        res = _stream("zfp", 2).compress(data)
        tapi.CompressorStream.decompress(res, backend="torch")
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    for name, count in (("pipeline.stage", n), ("pipeline.restore_stage", n),
                        ("pipeline.wait", 2 * (n - 2))):
        assert names.count(ttrace.PREFIX + name) == count, name
    assert ttrace.span("pipeline.stage") is ttrace._OFF  # off the profiler: the shared null


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_out_is_readable_on_the_caller_s_stream_at_once(monkeypatch):
    """The last chunk's decode is held back ~0.1 s on the lane's stream; the
    caller's stream reads ``out`` right after the call, with no synchronise,
    and sees every chunk.  Without the run's final stream wait it would read
    the NaNs the output was filled with."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    device = torch.device("cuda", 0)
    g = torch.linspace(0, 8 * np.pi, 128)
    field = (torch.sin(g)[:, None, None] * torch.cos(g)[None, :, None]
             * torch.sin(g)[None, None, :]).contiguous()
    stream = tapi.CompressorStream("zfp", mode="fixed", c_fixed_elems=32 * 128 * 128, window=2,
                                   rate=16)
    res = stream.compress(field)
    want = tpl.decompress_chunked(res, tapi.decompress)
    real = tapi._decode_staged
    calls = []

    def slow_last(payload, sections):
        calls.append(1)
        if len(calls) == len(res.chunks):
            torch.cuda._sleep(200_000_000)  # on the lane's stream, ahead of the decode
        return real(payload, sections)

    monkeypatch.setattr(tapi, "_decode_staged", slow_last)
    out = torch.full(res.shape, float("nan"), device=device)
    torch.cuda.synchronize()
    tapi.CompressorStream.decompress(res, out=out)
    seen = out.clone()  # the caller's stream, no synchronise
    assert torch.equal(seen.view(torch.int32), want.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["decompose", "recompose"])
def test_graphed_transform_equals_the_eager_one(name):
    """``mgard.GraphedTransform`` runs the first call of a shape eagerly,
    captures the second and replays from then on: every call's values equal
    the eager transform's bit for bit, each replay counts the ``tridiag``
    launches the eager call makes, and a returned tensor is the caller's
    own (the next replay does not overwrite it)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.core import mgard
    from repro_torch.kernels.tridiag import kernel as tridiag_kernel

    device = torch.device("cuda", 0)
    shape = (12, 33, 40)
    padded = tuple(mgard.padded_dim(n) for n in shape)
    thomas = mgard.plan_thomas_tables(shape, device)
    fn = getattr(mgard, name)
    graphed = mgard.GraphedTransform(fn)
    gen = torch.Generator(device=device).manual_seed(5)
    inputs = [torch.randn(shape if name == "decompose" else padded, device=device, generator=gen)
              for _ in range(4)]
    tridiag_kernel.reset_launches()
    want = [fn(x, shape, thomas) for x in inputs]
    eager_launches = tridiag_kernel.launches["solve_mass"] // len(inputs)
    tridiag_kernel.reset_launches()
    got = [graphed(x, shape, thomas) for x in inputs]
    assert tridiag_kernel.launches["solve_mass"] == eager_launches * len(inputs)
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("nbytes", [0, 1000, tpl.COPY_SPLIT + 12345])
def test_copy_to_pinned_copies_every_byte(nbytes):
    """The staging copy, split over its threads past ``COPY_SPLIT`` bytes
    (any host memory will do: on the CPU the slots are not page-locked)."""
    src = np.random.default_rng(nbytes).integers(0, 256, nbytes, dtype=np.uint8)
    dst = np.zeros(nbytes + 64, np.uint8)
    tpl.copy_to_pinned(dst.ctypes.data + 32, src.ctypes.data, nbytes)
    assert np.array_equal(dst[32:32 + nbytes], src)
    assert not dst[:32].any() and not dst[32 + nbytes:].any()


def test_copy_to_pinned_from_many_threads_at_once():
    """Staging copies from more threads than cores share the one copy pool;
    each lands whole (a short switch interval to interleave them)."""
    import os
    import sys
    import threading

    n = 3 * (os.cpu_count() or 2)
    size = tpl.COPY_SPLIT + 4097
    srcs = [np.full(size, i % 251, np.uint8) for i in range(n)]
    dsts = [np.zeros(size, np.uint8) for _ in range(n)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=tpl.copy_to_pinned,
                                    args=(d.ctypes.data, s.ctypes.data, size))
                   for d, s in zip(dsts, srcs)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert all(np.array_equal(d, s) for d, s in zip(dsts, srcs))


@pytest.mark.gpu
def test_graphed_transform_shared_by_threads():
    """Threads on streams of their own replay one ``GraphedTransform`` at
    once; each result is its own input's eager transform (a replay waits
    for the previous one's output copy)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import threading

    from repro_torch.core import mgard

    device = torch.device("cuda", 0)
    shape = (9, 33, 33)
    thomas = mgard.plan_thomas_tables(shape, device)
    graphed = mgard.GraphedTransform(mgard.decompose)
    gen = torch.Generator(device=device).manual_seed(11)
    inputs = [torch.randn(shape, device=device, generator=gen) for _ in range(12)]
    want = [mgard.decompose(x, shape, thomas) for x in inputs]
    graphed(inputs[0], shape, thomas)  # eager
    graphed(inputs[0], shape, thomas)  # captured
    torch.cuda.synchronize()
    got = [None] * len(inputs)

    def work(i):
        s = torch.cuda.Stream(device)
        with torch.cuda.stream(s):
            for _ in range(5):
                got[i] = graphed(inputs[i], shape, thomas)
        s.synchronize()

    threads = [threading.Thread(target=work, args=(i,)) for i in range(len(inputs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
