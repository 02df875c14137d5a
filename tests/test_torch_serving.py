"""The port's KV parking and reduction service (``repro_torch.serving.engine``,
``repro_torch.serving.service``) against the reference's, on a CPU engine
(``backend="torch"``).

KV containers and ``HPKV`` spill files are byte-identical to the
reference's and cross-load in both directions; the store's eviction,
tenant quotas, colliding session ids and in-flight park ordering are the
reference's cases (``tests/test_serving.py``); a cache written in place
right after ``park_async`` returns parks the bytes it held before.  The
service's overload, shed, close, bad-request and starvation semantics are
the reference's, and its containers equal the direct API's (and, for ZFP,
the reference's) under concurrent clients.  Exact CMM hit and miss counts
are not compared: they depend on thread timing.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import api as japi
from repro.serving import engine as jengine
from repro.serving import service as jservice
from repro_torch.core import api as tapi
from repro_torch.core import engine as tengine
from repro_torch.core import progressive as tprog
from repro_torch.core.container import Compressed
from repro_torch.serving import (
    KVPageStore,
    ReductionService,
    ServiceOverloaded,
    compress_kv_cache,
    decompress_kv_cache,
    park_kv_cache_async,
)
from repro_torch.serving import engine as sengine

TIMEOUT = 30.0


@pytest.fixture(scope="module")
def eng():
    with tengine.ExecutionEngine([torch.device("cpu")], backend="torch") as e:
        yield e


def _np(x) -> np.ndarray:
    """Host numpy of a leaf (a bfloat16 tensor as its 16-bit words)."""
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def _session_cache(seed, torch_leaves=False):
    r = np.random.default_rng(seed)
    cache = {
        "k": r.normal(size=(2, 4, 64, 8, 16)).astype(np.float32),
        "v": r.normal(size=(2, 4, 64, 8, 16)).astype(np.float32),
        "pos": np.arange(4, dtype=np.int32),
    }
    if torch_leaves:
        return {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    return cache


def _blob(v) -> bytes:
    return v.to_bytes() if hasattr(v, "to_bytes") else _np(v).tobytes()


# ---------------------------------------------------------------------------
# KV containers and spill files against the reference
# ---------------------------------------------------------------------------


def _mixed_cache(seed):
    """float32 pages (ZFP), a small float leaf and int positions (raw), a
    float16 page (ZFP) and a bfloat16 page (raw in both packages: not numpy
    kind "f")."""
    r = np.random.default_rng(seed)
    page = lambda *s: r.normal(size=s).astype(np.float32)  # noqa: E731
    bf = page(2, 32, 4, 16)
    ref = {"k": page(3, 2, 32, 4, 16), "v": page(3, 2, 32, 4, 16),
           "small": page(7, 9), "pos": np.arange(6, dtype=np.int64),
           "half": page(64, 80).astype(np.float16),
           "bf16": np.asarray(jnp.asarray(bf, jnp.bfloat16))}
    ours = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in ref.items() if k != "bf16"}
    ours["bf16"] = torch.from_numpy(bf).to(torch.bfloat16)
    return ours, ref


def test_kv_containers_and_spill_bytes_match_reference(eng):
    ours, ref = _mixed_cache(0)
    tflat, tstats = compress_kv_cache(ours, rate=12, engine=eng)
    jflat, jstats = jengine.compress_kv_cache(ref, rate=12)
    assert list(tflat) == list(jflat)
    assert {k for k, v in tflat.items() if isinstance(v, Compressed)} == {"k", "v", "half"}
    for k in tflat:
        assert _blob(tflat[k]) == _blob(jflat[k]), k
    for key in ("raw", "compressed", "leaves", "compressed_leaves", "ratio"):
        assert tstats[key] == jstats[key], key
    raw = sengine._dump_flat(tflat)
    assert raw == jengine._dump_flat(jflat)
    # cross-load in both directions: same containers, same raw words
    for load in (sengine._load_flat, jengine._load_flat):
        back = load(raw)
        assert [_blob(v) for v in back.values()] == [_blob(v) for v in tflat.values()]
    like = {k: v for k, v in ours.items() if k != "bf16"}
    loaded = {k: v for k, v in sengine._load_flat(raw).items() if k != "bf16"}
    restored = decompress_kv_cache(loaded, like, engine=eng)
    jrestored = jengine.decompress_kv_cache(
        {k: v for k, v in jengine._load_flat(raw).items() if k != "bf16"},
        {k: v for k, v in ref.items() if k != "bf16"})
    for k in like:
        assert _np(restored[k]).tobytes() == np.asarray(jrestored[k]).tobytes(), k
        # int64 comes back as int32 in both (the reference's jnp.asarray)
        assert str(restored[k].dtype).split(".")[1] == str(jrestored[k].dtype), k
    assert np.abs(_np(restored["k"]) - ref["k"]).max() < 0.05 * np.abs(ref["k"]).max()


def test_bf16_leaf_after_a_spill_fails_alike(eng, tmp_path):
    """A bfloat16 raw leaf spills as the reference's ``'<V2'`` npy and comes
    back as opaque words: restoring it then raises ``TypeError`` in both
    packages (a caveat of the reference, recorded in ROADMAP.md)."""
    ours, ref = _mixed_cache(1)
    store = KVPageStore(capacity_bytes=64 << 20, spill_dir=tmp_path / "t", engine=eng)
    jstore = jengine.KVPageStore(capacity_bytes=64 << 20, spill_dir=tmp_path / "j")
    store.park("s", ours)
    jstore.park("s", ref)
    store.cache.evict(("kv_page", "default", "s"))
    jstore.cache.evict(("kv_page", "default", "s"))
    assert store._path("s").name == jstore._path("s").name
    assert store._path("s").read_bytes() == jstore._path("s").read_bytes()
    with pytest.raises(TypeError):
        store.restore("s", ours)
    with pytest.raises(TypeError):
        jstore.restore("s", ref)


def test_kv_cache_compression_roundtrip(eng):
    cache = _session_cache(5, torch_leaves=True)
    comp, stats = compress_kv_cache(cache, rate=16, engine=eng)
    assert stats["ratio"] > 1.5
    restored = decompress_kv_cache(comp, cache, engine=eng)
    for key in ("k", "v"):
        scale = cache[key].abs().max()
        assert float((restored[key] - cache[key]).abs().max() / scale) < 2e-3
    assert torch.equal(restored["pos"], cache["pos"])


def test_park_async_snapshot_survives_in_place_writes(eng, tmp_path):
    """The decode loop writes its cache in place: a park must hold the bytes
    the cache had when ``park_async`` returned, compressed leaves and raw."""
    cache = _session_cache(6, torch_leaves=True)
    before = {k: v.clone() for k, v in cache.items()}
    gate = threading.Event()
    real = eng.executor
    eng.executor = _GatedIOExecutor(real, gate)
    try:
        sub = park_kv_cache_async(cache, rate=12, engine=eng)
        store = KVPageStore(capacity_bytes=64 << 20, spill_dir=tmp_path, engine=eng)
        ssub = store.park_async("s", cache)
        cache["k"].add_(1.0)
        cache["v"].zero_()
        cache["pos"].fill_(-1)
        gate.set()
        flat, _ = sub.result(timeout=TIMEOUT)
        ssub.result(timeout=TIMEOUT)
    finally:
        eng.executor = real
    want, _ = compress_kv_cache(before, rate=12, engine=eng)
    for got in (flat, store.fetch("s")):
        assert [_blob(v) for v in got.values()] == [_blob(v) for v in want.values()]
    # a synchronous park keeps a copy of its raw leaves too
    store.park("sync", cache)
    cache["pos"].fill_(5)
    assert torch.equal(store.fetch("sync")["pos"], torch.full((4,), -1, dtype=torch.int32))


# ---------------------------------------------------------------------------
# parked-session store (the reference's cases)
# ---------------------------------------------------------------------------


def test_kv_page_store_evicts_and_rematerializes(eng, tmp_path):
    store = KVPageStore(capacity_bytes=600_000, spill_dir=tmp_path, rate=16, engine=eng)
    sessions = {f"s{i}": _session_cache(i) for i in range(4)}
    for sid, cache in sessions.items():
        assert store.park(sid, cache)["compressed_leaves"] == 2
    st = store.stats()
    assert st["parked_bytes"] <= st["capacity_bytes"]
    assert st["spills"] >= 1 and st["evictions"] >= 1
    assert store._path("s0").exists()
    restored = store.restore("s0", sessions["s0"])
    np.testing.assert_array_equal(_np(restored["pos"]), sessions["s0"]["pos"])
    for leaf in ("k", "v"):
        err = np.abs(_np(restored[leaf]) - sessions["s0"][leaf]).max()
        assert err < 1e-2 * np.abs(sessions["s0"][leaf]).max()
    assert store.stats()["loads"] >= 1
    loads_before = store.stats()["loads"]
    store.restore("s3", sessions["s3"])
    assert store.stats()["loads"] == loads_before
    store.release("s0")
    assert not store._path("s0").exists()


def test_kv_page_store_matches_reference_store(eng, tmp_path):
    """Same sessions, same budget: the same evictions and spill files, byte
    for byte, and each store loads the other's spills."""
    store = KVPageStore(capacity_bytes=600_000, spill_dir=tmp_path / "t", rate=16, engine=eng)
    jstore = jengine.KVPageStore(capacity_bytes=600_000, spill_dir=tmp_path / "j", rate=16)
    for i in range(4):
        store.park(f"s{i}", _session_cache(i, torch_leaves=True))
        jstore.park(f"s{i}", _session_cache(i))
    st, jst = store.stats(), jstore.stats()
    for key in ("sessions", "parked_bytes", "spills", "evictions", "tenant_bytes"):
        assert st[key] == jst[key], key
    spills = sorted(p.name for p in (tmp_path / "t").iterdir())
    assert spills == sorted(p.name for p in (tmp_path / "j").iterdir()) and spills
    for name in spills:
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
    # swap the spill directories: each store re-materialises the other's file
    store.spill_dir, jstore.spill_dir = jstore.spill_dir, store.spill_dir
    a = store.fetch("s0")
    b = jstore.fetch("s0")
    assert [_blob(v) for v in a.values()] == [_blob(v) for v in b.values()]


def test_kv_page_store_async_and_unknown_session(eng, tmp_path):
    store = KVPageStore(capacity_bytes=64 << 20, spill_dir=tmp_path, rate=16, engine=eng)
    stats = store.park_async("bg", _session_cache(7)).result(timeout=TIMEOUT)
    assert stats["compressed_leaves"] == 2
    assert "bg" in str(sorted(k[2] for k in store.cache._entries))
    with pytest.raises(KeyError, match="unknown parked session"):
        store.fetch("never-parked")


def test_kv_page_store_colliding_session_ids_get_distinct_spills(eng, tmp_path):
    store = KVPageStore(capacity_bytes=64 << 20, spill_dir=tmp_path, rate=16, engine=eng)
    assert store._path("user:1") != store._path("user_1")
    a, b = _session_cache(1), _session_cache(2)
    store.park("user:1", a)
    store.park("user_1", b)
    store.cache.evict(("kv_page", "default", "user:1"))
    store.cache.evict(("kv_page", "default", "user_1"))
    ra = store.restore("user:1", a)
    rb = store.restore("user_1", b)
    assert not np.allclose(_np(ra["k"]), _np(rb["k"]))
    assert np.abs(_np(ra["k"]) - a["k"]).max() < 1e-2 * np.abs(a["k"]).max()


def test_two_tenant_quota_eviction_ordering(eng, tmp_path):
    store = KVPageStore(capacity_bytes=64 << 20, spill_dir=tmp_path, rate=16, engine=eng,
                        tenant_quota_bytes={"heavy": 450_000})
    for i in range(4):
        store.park(f"a{i}", _session_cache(i), tenant="heavy")
    store.park("b0", _session_cache(9), tenant="light")
    st = store.stats()
    assert st["tenant_bytes"]["heavy"] <= 450_000
    assert st["tenant_evictions"]["heavy"] >= 1
    resident = {k[2] for k in store.cache._entries if k[1] == "heavy"}
    evicted = {f"a{i}" for i in range(4)} - resident
    assert max(int(s[1]) for s in evicted) < min(int(s[1]) for s in resident)
    for sid in evicted:
        assert store._path(sid, "heavy").exists()
    assert "light" not in st["tenant_evictions"]
    loads = store.stats()["loads"]
    store.restore("b0", _session_cache(9), tenant="light")
    assert store.stats()["loads"] == loads
    sid = sorted(evicted)[0]
    want = _session_cache(int(sid[1]))
    restored = store.restore(sid, want, tenant="heavy")
    assert np.abs(_np(restored["k"]) - want["k"]).max() < 1e-2 * np.abs(want["k"]).max()
    assert store.stats()["loads"] == loads + 1


def test_same_session_id_isolated_across_tenants(eng, tmp_path):
    store = KVPageStore(capacity_bytes=64 << 20, spill_dir=tmp_path, rate=16, engine=eng)
    a, b = _session_cache(1), _session_cache(2)
    store.park("shared", a, tenant="t1")
    store.park("shared", b, tenant="t2")
    assert store._path("shared", "t1") != store._path("shared", "t2")
    ra = store.restore("shared", a, tenant="t1")
    rb = store.restore("shared", b, tenant="t2")
    assert not np.allclose(_np(ra["k"]), _np(rb["k"]))


class _GatedIOExecutor:
    """Instrumented executor: io-lane bodies stall until ``gate`` is set."""

    def __init__(self, inner, gate):
        self._inner = inner
        self.gate = gate

    def submit(self, fn, /, *args, lane="compute", **kwargs):
        if lane == "io":
            gate = self.gate

            def gated(*a, **k):
                gate.wait(TIMEOUT)
                return fn(*a, **k)

            return self._inner.submit(gated, *args, lane=lane, **kwargs)
        return self._inner.submit(fn, *args, lane=lane, **kwargs)

    def __getattr__(self, name):
        return getattr(self._inner, name)


@pytest.mark.parametrize("reader", ["fetch", "release"])
def test_park_async_readers_wait_for_inflight_park(tmp_path, reader):
    gate = threading.Event()
    with tengine.ExecutionEngine([torch.device("cpu")], backend="torch") as e:
        e.executor = _GatedIOExecutor(e.executor, gate)
        store = KVPageStore(capacity_bytes=64 << 20, spill_dir=tmp_path, rate=16, engine=e)
        cache = _session_cache(3)
        sub = store.park_async("s", cache)
        got = {}

        def run():
            got["out"] = getattr(store, reader)("s")

        t = threading.Thread(target=run)
        t.start()
        time.sleep(0.15)
        assert t.is_alive() and "out" not in got  # waits, no KeyError
        gate.set()
        t.join(TIMEOUT)
        assert not t.is_alive()
        assert sub.result(timeout=TIMEOUT)["compressed_leaves"] == 2
        if reader == "fetch":
            restored = store.restore("s", cache)
            assert np.abs(_np(restored["k"]) - cache["k"]).max() < 1e-2 * np.abs(cache["k"]).max()
        else:
            with pytest.raises(KeyError):
                store.fetch("s")


# ---------------------------------------------------------------------------
# ReductionService (the reference's cases)
# ---------------------------------------------------------------------------


def _zfp_select(key, arr):
    del key, arr
    return "zfp", {"rate": 16}


def test_service_stats_have_the_reference_fields():
    from repro_torch.serving import service as tservice

    assert [f.name for f in dataclasses.fields(tservice.ServiceStats)] == [
        f.name for f in dataclasses.fields(jservice.ServiceStats)]
    assert tservice.OVERLOAD_POLICIES == jservice.OVERLOAD_POLICIES
    assert tservice.PRIORITIES == jservice.PRIORITIES
    assert tservice._KIND_PRIORITY == jservice._KIND_PRIORITY


def _wait_depth(svc, depth):
    deadline = time.monotonic() + TIMEOUT
    while svc.stats().queue_depth < depth:
        assert time.monotonic() < deadline, "requests never queued"
        time.sleep(0.005)


def test_service_coalesces_across_requests(eng):
    """Five requests queued behind a stalled dispatch leave in one cycle:
    their same-spec leaves share one stacked bucket."""
    rng = np.random.default_rng(0)
    trees = [{"w": rng.normal(size=(37, 53)).astype(np.float32)} for _ in range(5)]
    with ReductionService(eng, batch_window=0.05, max_queue=16) as svc:
        gate, stall = _stall_dispatcher(svc)
        subs = [svc.submit_compress(t, _zfp_select) for t in trees]
        _wait_depth(svc, len(trees))
        gate.set()
        outs = [s.result(TIMEOUT) for s in subs]
        stall.result(TIMEOUT)
        snap = svc.stats()
    assert snap.stacked_buckets == 1 and snap.stacked_leaves == len(trees)
    assert snap.batch_fill_ratio == len(trees) and snap.requests_per_bucket == len(trees)
    assert snap.coalesced_requests == len(trees)
    assert snap.completed == len(trees) + 1
    for tree, (flat, stats) in zip(trees, outs):
        direct = tapi.compress_leaf(tree["w"], "zfp", rate=16, backend="torch")
        assert flat["w"].to_bytes() == direct.to_bytes() and stats["coalesced"]


def _stalling(gate, choice=("zfp", {"rate": 16}), entered=None):
    def stalling_select(key, arr):
        if entered is not None:
            entered.set()
        gate.wait(TIMEOUT)  # runs in the dispatcher: deterministically stalls it
        return choice

    return stalling_select


def _stall_dispatcher(svc):
    """Park the dispatcher inside a dispatch (its batch closed); returns the
    gate that releases it and the stalled request."""
    gate, entered = threading.Event(), threading.Event()
    stall = svc.submit_compress({"x": np.zeros(4, np.float32)}, _stalling(gate, None, entered))
    assert entered.wait(TIMEOUT)
    return gate, stall


def test_service_overload_reject_and_block_timeout(eng):
    rng = np.random.default_rng(0)
    tree = {"w": rng.normal(size=(32, 32)).astype(np.float32)}
    svc = ReductionService(eng, max_queue=1, overload="reject", batch_window=0.0)
    gate, stalled = _stall_dispatcher(svc)
    queued = svc.submit_compress(tree, _zfp_select)
    with pytest.raises(ServiceOverloaded):
        svc.submit_compress(tree, _zfp_select)
    assert svc.stats().rejected == 1
    gate.set()
    stalled.result(TIMEOUT)
    queued.result(TIMEOUT)
    svc.close()

    svc = ReductionService(eng, max_queue=1, overload="block", batch_window=0.0)
    gate, stalled = _stall_dispatcher(svc)
    queued = svc.submit_compress(tree, _zfp_select)
    t0 = time.monotonic()
    with pytest.raises(ServiceOverloaded):
        svc.submit_compress(tree, _zfp_select, timeout=0.2)
    assert time.monotonic() - t0 >= 0.2
    gate.set()
    stalled.result(TIMEOUT)
    queued.result(TIMEOUT)
    svc.close()


def test_service_overload_shed_drops_oldest(eng):
    rng = np.random.default_rng(0)
    tree = {"w": rng.normal(size=(32, 32)).astype(np.float32)}
    svc = ReductionService(eng, max_queue=2, overload="shed", batch_window=0.0)
    gate, stalled = _stall_dispatcher(svc)
    old = svc.submit_compress(tree, _zfp_select)
    mid = svc.submit_compress(tree, _zfp_select)
    new = svc.submit_compress(tree, _zfp_select)
    with pytest.raises(ServiceOverloaded, match="shed"):
        old.result(timeout=5)
    gate.set()
    stalled.result(TIMEOUT)
    mid.result(TIMEOUT)
    new.result(TIMEOUT)
    assert svc.stats().shed == 1
    svc.close()


def test_service_submit_after_close_raises(eng):
    svc = ReductionService(eng)
    svc.close()
    svc.close()  # idempotent
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit_compress({"w": np.zeros((8, 8), np.float32)}, _zfp_select)


def test_service_bad_request_fails_future_only(eng):
    rng = np.random.default_rng(0)
    with ReductionService(eng, batch_window=0.0) as svc:
        def broken_select(key, arr):
            raise ValueError("select blew up")

        bad = svc.submit_compress({"w": rng.normal(size=(16, 16)).astype(np.float32)},
                                  broken_select)
        good = svc.submit_compress({"w": rng.normal(size=(16, 16)).astype(np.float32)},
                                   _zfp_select)
        with pytest.raises(ValueError, match="select blew up"):
            bad.result(timeout=TIMEOUT)
        _flat, stats = good.result(timeout=TIMEOUT)
        assert stats["compressed_leaves"] == 1
        assert svc.stats().failed == 1


def test_service_soak_bit_identity_with_direct_api(eng):
    """Concurrent clients with mixed codecs and a per-thread unique-shape
    leaf: every container equals the direct API's (ZFP also the
    reference's), coalesced and fallback paths both run, and the decompress
    equals the direct inverse."""
    rng = np.random.default_rng(7)
    n_threads, n_rounds = 4, 2

    def make_tree(i, r):
        return {
            "shared_zfp": rng.normal(size=(40, 48)).astype(np.float32),
            "shared_mgard": rng.normal(size=(24, 24)).astype(np.float32),
            "unique": rng.normal(size=(8 + i, 9 + r)).astype(np.float32),
            "raw": np.arange(4, dtype=np.int32),
        }

    def select(key, arr):
        if key in ("shared_mgard", "unique"):
            return "mgard", {"error_bound": 1e-2}
        if tapi.dtype_name(arr).startswith("float"):
            return "zfp", {"rate": 16}
        return None

    trees = {(i, r): make_tree(i, r) for i in range(n_threads) for r in range(n_rounds)}
    with ReductionService(eng, batch_window=0.02, max_queue=64) as svc:
        outs, errs = {}, []

        def worker(i):
            try:
                for r in range(n_rounds):
                    outs[(i, r)] = svc.compress(trees[(i, r)], select)
            except Exception as e:  # surfaced below
                errs.append(e)

        # the first round queues behind a stalled dispatch, so it coalesces
        gate, stall = _stall_dispatcher(svc)
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(n_threads)]
        for t in threads:
            t.start()
        _wait_depth(svc, n_threads)
        gate.set()
        stall.result(TIMEOUT)
        for t in threads:
            t.join(120)
        assert not errs and not any(t.is_alive() for t in threads)
        snap = svc.stats()
        for key_ir, (flat, _stats) in outs.items():
            direct, _ = tapi.compress_pytree(trees[key_ir], select, engine=eng)
            ref, _ = japi.compress_pytree(trees[key_ir], select)
            for key, val in direct.items():
                if isinstance(val, Compressed):
                    assert flat[key].to_bytes() == val.to_bytes(), (key_ir, key)
                    if val.method == "zfp":
                        assert val.to_bytes() == ref[key].to_bytes(), (key_ir, key)
                else:
                    np.testing.assert_array_equal(_np(flat[key]), _np(val))
        flat, _ = outs[(0, 0)]
        via_svc = svc.decompress(flat, trees[(0, 0)])
        via_api = tapi.decompress_pytree(flat, trees[(0, 0)], engine=eng)
        for k in via_api:
            assert torch.equal(via_svc[k], via_api[k]), k
    assert snap.stacked_leaves > 0
    assert snap.fallback_leaves > 0
    assert snap.completed == n_threads * n_rounds + 1
    assert snap.batch_fill_ratio > 1.0


def test_service_priority_starvation_bound(eng):
    rng = np.random.default_rng(0)
    tree = {"w": rng.normal(size=(16, 16)).astype(np.float32)}
    dwell = 0.15

    def slow_select(key, arr):
        time.sleep(dwell)
        return _zfp_select(key, arr)

    with ReductionService(eng, max_queue=64, batch_window=0.0, max_batch_requests=1,
                          starvation_limit=2) as svc:
        svc.park_kv("starve", {"k": tree["w"]})
        bulk = [svc.submit_compress(tree, slow_select) for _ in range(6)]
        time.sleep(dwell / 2)
        inter = [svc.submit_fetch_kv("starve") for _ in range(4)]
        for s in inter:
            assert "k" in s.result(timeout=60)
        for s in bulk:
            s.result(timeout=60)
        st = svc.stats()
    pi, pb = st.priorities["interactive"], st.priorities["bulk"]
    assert pi["admitted"] == pi["dispatched"] == 4
    assert pb["dispatched"] == 7
    for h in (pi, pb):
        assert h["samples"] >= 1
        assert 0.0 <= h["wait_p50"] <= h["wait_p99"]
        assert h["wait_p99"] <= h["wait_max"] + 1e-9
    assert pi["wait_p99"] < pb["wait_p99"]
    assert pi["wait_p99"] < 4 * dwell
    assert pb["forced"] >= 1
    assert st.executor_priorities.get("bulk", {}).get("submitted", 0) >= 1


def test_service_streams_quicklook_and_kv(eng, tmp_path):
    """compress_stream == a direct CompressorStream (and the reference's
    service), overlapping decompress_stream requests in one dispatch cycle
    share chunk decodes, quicklook == a direct reader, KV requests round
    trip."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(16, 40)).astype(np.float32)
    with ReductionService(eng, batch_window=0.01, spill_dir=tmp_path / "kv") as svc:
        blob, info = svc.compress_stream(torch.from_numpy(x), "zfp", rate=12, chunk_size=80,
                                         window=2)
        direct = tapi.CompressorStream("zfp", engine=eng, rate=12, chunk_size=80, window=2)
        assert blob == tapi.CompressorStream.to_bytes(direct.compress(x))
        with jservice.ReductionService(max_queue=4) as jsvc:
            jblob, _ = jsvc.compress_stream(x, "zfp", rate=12, chunk_size=80, window=2)
        assert blob == jblob
        assert info["chunks"] == 8 and info["raw_bytes"] == x.nbytes

        gate, stall = _stall_dispatcher(svc)
        subs = [svc.submit_decompress_stream(blob, chunks=(0, 5)),
                svc.submit_decompress_stream(blob, chunks=(3, 8))]
        gate.set()
        stall.result(TIMEOUT)
        (a, ia), (b, ib) = (s.result(TIMEOUT) for s in subs)
        res = tapi.CompressorStream.from_bytes(blob)
        whole = tapi.CompressorStream.decompress(res, backend="torch")
        ends = res.boundaries + [x.shape[res.axis]]
        assert torch.equal(a, whole.narrow(res.axis, 0, ends[5]))
        assert torch.equal(b, whole.narrow(res.axis, ends[3], ends[8] - ends[3]))
        assert ia["group_requests"] == 2 and ib["group_coalesce_hits"] == 2
        assert svc.stats().chunk_coalesce_hits == 2

        field = np.sin(np.linspace(0, 6, 9 ** 3)).reshape(9, 9, 9).astype(np.float32)
        path = tmp_path / "field.hpdp"
        tprog.refactor(field, 1e-3, tiers=2, backend="torch").write(path)
        arr, qinfo = svc.quicklook(path, tiers=1)
        with tprog.ProgressiveReader(path, backend="torch") as r:
            assert torch.equal(arr, r.retrieve(tiers=1))
            assert qinfo["bytes_fetched"] == r.bytes_fetched
        assert qinfo["tiers_loaded"] == 1

        cache = _session_cache(8, torch_leaves=True)
        svc.park_kv("s", cache, tenant="t")
        fetched = svc.submit_fetch_kv("s", tenant="t").result(TIMEOUT)
        assert fetched["k"].to_bytes() == svc.fetch_kv("s", tenant="t")["k"].to_bytes()
        out = svc.restore_kv("s", cache, tenant="t")
        # the service parks at rate 12: ~2% of the range on N(0, 1) pages
        assert float((out["k"] - cache["k"]).abs().max()) < 5e-2 * float(cache["k"].abs().max())
        assert svc.stats().per_tenant["t"]["parked_bytes"] > 0
        svc.release_kv("s", tenant="t")
        with pytest.raises(KeyError):
            svc.fetch_kv("s", tenant="t")
