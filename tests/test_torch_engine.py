"""The port's execution engine, executor and pytree entry points against the
reference (``repro.core.engine``, ``repro.runtime.executor``,
``repro.core.api.compress_pytree``), on a CPU engine (``backend="torch"``).

One small nested tree holds raw leaves, a stacked ZFP bucket (four leaves,
plus a bucket of two whose blocked shape needs padding), a ZFP singleton, a
``huffman`` integer leaf and a ``mgard-progressive`` leaf (one tier: the
plain Huffman decode costs ~0.5 s a stream on the CPU, so the module keeps
its streams few).  A bucket of two MGARD leaves runs the batched path whose
stages loop over the leaves.  Both packages compress it: the flat keys come
out equal and in the same order, the ``zfp``/``huffman*`` containers byte
for byte, MGARD leaves within their bound, the statistics equal; the port's
decode equals per-leaf ``decompress_leaf`` and decodes the reference's
mapping.  The executor cases are the reference's (shutdown, drain,
``submit_after``, callbacks, priority stats).
"""

import inspect
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import api as japi
from repro.core.context import GLOBAL_CMM as JCMM
from repro.core.engine import ExecutionEngine as JEngine
from repro_torch.core import api as tapi
from repro_torch.core import engine as tengine
from repro_torch.core.container import Compressed
from repro_torch.core.context import GLOBAL_CMM as TCMM
from repro_torch.launch import mesh as tmesh
from repro_torch.runtime.executor import DeviceExecutor

CPU = [torch.device("cpu")]
PROGRESSIVE = {"tiers": 1}
# the keys each compress call writes; the reference's engine counts its
# transfers where the port counts none on the CPU, and names its backend
# "xla" where the port's is "torch"
STATS_SKIP = ("devices", "backend", "transfer_h2d", "transfer_d2h")


def _tree() -> dict:
    rng = np.random.default_rng(11)
    w = lambda *s: rng.normal(0.0, 0.02, s).astype(np.float32)  # noqa: E731
    return {
        "layers": [
            {"wq": w(64, 128), "wk": w(128, 64), "norm": w(256), "odd": w(40, 128)}
            for _ in range(2)
        ],
        "embed": w(96, 64),
        "ids": rng.integers(0, 50, 5000).astype(np.int32),
        "field": np.sin(np.linspace(0, 6, 9 ** 3)).reshape(9, 9, 9).astype(np.float32),
        "step": np.int64(7),
        "extra": (None, [np.arange(3, dtype=np.int16)]),
    }


def _select(key: str, arr):
    if key == "ids":
        return "huffman", {}
    if key == "field":
        return "mgard-progressive", dict(PROGRESSIVE)
    return tapi.default_select(key, arr)


def _jselect(key: str, arr):
    if key in ("ids", "field"):
        return _select(key, arr)
    return japi.default_select(key, arr)


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def run():
    tree = _tree()
    eng = tengine.ExecutionEngine(devices=CPU, backend="torch")
    jeng = JEngine()
    TCMM.clear()
    JCMM.clear()
    cmm = {}
    t0 = (TCMM.hit_count, TCMM.miss_count)
    flat, stats = eng.compress_pytree(tree, _select)
    cmm["port"] = (TCMM.hit_count - t0[0], TCMM.miss_count - t0[1])
    j0 = (JCMM.hit_count, JCMM.miss_count)
    jflat, jstats = jeng.compress_pytree(tree, _jselect)
    cmm["ref"] = (JCMM.hit_count - j0[0], JCMM.miss_count - j0[1])
    out = eng.decompress_pytree(flat, tree)
    jout = jeng.decompress_pytree(jflat, tree)
    res = {"tree": tree, "flat": flat, "stats": stats, "jflat": jflat, "jstats": jstats,
           "out": out, "jout": jout, "cmm": cmm, "estats": eng.stats(),
           "jestats": jeng.stats(), "eng": eng}
    yield res
    eng.close()
    jeng.close()


def test_flat_keys_match_reference(run):
    keys = list(run["flat"])
    assert keys == list(run["jflat"])
    assert keys[:4] == ["embed", "extra/1/0", "field", "ids"]
    assert "layers/0/wq" in keys and "layers/1/norm" in keys
    assert [k for k, _ in tapi.flatten_with_keys(run["tree"])] == keys


@pytest.mark.parametrize("key", ["embed", "ids", "layers/0/wq", "layers/0/wk", "layers/1/wq",
                                 "layers/1/wk", "layers/0/odd", "layers/1/odd"])
def test_zfp_and_huffman_containers_bytes_identical(run, key):
    c, jc = run["flat"][key], run["jflat"][key]
    assert isinstance(c, Compressed)
    assert c.method == jc.method and c.method in ("zfp", "huffman", "huffman-bytes")
    assert c.to_bytes() == jc.to_bytes()


def test_raw_leaves_pass_through(run):
    for key in ("extra/1/0", "step", "layers/0/norm"):
        assert not isinstance(run["flat"][key], Compressed)
        np.testing.assert_array_equal(_np(run["flat"][key]), np.asarray(run["jflat"][key]))


def test_mgard_leaf_within_its_bound(run):
    c = run["flat"]["field"]
    assert c.method == "mgard-progressive" and len(c.meta["tier_bounds"]) == 1
    f = run["tree"]["field"]
    for out in (run["out"]["field"], run["jout"]["field"]):
        assert float(np.abs(_np(out) - f).max()) <= c.meta["tier_bounds"][-1]


def test_compress_stats_match_reference(run):
    stats, jstats = run["stats"], run["jstats"]
    assert set(stats) == set(jstats)
    assert {k: v for k, v in stats.items() if k != "devices"} == {
        k: v for k, v in jstats.items() if k != "devices"}
    assert stats["buckets"] == 5 and stats["sharded_leaves"] == 6


def test_engine_stats_match_reference(run):
    s, j = run["estats"], run["jestats"]
    assert set(s) == set(j)
    assert {k: v for k, v in s.items() if k not in STATS_SKIP} == {
        k: v for k, v in j.items() if k not in STATS_SKIP}
    assert s["backend"] == "torch" and s["devices"] == 1
    assert s["transfer_h2d"] == s["transfer_d2h"] == 0  # nothing crossed to a card
    # two batched ZFP buckets each way, one segment each (the reference's)
    assert s["mesh_submitted"] == 4 and s["shard_map_calls"] == 4


def test_cmm_one_miss_per_bucket(run):
    assert run["cmm"]["port"] == run["cmm"]["ref"]
    eng = run["eng"]
    TCMM.clear()
    m0, h0 = TCMM.miss_count, TCMM.hit_count
    _, _, jobs, _ = eng.encode_leaf_jobs(run["tree"], _select)
    buckets = eng.bucket_encode_jobs(jobs)
    assert TCMM.miss_count - m0 == len(buckets) == 5
    assert TCMM.hit_count - h0 == len(jobs) - len(buckets)


def test_decompress_equals_per_leaf_decompress_leaf(run):
    out = run["out"]
    assert isinstance(out["layers"], list) and isinstance(out["extra"], tuple)
    assert out["extra"][0] is None
    for key, c in run["flat"].items():
        got = dict(tapi.flatten_with_keys(out))[key]
        if isinstance(c, Compressed):
            want = tapi.decompress_leaf(c, backend="torch")
            assert got.dtype == want.dtype and got.shape == want.shape
            assert np.array_equal(got.numpy().view(np.uint8), want.numpy().view(np.uint8)), key
        orig = dict(tapi.flatten_with_keys(run["tree"]))[key]
        assert tuple(got.shape) == np.shape(orig)
    np.testing.assert_array_equal(out["ids"].numpy(), run["tree"]["ids"])
    np.testing.assert_array_equal(out["layers"][1]["norm"].numpy(), run["tree"]["layers"][1]["norm"])


def test_decodes_reference_flat_mapping(run):
    """The reference's containers through bytes decode in the port's engine
    to what the reference decodes (ZFP and Huffman exactly)."""
    carried = {k: Compressed.from_bytes(v.to_bytes()) if isinstance(v, japi.Compressed) else v
               for k, v in run["jflat"].items()}
    eng = run["eng"]
    out = dict(tapi.flatten_with_keys(eng.decompress_pytree(carried, run["tree"])))
    jout = dict(tapi.flatten_with_keys(run["jout"]))
    for key, got in out.items():
        want = np.asarray(jout[key])
        if key == "field":
            bound = run["jflat"][key].meta["tier_bounds"][-1]
            assert float(np.abs(got.numpy() - run["tree"]["field"]).max()) <= bound
        else:
            np.testing.assert_array_equal(got.numpy(), want, err_msg=key)


@pytest.mark.parametrize("n_hosts", [2, 3])
def test_owned_only_keeps_reference_leaves(monkeypatch, n_hosts):
    tree = _tree()
    monkeypatch.setenv(tmesh.ENV_HOST_COUNT, str(n_hosts))
    for host in range(n_hosts):
        monkeypatch.setenv(tmesh.ENV_HOST_ID, str(host))
        with tengine.ExecutionEngine(devices=CPU, backend="torch") as eng, JEngine() as jeng:
            order, raw, jobs, stats = eng.encode_leaf_jobs(tree, _select, owned_only=True)
            jorder, jraw, jjobs, jstats = jeng.encode_leaf_jobs(tree, _jselect, owned_only=True)
        assert order == jorder and sorted(raw) == sorted(jraw)
        assert [j[0] for j in jobs] == [j[0] for j in jjobs]
        assert stats["remote_leaves"] == jstats["remote_leaves"]


def test_mgard_bucket_runs_batched_and_matches_serial():
    """A bucket of two MGARD leaves (the batched run loops its stages over
    the leaves) gives each leaf's serial container and serial decode."""
    rng = np.random.default_rng(5)
    tree = {"a": rng.normal(size=(9, 9, 9)).astype(np.float32),
            "b": rng.normal(size=(9, 9, 9)).astype(np.float32)}
    select = lambda k, a: ("mgard", {"error_bound": 1e-2})  # noqa: E731
    with tengine.ExecutionEngine(devices=CPU, backend="torch") as eng:
        flat, stats = eng.compress_pytree(tree, select)
        out = eng.decompress_pytree(flat, tree)
        assert stats["sharded_leaves"] == 2 and eng.stats()["sharded_decoded_leaves"] == 2
        assert eng.stats()["shard_map_calls"] == 3 + 1  # the reference's segments
    for key, arr in tree.items():
        serial = tapi.compress_leaf(arr, "mgard", error_bound=1e-2, backend="torch")
        assert flat[key].to_bytes() == serial.to_bytes()
        assert torch.equal(out[key], tapi.decompress_leaf(serial, backend="torch"))


def test_submit_result_futures():
    f = np.sin(np.linspace(0, 9, 16 ** 3)).reshape(16, 16, 16).astype(np.float32)
    with tengine.ExecutionEngine(devices=CPU, backend="torch") as eng:
        spec = eng.make_spec(f, "zfp", rate=8)
        assert spec.backend == "torch"
        subs = [eng.submit_encode(spec, f) for _ in range(4)]
        blobs = {eng.result(s).to_bytes() for s in subs}
        assert len(blobs) == 1
        assert blobs == {japi.compress(jnp.asarray(f), "zfp", rate=8).to_bytes()}
        sub = eng.submit_decode(subs[0].result())
        assert sub.device == torch.device("cpu")
        assert tuple(sub.result().shape) == f.shape
        assert eng.stats()["submitted"] == 5
        # the engine's stream: its backend, its executor, auto plans by default
        stream = eng.stream("zfp", rate=8)
        assert stream.backend == "torch" and stream.params == {"rate": 8}
        assert stream.pipeline.executor is eng.executor and stream.pipeline.devices == CPU
        assert stream.pipeline.auto_chunk and stream.pipeline.auto_window


_MESH_FIRST_SCRIPT = r"""
import numpy as np, torch, torch.distributed as dist
from repro_torch.core import engine as E

m = E.make_data_mesh([torch.device("cpu")])   # a world-size-1 gloo group
tree = {"w": torch.from_numpy(np.random.default_rng(0).normal(size=(64, 96)).astype(np.float32)),
        "b": torch.zeros(5)}
with E.ExecutionEngine(m, "torch") as a, E.ExecutionEngine(mesh=m, backend="torch") as b:
    assert a.mesh is m and b.mesh is m and a.backend == b.backend == "torch"
    assert a.devices == b.devices == [torch.device("cpu")]
    fa, sa = a.compress_pytree(tree)
    fb, sb = b.compress_pytree(tree)
    assert fa["w"].to_bytes() == fb["w"].to_bytes() and torch.equal(fa["b"], fb["b"])
dist.destroy_process_group()
print("MESH FIRST OK")
"""


def test_engine_takes_a_mesh_first_as_the_reference():
    """``ExecutionEngine(mesh, backend, ...)`` in the reference's order: a
    mesh given positionally is the engine's mesh (in a subprocess, since a
    process group must not start in the test process), and its bytes equal
    those of ``mesh=``."""
    assert list(inspect.signature(tengine.ExecutionEngine).parameters)[:5] == list(
        inspect.signature(JEngine).parameters)
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parents[1] / "src"))
    out = subprocess.run([sys.executable, "-c", _MESH_FIRST_SCRIPT], capture_output=True,
                         text=True, env=env, timeout=240)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "MESH FIRST OK" in out.stdout


@pytest.mark.parametrize("ring", [CPU, tuple(CPU), [None]])
def test_engine_reads_a_device_list_only_as_devices(ring):
    """A device list where the mesh goes raises, naming ``devices=``."""
    with pytest.raises(TypeError, match="devices="):
        tengine.ExecutionEngine(ring, backend="torch")
    with tengine.ExecutionEngine(devices=CPU, backend="torch") as eng:
        assert eng.mesh is None and eng.devices == CPU


def test_default_engine_and_entry_points(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="CUDA"):
        tengine.ExecutionEngine()
    with pytest.raises(ValueError, match="cpu devices"):
        tengine.ExecutionEngine(devices=[torch.device("meta")], backend="torch")
    eng = tengine.ExecutionEngine(devices=CPU, backend="torch")
    old = tengine.set_default_engine(eng)
    try:
        assert tengine.default_engine() is eng
        tree = {"w": np.ones((64, 64), np.float32), "b": np.zeros(3, np.float32)}
        flat, stats = tapi.compress_pytree(tree)
        assert flat["w"].method == "zfp" and not isinstance(flat["b"], Compressed)
        back = tapi.decompress_pytree(flat, tree)
        assert torch.equal(back["w"], tapi.decompress_leaf(flat["w"], backend="torch"))
        assert torch.equal(back["b"], torch.zeros(3))
    finally:
        tengine.set_default_engine(old)
        eng.close()


@pytest.mark.parametrize("dtype,size,want", [
    ("float32", 4096, "zfp"), ("float16", 5000, "zfp"), ("float64", 4096, "zfp"),
    ("float32", 4095, None), ("int32", 8192, None), ("bfloat16", 8192, None),
])
def test_default_select_matches_reference(dtype, size, want):
    if dtype == "bfloat16":
        import ml_dtypes

        arr = np.zeros(size, ml_dtypes.bfloat16)
    else:
        arr = np.zeros(size, dtype)
    got = tapi.default_select("k", arr)
    assert got == japi.default_select("k", arr)
    assert (got[0] if got else None) == want
    t = torch.zeros(size, dtype=getattr(torch, dtype))
    assert tapi.default_select("k", t) == got


# ---------------------------------------------------------------------------
# executor lifecycle: shutdown, drain, lane metrics, chaining, priorities
# ---------------------------------------------------------------------------


def test_executor_shutdown_idempotent_and_submit_after_close():
    ex = DeviceExecutor(CPU)
    assert ex.submit(lambda: 41 + 1).result() == 42
    ex.shutdown()
    assert ex.closed
    ex.shutdown()
    ex.shutdown(wait=False)
    with pytest.raises(RuntimeError, match="shut down"):
        ex.submit(lambda: 0)
    with pytest.raises(RuntimeError, match="shut down"):
        ex.submit(lambda: 0, lane="io")


def test_executor_shutdown_safe_under_concurrent_submit():
    ex = DeviceExecutor(CPU)
    stop = threading.Event()
    outcomes = {"ok": 0, "refused": 0, "other": []}

    def spammer():
        while not stop.is_set():
            try:
                ex.submit(lambda: 1).result()
                outcomes["ok"] += 1
            except RuntimeError as e:
                if "shut down" in str(e):
                    outcomes["refused"] += 1
                    return
                outcomes["other"].append(e)
                return

    threads = [threading.Thread(target=spammer) for _ in range(4)]
    for t in threads:
        t.start()
    time.sleep(0.05)
    ex.shutdown()
    stop.set()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads)
    assert not outcomes["other"]
    st = ex.lane_stats()
    assert sum(v["submitted"] for v in st.values()) == sum(v["completed"] for v in st.values())


def test_executor_drain_and_lane_stats():
    ex = DeviceExecutor(CPU)
    gate = threading.Event()
    subs = [ex.submit(gate.wait, 30) for _ in range(3)]
    subs.append(ex.submit(gate.wait, 30, lane="io"))
    assert not ex.drain(timeout=0.1)
    st = ex.lane_stats()
    assert st["compute"]["submitted"] == 3 and st["io"]["submitted"] == 1
    assert st["compute"]["depth"] + st["compute"]["inflight"] > 0
    gate.set()
    assert ex.drain(timeout=30)
    for s in subs:
        s.result()
    st = ex.lane_stats()
    for lane in ("compute", "io"):
        assert st[lane]["completed"] == st[lane]["submitted"]
        assert st[lane]["depth"] == 0 and st[lane]["inflight"] == 0
        assert st[lane]["wait_s"] >= 0.0
    t0 = time.monotonic()
    assert ex.drain(timeout=5)
    assert time.monotonic() - t0 < 1.0
    assert subs[0].device == torch.device("cpu") and subs[-1].device is None
    ex.shutdown()


def test_executor_submit_after_propagates_upstream_failure():
    ex = DeviceExecutor(CPU)

    def boom():
        raise ValueError("upstream boom")

    chained = ex.submit_after(ex.submit(boom), lambda r: r + 1)
    with pytest.raises(ValueError, match="upstream boom"):
        chained.result(timeout=30)
    assert ex.submit_after(ex.submit(lambda: 2), lambda r: r + 3).result(timeout=30) == 5
    ex.shutdown()


def test_executor_done_callback_fires_with_submission():
    ex = DeviceExecutor(CPU)
    seen, done = [], threading.Event()
    sub = ex.submit(lambda: "payload")

    def cb(s):
        seen.append(s.result())
        done.set()

    sub.add_done_callback(cb)
    assert done.wait(30)
    assert seen == ["payload"]
    ex.shutdown()


def test_executor_drain_waits_for_completion_callbacks():
    ex = DeviceExecutor(CPU)
    rounds = 25
    for _ in range(rounds):
        gate = threading.Event()
        hits = []
        first = ex.submit(gate.wait, 30)
        chained = ex.submit_after(
            first, lambda _r: (time.sleep(0.002), hits.append("io"))[-1], lane="io")
        gate.set()
        assert ex.drain(timeout=30)
        assert hits == ["io"]
        assert chained.done()
    st = ex.lane_stats()
    assert st["io"]["submitted"] == st["io"]["completed"] == rounds
    assert st["compute"]["completed"] == st["compute"]["submitted"]
    flags = []
    sub = ex.submit(lambda: 41 + 1)
    sub.add_done_callback(lambda s: (time.sleep(0.01), flags.append(s.result())))
    assert ex.drain(timeout=30)
    assert flags == [42]
    ex.shutdown()


def test_executor_priority_stats_tagged_lanes():
    # four compute threads: three gated tasks leave one for the untagged task
    ex = DeviceExecutor(CPU, max_workers=4)
    gate = threading.Event()
    subs = [ex.submit(gate.wait, 30, priority="bulk") for _ in range(3)]
    subs.append(ex.submit(gate.wait, 30, lane="io", priority="interactive"))
    ex.submit(lambda: 0).result()
    st = ex.priority_stats()
    assert st["bulk"]["submitted"] == 3 and st["interactive"]["submitted"] == 1
    assert set(st) == {"bulk", "interactive"}
    gate.set()
    assert ex.drain(timeout=30)
    st = ex.priority_stats()
    for cls in ("bulk", "interactive"):
        assert st[cls]["completed"] == st[cls]["submitted"]
        assert st[cls]["depth"] == 0 and st[cls]["inflight"] == 0
        assert st[cls]["wait_s"] >= 0.0
    ex.shutdown()


def test_executor_round_robins_and_counts_mesh_tasks():
    from repro_torch.runtime.executor import MESH

    ex = DeviceExecutor([torch.device("cpu"), torch.device("cpu", 0)])
    subs = [ex.submit(lambda: 1, device=MESH) for _ in range(3)] + [ex.submit(lambda: 2)]
    assert [s.result() for s in subs] == [1, 1, 1, 2]
    assert ex.stats() == {"devices": 2, "submitted": 4, "completed": 4, "mesh_submitted": 3}
    assert [s.device for s in subs] == [ex.devices[i % 2] for i in range(4)]
    ex.shutdown()


# ---------------------------------------------------------------------------
# what running kernels from several threads and cards needs of the port
# ---------------------------------------------------------------------------


def test_launch_counters_count_every_thread():
    """Engine tasks launch kernels from several threads at once, and the
    launch counts the card's checks read must take every launch."""
    import os
    import sys

    from repro_torch.kernels import _launch

    launches = {"k": 0}
    per_thread, threads = 5_000, 2 * (os.cpu_count() or 4)

    def hammer():
        for _ in range(per_thread):
            _launch.count_launch(launches, "k")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=hammer) for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(w.is_alive() for w in workers)
    assert launches["k"] == per_thread * threads


def test_cuda_plans_are_keyed_by_device(monkeypatch):
    """A ``cuda`` plan holds its tables on the current card, so the CMM key
    names that card (an engine placing buckets on two cards gets a plan on
    each); ``torch`` keys are unchanged."""
    from repro_torch.core.codecs.base import ReductionSpec

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    spec = ReductionSpec.create("zfp", (8, 8), "float32", backend="cuda", rate=8)
    keys = []
    for index in (0, 1):
        monkeypatch.setattr(torch.cuda, "current_device", lambda i=index: i)
        keys.append(spec.key())
    assert keys[0] != keys[1]
    cpu = ReductionSpec.create("zfp", (8, 8), "float32", backend="torch", rate=8)
    assert cpu.key() == ("zfp", (8, 8), "float32", (("backend", "torch"), ("rate", 8)))


def test_run_on_the_cpu_runs_in_place():
    from repro_torch.runtime.executor import run_on

    assert run_on(torch.device("cpu"), lambda a, b=0: a + b, 2, b=3) == 5
    assert run_on(None, lambda: "x") == "x"
