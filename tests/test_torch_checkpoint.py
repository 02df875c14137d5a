"""The port's checkpoint manager, ``fs_barrier`` and ``runtime/fault.py``
against the reference (``repro.checkpoint``, ``repro.launch.mesh``,
``repro.runtime.fault``) on the CPU: the port on a CPU engine
(``backend="torch"``), the reference on its default backend.

A checkpoint written by either package restores in the other, for the
default policy (one-shot ZFP leaves, a leaf streamed through the auto-tuned
``CompressorStream``, lossless small leaves), the ``exact`` policy and the
``mgard-progressive`` policy, whose ``restore(max_error=)`` reads the same
component prefix in both packages.  With the tuner's plans pinned (both
calibration stores seeded alike) every leaf's segment bytes are identical,
except MGARD's, which are held to their bound.  Multi-host saves run one
manager per simulated host in threads.  The plain Huffman decode costs
~0.5 s a leaf on the CPU, so the trees stay small.
"""

import json
import os
import signal
import threading

import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JManager
from repro.checkpoint import CheckpointPolicy as JPolicy
from repro.core import chunk_model as jcm
from repro.launch.mesh import HostTopology as JTopology
from repro.runtime import calibrate as jcal
from repro.runtime import fault as jfault
from repro.runtime.io import AggregatedReader
from repro_torch.checkpoint import CheckpointManager, CheckpointPolicy
from repro_torch.core import chunk_model as tcm
from repro_torch.core.container import ContainerError
from repro_torch.core.engine import ExecutionEngine
from repro_torch.launch.mesh import HostTopology, barrier_payloads, fs_barrier
from repro_torch.runtime import calibrate as tcal
from repro_torch.runtime import fault as tfault
from repro_torch.runtime.io import shard_file_name

# "w" streams (120 KiB >= the threshold), "v" is a one-shot ZFP leaf
# (16384 elements), the rest restore bit-exact through huffman-bytes
STREAM_THRESHOLD = 96 << 10
POLICIES = {
    "default": dict(stream_threshold=STREAM_THRESHOLD),
    "exact": dict(exact=True),
    "progressive": dict(float_method="mgard-progressive", mgard_eb=1e-3, lossless_small=4096,
                        progressive_tiers=2),
}


def _tree(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    w = lambda *s: rng.normal(0.0, 0.02, s).astype(np.float32)  # noqa: E731
    return {
        "w": w(192, 160),
        "v": w(128, 128),
        "layers": [{"bias": w(64)}],
        "step": np.int32(7),
    }


@pytest.fixture(scope="module")
def engine():
    with ExecutionEngine(devices=[torch.device("cpu")], backend="torch") as eng:
        yield eng


@pytest.fixture
def pinned_plans(tmp_path):
    """Both calibration stores seeded with one synthetic ZFP calibration:
    ``chunk_size="auto"`` then resolves to the same chunking in both."""
    tcal.set_calibration_dir(tmp_path / "cal")
    jcal.set_calibration_dir(tmp_path / "cal")
    for cm, cal, backend in ((tcm, tcal, "torch"), (jcm, jcal, None)):
        store = cal.load_store(backend)
        store.methods[cal.method_key("zfp", "float32")] = cal.MethodCalibration(
            method="zfp", dtype="float32",
            phi=cm.PhiModel(alpha=2e9 / (1 << 20), beta0=1e8, gamma=2e9, c_threshold=1 << 20),
            h2d=cm.AffineCost(t0=1e-5, bps=5e9), serialize=cm.AffineCost(t0=2e-5, bps=3e9),
            output_fraction=0.9)
        store.window_overhead_s = 1e-5
    yield
    tcal.set_calibration_dir(None)
    jcal.set_calibration_dir(None)


def _segments(step_dir) -> dict[str, bytes]:
    files = sorted(p for p in step_dir.glob("*.hpdr"))
    out = {}
    for f in files:
        with AggregatedReader(f) as r:
            out.update({n: r.read(n) for n in r.names()})
    return out


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# cross-restore between the packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_checkpoints_cross_restore(tmp_path, engine, pinned_plans, policy):
    tree = _tree()
    kw = POLICIES[policy]
    port = CheckpointManager(tmp_path / "port", CheckpointPolicy(**kw), engine=engine)
    ref = JManager(tmp_path / "ref", JPolicy(**kw))
    pm, rm = port.save(3, tree, extra={"lr": 0.1}), ref.save(3, tree, extra={"lr": 0.1})
    assert pm["extra"] == {"lr": 0.1} and pm["aggregate"] == "leaves.hpdr"
    assert sorted(pm["leaves"]) == sorted(rm["leaves"]) == ["layers::0::bias", "step", "v", "w"]
    for key, entry in pm["leaves"].items():
        other = rm["leaves"][key]
        assert {k: v for k, v in entry.items() if k not in ("bytes", "progressive")} == \
            {k: v for k, v in other.items() if k not in ("bytes", "progressive")}, key
    if policy == "default":
        assert pm["leaves"]["w"]["stream"] and pm["leaves"]["w"]["tuned"]["source"] == "calibrated"
        assert "stream" not in pm["leaves"]["v"]

    # pinned plans: the same segment bytes (MGARD: the same segments)
    ours, theirs = _segments(tmp_path / "port" / "step_00000003"), \
        _segments(tmp_path / "ref" / "step_00000003")
    assert sorted(ours) == sorted(theirs)
    for name in ours:
        if policy != "progressive" or "~p" not in name:
            assert ours[name] == theirs[name], name

    # each package restores the other's checkpoint: the same values (ZFP
    # decodes bit for bit in both), exact leaves equal to the tree's
    t_of_r, _ = CheckpointManager(tmp_path / "ref", engine=engine).restore(3)
    r_of_t, _ = JManager(tmp_path / "port").restore(3)
    assert sorted(t_of_r) == sorted(r_of_t) == sorted(pm["leaves"])
    src = {"w": tree["w"], "v": tree["v"], "step": tree["step"],
           "layers::0::bias": tree["layers"][0]["bias"]}
    for key, x in src.items():
        a, b = _np(t_of_r[key]), _np(r_of_t[key])
        assert a.dtype == b.dtype == x.dtype and a.shape == b.shape == x.shape, key
        if policy == "progressive" and key in ("v", "w"):
            bound = pm["leaves"][key]["progressive"]["tier_bounds"][-1] * 1.0001
            assert np.abs(a - x).max() <= bound and np.abs(b - x).max() <= bound, key
        else:
            np.testing.assert_array_equal(a, b, err_msg=key)
        if policy == "exact" or key in ("step", "layers::0::bias"):
            np.testing.assert_array_equal(a, x, err_msg=key)


def test_lossless_leaf_past_one_huffman_stream_goes_in_chunks(tmp_path, engine, monkeypatch):
    """A lossless leaf larger than ``LOSSLESS_CHUNK_BYTES`` (128 MiB in use,
    a size whose Huffman codes fill at most half of the format's 2^31 - 1
    bits; 16 KiB here) goes through the stream in fixed chunks of that many
    bytes, each its own ``huffman-bytes`` container; both packages restore
    it bit for bit."""
    from repro_torch.checkpoint import manager
    from repro_torch.core import api

    monkeypatch.setattr(manager, "LOSSLESS_CHUNK_BYTES", 16 << 10)
    tree = _tree()
    pm = CheckpointManager(tmp_path / "port", CheckpointPolicy(exact=True),
                           engine=engine).save(3, tree)
    for key in ("w", "v"):  # 120 KiB and 64 KiB
        assert pm["leaves"][key]["stream"] and "tuned" not in pm["leaves"][key], key
    assert "stream" not in pm["leaves"]["layers::0::bias"] and "stream" not in pm["leaves"]["step"]
    with AggregatedReader(tmp_path / "port" / "step_00000003" / "leaves.hpdr") as r:
        chunks = api.CompressorStream.from_bytes(r.read(pm["leaves"]["w"]["segment"])).chunks
    assert len(chunks) == 8 and all(c.method == "huffman-bytes" for c in chunks)
    assert all(int(np.prod(c.meta["shape"])) * 4 <= 2 * (16 << 10) for c in chunks)
    ours, _ = CheckpointManager(tmp_path / "port", engine=engine).restore(3)
    theirs, _ = JManager(tmp_path / "port").restore(3)
    src = {"w": tree["w"], "v": tree["v"], "step": tree["step"],
           "layers::0::bias": tree["layers"][0]["bias"]}
    for key, x in src.items():
        np.testing.assert_array_equal(_np(ours[key]), x, err_msg=key)
        np.testing.assert_array_equal(np.asarray(theirs[key]), x, err_msg=key)


def test_progressive_max_error_reads_the_same_prefix(tmp_path, engine):
    """``restore(max_error=<tier-2 bound>)`` of a 3-tier leaf reads the first
    two components, in either package, of either package's checkpoint."""
    tree = {"w": _tree()["w"][:64, :80].copy()}
    kw = dict(POLICIES["progressive"], progressive_tiers=3)
    written = {
        "port": CheckpointManager(tmp_path / "port", CheckpointPolicy(**kw),
                                  engine=engine).save(1, tree),
        "ref": JManager(tmp_path / "ref", JPolicy(**kw)).save(1, tree),
    }
    entries = {k: m["leaves"]["w"] for k, m in written.items()}
    assert [len(e["segments"]) for e in entries.values()] == [3, 3]
    for writer, mgr in (("port", JManager(tmp_path / "port")),
                        ("ref", CheckpointManager(tmp_path / "ref", engine=engine))):
        bounds = entries[writer]["progressive"]["tier_bounds"]
        comps = entries[writer]["progressive"]["component_nbytes"]
        coarse, _ = mgr.restore(1, max_error=bounds[1])
        io = mgr.last_restore_io
        assert io["local_preads"] == 2, writer
        assert io["local_bytes"] == comps[0] + comps[1] < entries[writer]["bytes"], writer
        assert np.abs(_np(coarse["w"]) - tree["w"]).max() <= bounds[1] * 1.0001, writer


# ---------------------------------------------------------------------------
# the manager's own behaviour, as in the reference
# ---------------------------------------------------------------------------


def test_restore_with_target_dtypes_and_devices(tmp_path, engine):
    tree = _tree()
    mgr = CheckpointManager(tmp_path, CheckpointPolicy(exact=True), engine=engine)
    mgr.save(1, tree)
    like = dict(tree, v=torch.zeros(128, 128, dtype=torch.float64))
    places = {"w": torch.device("cpu"), "v": "cpu", "layers": [{"bias": "cpu"}], "step": "cpu"}
    out, manifest = mgr.restore(1, target=like, shardings=places)
    assert manifest["step"] == 1 and set(out) == set(tree)
    assert out["v"].dtype == torch.float64 and out["step"].dtype == torch.int32
    assert isinstance(out["layers"], list) and out["layers"][0]["bias"].shape == (64,)
    np.testing.assert_array_equal(out["w"].numpy(), tree["w"])
    np.testing.assert_array_equal(out["v"].numpy(), tree["v"].astype(np.float64))
    with pytest.raises(ValueError, match="incompatible"):
        mgr.restore(1, target=tree, leaves=["w"])


def test_partial_restore_preads_only_selected_leaves(tmp_path, engine):
    mgr = CheckpointManager(tmp_path, CheckpointPolicy(exact=True), engine=engine)
    tree = _tree()
    manifest = mgr.save(2, tree)
    assert [p.name for p in (tmp_path / "step_00000002").glob("*.hpdr")] == ["leaves.hpdr"]
    assert manifest["io"]["segments"] == len(manifest["leaves"])
    flat, _ = mgr.restore(2, leaves={"step"})
    assert set(flat) == {"step"} and int(flat["step"]) == 7
    assert mgr.last_restore_io["local_preads"] == 1
    assert mgr.last_restore_io["local_bytes"] == manifest["leaves"]["step"]["bytes"]


def test_async_saves_chain_and_latest_step_ignores_torn(tmp_path, engine):
    mgr = CheckpointManager(tmp_path, CheckpointPolicy(exact=True), engine=engine)
    tree = {"w": torch.from_numpy(_tree()["v"]), "n": np.int64(3)}
    first = mgr.save_async(10, tree)
    second = mgr.save_async(11, tree)      # chained on the first, not waited on
    tree["w"].add_(1.0)                    # the snapshot is what gets saved
    assert mgr.wait()["step"] == 11 and first.result()["step"] == 10
    assert second.done() and mgr.wait() is None
    torn = tmp_path / "step_00000099"
    torn.mkdir()
    (torn / "manifest.json").write_text("{}")
    assert mgr.latest_step() == 11
    flat, _ = mgr.restore()
    np.testing.assert_array_equal(flat["w"].numpy(), _tree()["v"])
    assert flat["n"].dtype == torch.int64   # exact leaves keep their dtype


def test_failed_async_save_fails_the_chained_one(tmp_path, engine):
    mgr = CheckpointManager(tmp_path, CheckpointPolicy(float_method="zfp", zfp_rate=99,
                                                       lossless_small=1), engine=engine)
    mgr.save_async(1, {"w": np.ones((8, 8), np.float32)})
    mgr.save_async(2, {"w": np.ones((8, 8), np.float32)})
    with pytest.raises(ValueError):
        mgr.wait()
    assert mgr.latest_step() is None


def test_restore_reads_pre_aggregation_layout(tmp_path, engine):
    from repro.core import api as japi

    step_dir = tmp_path / "step_00000004"
    step_dir.mkdir(parents=True)
    arr = np.random.default_rng(1).normal(size=(8, 8)).astype(np.float32)
    blob = japi.compress_leaf(arr, "huffman-bytes").to_bytes()
    (step_dir / "w.hpdr").write_bytes(blob)
    (step_dir / "manifest.json").write_text(json.dumps(
        {"step": 4, "extra": {}, "leaves": {"w": {"file": "w.hpdr", "bytes": len(blob),
                                                  "raw": arr.nbytes}}}))
    (step_dir / "COMMITTED").write_text("ok")
    flat, _ = CheckpointManager(tmp_path, engine=engine).restore(4)
    np.testing.assert_array_equal(flat["w"].numpy(), arr)


def test_manager_needs_a_card_unless_torch(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour where no CUDA card is present")
    with pytest.raises(ValueError, match="CUDA"):
        CheckpointManager(tmp_path / "a").save(1, {"x": np.zeros(4, np.float32)})
    mgr = CheckpointManager(tmp_path / "b", CheckpointPolicy(exact=True), backend="torch")
    try:
        assert mgr.backend == "torch"
        mgr.save(1, {"x": np.arange(4, dtype=np.float32)})
        np.testing.assert_array_equal(mgr.restore(1)[0]["x"].numpy(), np.arange(4))
    finally:
        mgr.close()
    assert mgr._engine is None


# ---------------------------------------------------------------------------
# multi-host saves (threads, one manager per simulated host)
# ---------------------------------------------------------------------------


def _multi_tree() -> dict:
    rng = np.random.default_rng(0)
    return {"layers": {f"w{i}": rng.normal(size=(32, 16 + i)).astype(np.float32)
                       for i in range(6)},
            "bias": rng.normal(size=(64,)).astype(np.float32), "step": np.int32(11)}


def _threaded_save(make, directory, tree, n_hosts):
    mgrs = [make(directory, h, n_hosts) for h in range(n_hosts)]
    manifests, errs = [None] * n_hosts, []

    def run(h):
        try:
            manifests[h] = mgrs[h].save(1, tree)
        except Exception as e:  # surfaced by the assertion below
            errs.append(e)

    threads = [threading.Thread(target=run, args=(h,)) for h in range(n_hosts)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert not errs, errs
    return mgrs, manifests


def test_fs_barrier_rendezvous_payloads_and_timeout(tmp_path):
    topo = [HostTopology(h, 3) for h in range(3)]
    threads = [threading.Thread(target=fs_barrier, args=(tmp_path, "b", t),
                                kwargs={"payload": f"host{t.host_id}"}) for t in topo]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert barrier_payloads(tmp_path, "b", topo[0]) == {h: f"host{h}" for h in range(3)}
    # the reference's marker names: its reader sees the port's payloads
    from repro.launch.mesh import barrier_payloads as jpayloads

    assert jpayloads(tmp_path, "b", JTopology(0, 3)) == {h: f"host{h}" for h in range(3)}
    with pytest.raises(TimeoutError, match="1/2 hosts"):
        fs_barrier(tmp_path, "lonely", HostTopology(0, 2), timeout=0.05)


def test_multihost_save_global_manifest_and_cross_restore(tmp_path, engine):
    tree = _multi_tree()
    make = lambda d, h, n: CheckpointManager(  # noqa: E731
        d, CheckpointPolicy(exact=True), engine=engine, topology=HostTopology(h, n))
    mgrs, manifests = _threaded_save(make, tmp_path / "port", tree, 2)
    m = manifests[0]
    assert manifests[1] == m
    assert m["shards"] == {"0": shard_file_name(0), "1": shard_file_name(1)}
    assert m["topology"] == {"hosts": 2} and m["stitched_segments"] == len(m["leaves"])
    assert {e["shard"] for e in m["leaves"].values()} == {"0", "1"}
    # the reference's multi-host save assigns every leaf to the same shard
    jmake = lambda d, h, n: JManager(d, JPolicy(exact=True),  # noqa: E731
                                     topology=JTopology(h, n))
    _, jmanifests = _threaded_save(jmake, tmp_path / "ref", tree, 2)
    assert {k: e["shard"] for k, e in jmanifests[0]["leaves"].items()} == \
        {k: e["shard"] for k, e in m["leaves"].items()}
    assert _segments(tmp_path / "port" / "step_00000001") == \
        _segments(tmp_path / "ref" / "step_00000001")
    # same-topology restore reads only the local shard; the reference
    # restores the port's checkpoint from one process
    for h, mgr in enumerate(mgrs):
        flat, _ = mgr.restore(1, leaves="local")
        assert mgr.last_restore_io["shards_opened"] == [str(h)]
        assert mgr.last_restore_io["cross_preads"] == 0
        for k, x in flat.items():
            want = tree["step"] if k == "step" else \
                tree["bias"] if k == "bias" else tree["layers"][k.split("::")[1]]
            np.testing.assert_array_equal(x.numpy(), want)
    r_flat, _ = JManager(tmp_path / "port", JPolicy(exact=True),
                         topology=JTopology(0, 1)).restore(1)
    np.testing.assert_array_equal(np.asarray(r_flat["layers::w3"]), tree["layers"]["w3"])


def test_multihost_torn_shard_raises_naming_it(tmp_path, engine):
    make = lambda d, h, n: CheckpointManager(  # noqa: E731
        d, CheckpointPolicy(exact=True), engine=engine, topology=HostTopology(h, n))
    mgrs, manifests = _threaded_save(make, tmp_path, _multi_tree(), 2)
    shard1 = tmp_path / "step_00000001" / shard_file_name(1)
    shard1.write_bytes(shard1.read_bytes()[:16])
    with pytest.raises(ContainerError, match="leaves-0001"):
        mgrs[0].restore(1)
    healthy = [k for k, e in manifests[0]["leaves"].items() if e["shard"] == "0"]
    flat, _ = mgrs[0].restore(1, leaves=healthy)
    assert sorted(flat) == sorted(healthy)
    assert mgrs[0].last_restore_io["shards_opened"] == ["0"]


# ---------------------------------------------------------------------------
# runtime/fault.py: the reference's decisions on the same inputs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("times", [
    [1.0] * 20 + [5.0, 1.1, 2.5, 1.0],
    list(np.random.default_rng(3).lognormal(0.0, 0.6, 60)),
    [0.5] * 5 + [9.0] * 5 + [0.5, 9.0, 30.0],
])
def test_straggler_watchdog_decides_like_reference(times):
    ours, theirs = tfault.StragglerWatchdog(threshold=2.0), jfault.StragglerWatchdog(threshold=2.0)
    assert [ours.observe(t) for t in times] == [theirs.observe(t) for t in times]
    assert ours.flagged == theirs.flagged


@pytest.mark.parametrize("bad", [None, float("nan"), float("inf"), -float("inf")])
def test_skip_nonfinite_update_decides_like_reference(bad):
    import jax.numpy as jnp

    rng = np.random.default_rng(4)
    old = {"w": rng.normal(size=(4, 3)).astype(np.float32), "b": [np.ones(3, np.float32)]}
    new = {"w": old["w"] + 1, "b": [np.zeros(3, np.float32)]}
    grads = {"w": rng.normal(size=(4, 3)).astype(np.float32), "b": [np.ones(3, np.float32)]}
    if bad is not None:
        grads["b"][0][1] = bad
    tt = lambda t: {"w": torch.from_numpy(t["w"]), "b": [torch.from_numpy(t["b"][0])]}  # noqa
    jj = lambda t: {"w": jnp.asarray(t["w"]), "b": [jnp.asarray(t["b"][0])]}  # noqa
    picked, finite = tfault.skip_nonfinite_update(tt(new), tt(old), tt(grads))
    jpicked, jfinite = jfault.skip_nonfinite_update(jj(new), jj(old), jj(grads))
    assert bool(finite) == bool(jfinite) == (bad is None)
    np.testing.assert_array_equal(picked["w"].numpy(), np.asarray(jpicked["w"]))
    np.testing.assert_array_equal(picked["b"][0].numpy(), np.asarray(jpicked["b"][0]))


def test_preemption_handler_saves_then_exits():
    saved = []
    previous = signal.getsignal(signal.SIGTERM)
    try:
        tfault.install_preemption_handler(lambda: saved.append(True))
        with pytest.raises(SystemExit) as exc:
            os.kill(os.getpid(), signal.SIGTERM)
        assert exc.value.code == 143 and saved == [True]
    finally:
        signal.signal(signal.SIGTERM, previous)
