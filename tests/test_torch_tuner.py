"""The port's cost model, tuner and calibration against the reference
(``repro.core.chunk_model``, ``repro.core.pipeline``'s simulator,
``repro.runtime.roofline``'s stream half, ``repro.core.tuner`` and
``repro.runtime.calibrate``), on the CPU.

The fits, schedules, the timeline simulator and the tuner's decisions are
numpy arithmetic in both packages: on the same inputs they must agree
exactly (``==``, no tolerance).  ``plan_stream`` runs from a seeded
calibration store with ``measure=False`` in both packages, and the race is
driven with the same fake walls.  Calibration runs with a stub clock (every
call advances 1 ms), so no test compares wall times.
"""

import json

import numpy as np
import pytest

from repro.core import chunk_model as jcm
from repro.core import pipeline as jpl
from repro.core import tuner as jtuner
from repro.runtime import calibrate as jcal
from repro.runtime import roofline as jroof
from repro_torch.core import api as tapi
from repro_torch.core import chunk_model as tcm
from repro_torch.core import pipeline as tpl
from repro_torch.core import tuner as ttuner
from repro_torch.runtime import calibrate as tcal
from repro_torch.runtime import roofline as troof

PROFILES = [
    ([4096.0], [1e9]),                                        # one point
    ([4096.0, 16384.0], [1e8, 4e8]),                          # a line
    ([4e3, 1.6e4, 6.4e4, 2.56e5], [5e8, 5e8, 5e8, 5e8]),      # saturated
    ([4e3, 1.6e4, 6.4e4, 2.56e5], [1e7, 4e7, 1.6e8, 6.4e8]),  # still rising
    ([4e3, 1.6e4, 6.4e4, 2.56e5], [2e8, 9e8, 7e8, 1e9]),      # noisy
    ([2.56e5, 4e3, 6.4e4, 1.6e4], [1.1e9, 3e7, 8e8, 1e8]),    # unsorted, knee
]
AFFINE = [
    ([4096.0], [1e-5]),
    ([4e3, 1.6e4, 6.4e4], [1e-5 + 4e3 / 5e9, 1e-5 + 1.6e4 / 5e9, 1e-5 + 6.4e4 / 5e9]),
    ([4e3, 1.6e4, 6.4e4], [3e-5, 2e-5, 1e-5]),                # negative slope
    ([4e3, 4e3], [1e-5, 2e-5]),                               # one size
]


@pytest.fixture
def cal_dirs(tmp_path):
    """Both packages' calibration stores in one directory (their machine
    keys differ, so their files do too)."""
    tcal.set_calibration_dir(tmp_path)
    jcal.set_calibration_dir(tmp_path)
    yield tmp_path
    tcal.set_calibration_dir(None)
    jcal.set_calibration_dir(None)


def _synthetic(cm, cal, method="zfp", dtype="float32", gamma=2e9):
    phi = cm.PhiModel(alpha=gamma / (1 << 20), beta0=gamma * 0.05,
                      gamma=gamma, c_threshold=1 << 20)
    return cal.MethodCalibration(
        method=method, dtype=dtype, phi=phi,
        h2d=cm.AffineCost(t0=1e-5, bps=5e9),
        serialize=cm.AffineCost(t0=2e-5, bps=3e9),
        output_fraction=0.5, stream_t0=3e-4, chunk_t0=2e-5,
        serial_scale=1.1, overlap_scale=1.3,
    )


def _seed(cm, cal, method="zfp", backend=None):
    store = cal.load_store(backend)
    store.methods[cal.method_key(method, "float32")] = _synthetic(cm, cal, method)
    store.window_overhead_s = 1e-5
    store.host_frame_bps = 1e9


class _StubClock:
    """Deterministic monotone clock: every call advances 1 ms."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1e-3
        return self.t


# ---------------------------------------------------------------------------
# the cost model: exact equality with the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sizes,bps", PROFILES)
def test_fit_phi_equals_reference(sizes, bps):
    assert tcm.fit_phi(np.array(sizes), np.array(bps)).__dict__ == \
        jcm.fit_phi(np.array(sizes), np.array(bps)).__dict__


@pytest.mark.parametrize("sizes,times", AFFINE)
def test_fit_affine_equals_reference(sizes, times):
    assert tcm.fit_affine(np.array(sizes), np.array(times)).__dict__ == \
        jcm.fit_affine(np.array(sizes), np.array(times)).__dict__


def test_fit_errors_match_reference():
    for args in ((np.array([]), np.array([])), (np.array([1.0]), np.array([-1.0]))):
        for mod in (jcm, tcm):
            with pytest.raises(ValueError):
                mod.fit_phi(*args)
            with pytest.raises(ValueError):
                mod.fit_affine(*args)


@pytest.mark.parametrize("total,c_init,c_limit", [
    (0, 16, 64), (1000, 16, 64), (10 << 20, 1 << 16, 1 << 22), (12345678, 1 << 12, 1 << 24)])
def test_schedules_equal_reference(total, c_init, c_limit):
    jphi = jcm.fit_phi(np.array(PROFILES[5][0]), np.array(PROFILES[5][1]))
    tphi = tcm.fit_phi(np.array(PROFILES[5][0]), np.array(PROFILES[5][1]))
    assert tcm.adaptive_chunk_schedule(total, c_init, c_limit, tphi, tcm.ThetaModel(2e-10)) \
        == jcm.adaptive_chunk_schedule(total, c_init, c_limit, jphi, jcm.ThetaModel(2e-10))
    assert tcm.fixed_chunk_schedule(total, c_init * 3) == jcm.fixed_chunk_schedule(total, c_init * 3)


# ---------------------------------------------------------------------------
# the timeline simulator and the stream model
# ---------------------------------------------------------------------------


def _sched(s: dict) -> dict:
    return {k: (v.resource, v.start, v.end) for k, v in s.items()}


@pytest.mark.parametrize("window", [None, 0, 1, 2, 3])
def test_reduction_dag_schedule_equals_reference(window):
    sizes = [1 << 20, 3 << 19, 1 << 18, 5 << 17, 1 << 20]
    args = (sizes, lambda c: c / 5e9, lambda c: 1e-5 + c / 2e9,
            lambda c: c / 7e9, lambda c: c / 3e10)
    tsch = tpl.TimelineSimulator().run(tpl.build_reduction_dag(*args, window=window))
    jsch = jpl.TimelineSimulator().run(jpl.build_reduction_dag(*args, window=window))
    assert _sched(tsch) == _sched(jsch)
    assert tpl.TimelineSimulator.makespan(tsch) == jpl.TimelineSimulator.makespan(jsch)
    assert tpl.TimelineSimulator.overlap_ratio(tsch) == jpl.TimelineSimulator.overlap_ratio(jsch)


@pytest.mark.parametrize("invert", [True, False])
def test_reconstruction_dag_schedule_equals_reference(invert):
    sizes = [1 << 20] * 5
    args = (sizes, lambda c: c / 5e9, lambda c: c / 2e9, lambda c: c / 7e9, lambda c: c / 3e10)
    tsch = tpl.TimelineSimulator().run(
        tpl.build_reconstruction_dag(*args, invert_launch_order=invert))
    jsch = jpl.TimelineSimulator().run(
        jpl.build_reconstruction_dag(*args, invert_launch_order=invert))
    assert _sched(tsch) == _sched(jsch)


@pytest.mark.parametrize("mode,recon", [("none", False), ("fixed", False),
                                        ("adaptive", False), ("adaptive", True)])
def test_simulate_pipeline_equals_reference(mode, recon):
    prof = PROFILES[5]
    tr = tpl.simulate_pipeline(3 << 28, mode, tcm.fit_phi(*map(np.array, prof)), 2.5e10, 2.2e10,
                               reconstruction=recon)
    jr = jpl.simulate_pipeline(3 << 28, mode, jcm.fit_phi(*map(np.array, prof)), 2.5e10, 2.2e10,
                               reconstruction=recon)
    assert (tr.makespan, tr.overlap_ratio, tr.sustained_bps, tr.chunk_sizes) == \
        (jr.makespan, jr.overlap_ratio, jr.sustained_bps, jr.chunk_sizes)


@pytest.mark.parametrize("window,overhead", [(1, 0.0), (2, 0.0), (3, 1e-4), (2, 10.0)])
def test_simulate_stream_equals_reference(window, overhead):
    sizes = [1 << 22] * 7 + [12345]
    fns = (lambda c: 1e-5 + c / 2.4e10, lambda c: 2e-5 + c / 1e11, lambda c: 3e-5 + c / 1.9e10)
    tmk, tsch = troof.simulate_stream(sizes, *fns, window=window, window_overhead_s=overhead)
    jmk, jsch = jroof.simulate_stream(sizes, *fns, window=window, window_overhead_s=overhead)
    assert tmk == jmk and _sched(tsch) == _sched(jsch)
    assert troof.stream_lane_seconds(sizes, *fns) == jroof.stream_lane_seconds(sizes, *fns)
    if window == 1:  # the serial schedule is the lane sum
        assert tmk == pytest.approx(sum(troof.stream_lane_seconds(sizes, *fns).values()))


# ---------------------------------------------------------------------------
# the tuner's decisions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("total,chunk,overhead", [
    (1024, None, 0.0), (1 << 20, None, 0.0), (1 << 22, None, 1e-5), (1 << 22, None, 10.0),
    (3_000_000, 1 << 16, 0.0), (1 << 27, None, 2e-4)])
def test_plan_stream_injected_calibration_equals_reference(total, chunk, overhead):
    tplan = ttuner.plan_stream(total, 4, method="zfp", calibration=_synthetic(tcm, tcal),
                               chunk_elems=chunk, window_overhead_s=overhead)
    jplan = jtuner.plan_stream(total, 4, method="zfp", calibration=_synthetic(jcm, jcal),
                               chunk_elems=chunk, window_overhead_s=overhead)
    assert tplan.to_dict() == jplan.to_dict()
    assert tplan.source == "calibrated"


@pytest.mark.parametrize("total,chunk,window", [(256, None, 2), (1 << 20, None, 3),
                                                (1 << 20, 1 << 19, 2), (7, 3, 2)])
def test_heuristic_plan_equals_reference(total, chunk, window):
    assert ttuner.heuristic_plan(total, 4, chunk_elems=chunk, default_window=window).to_dict() \
        == jtuner.heuristic_plan(total, 4, chunk_elems=chunk, default_window=window).to_dict()


@pytest.mark.parametrize("total", [1 << 14, 1 << 20, 3 << 22])
def test_plan_stream_seeded_store_equals_reference(cal_dirs, total):
    _seed(tcm, tcal, backend="torch")
    _seed(jcm, jcal)
    tplan = ttuner.plan_stream(total, 4, method="zfp", dtype="float32", backend="torch",
                               measure=False)
    jplan = jtuner.plan_stream(total, 4, method="zfp", dtype="float32", measure=False)
    assert tplan.to_dict() == jplan.to_dict()
    # and nothing measured without a seeded method: the heuristic decides alike
    assert ttuner.plan_stream(total, 4, method="mgard", backend="torch", measure=False
                              ).to_dict() == \
        jtuner.plan_stream(total, 4, method="mgard", measure=False).to_dict()


def test_candidate_race_converges_like_reference(cal_dirs):
    """Driven with the same fake walls, both packages explore the same
    candidates and pin the same winner, then persist it."""
    _seed(tcm, tcal, backend="torch")
    _seed(jcm, jcal)
    total, itemsize = 1 << 20, 4
    trail = []
    for solve, observe in (
        (lambda: ttuner.plan_stream(total, itemsize, method="zfp", backend="torch"),
         ttuner.observe),
        (lambda: jtuner.plan_stream(total, itemsize, method="zfp"), jtuner.observe),
    ):
        seen, plans = [], []
        for _ in range(ttuner._EXPLORE_K * ttuner._EXPLORE_RUNS):
            plan = solve()
            plans.append(plan.to_dict())
            cand = (plan.chunk_elems, plan.window)
            if cand not in seen:
                seen.append(cand)
            fast = len(seen) >= 2 and cand == seen[1]
            observe(plan, total, itemsize, plan.predicted_raw_s * (0.5 if fast else 2.0))
        settled = solve()
        trail.append((plans, settled.to_dict()))
        assert (settled.chunk_elems, settled.window) == seen[1]
    assert trail[0] == trail[1]
    rec = tcal.get_race_winner("zfp", "float32", total, itemsize, "torch")
    assert (rec["chunk_elems"], rec["window"]) == (trail[0][1]["chunk_elems"],
                                                  trail[0][1]["window"])

    # a fresh process (same store, caches dropped) starts on the winner
    tcal.set_calibration_dir(cal_dirs)
    _seed(tcm, tcal, backend="torch")
    started = ttuner.RACES_STARTED
    warm = ttuner.plan_stream(total, itemsize, method="zfp", backend="torch")
    assert (warm.chunk_elems, warm.window) == (rec["chunk_elems"], rec["window"])
    assert ttuner.RACES_STARTED == started


# ---------------------------------------------------------------------------
# calibration: stub clock, persistence, invalidation
# ---------------------------------------------------------------------------


def test_machine_key_names_the_port_backend(cal_dirs):
    key = tcal.machine_key("torch")
    assert key == "cpu_cpu_x1_torch"
    assert key != jcal.machine_key()
    assert tcal.calibration_path("torch") != jcal.calibration_path()


def test_stub_clock_calibration_persists_and_reloads(cal_dirs):
    sweeps0 = tcal.SWEEPS_RUN
    mc = tcal.get_method_calibration(
        "zfp", "float32", "torch", params={"rate": 16}, clock=_StubClock(),
        best_of=1, sweep_elems=(2 << 10, 4 << 10))
    assert mc is not None and tcal.SWEEPS_RUN > sweeps0
    # the stub clock's sweep: every phase timed at exactly one tick
    assert mc.profile_bytes == (8192, 16384)
    assert mc.profile_bps == pytest.approx((8192 / 1e-3, 16384 / 1e-3))
    assert mc.h2d.bps > 0 and mc.serialize.bps > 0
    assert 0 < mc.output_fraction < 1   # rate 16 of 32 bits, plus headers
    path = tcal.calibration_path("torch")
    d = json.loads(path.read_text())
    assert d["version"] == tcal.CALIBRATION_VERSION == jcal.CALIBRATION_VERSION
    assert d["machine"] == "cpu_cpu_x1_torch" and d["backend"] == "torch"
    assert "zfp:float32" in d["methods"]
    # the reference's record type reads the port's JSON layout
    jmc = jcal.MethodCalibration.from_json(d["methods"]["zfp:float32"])
    assert jmc.to_json() == mc.to_json()

    tcal.set_calibration_dir(cal_dirs)  # clears the in-process store cache
    sweeps1 = tcal.SWEEPS_RUN
    mc2 = tcal.get_method_calibration("zfp", "float32", "torch")
    assert tcal.SWEEPS_RUN == sweeps1
    assert mc2.to_json() == mc.to_json()
    assert tcal.load_store("torch").loaded_from_disk


@pytest.mark.parametrize("field,value", [("version", tcal.CALIBRATION_VERSION + 1),
                                         ("machine", "cuda_someone-elses-gpu_x8_cuda"),
                                         ("backend", "cuda")])
def test_calibration_invalidated_on_mismatch(cal_dirs, field, value):
    _seed(tcm, tcal, backend="torch")
    tcal.load_store("torch").save()
    path = tcal.calibration_path("torch")
    d = json.loads(path.read_text())
    d[field] = value
    path.write_text(json.dumps(d))
    tcal.set_calibration_dir(cal_dirs)
    assert tcal.get_method_calibration("zfp", "float32", "torch", measure=False) is None
    assert not tcal.load_store("torch").loaded_from_disk


def test_plan_stream_measures_once_then_loads(cal_dirs, monkeypatch):
    """A cold store measures through the stub-clock calibrator once; the
    plan is then ``calibrated`` and a second solve measures nothing."""
    real = tcal.Calibrator

    def stub(*a, **kw):
        kw.update(clock=_StubClock(), best_of=1, sweep_elems=(2 << 10, 4 << 10))
        return real(*a, **kw)

    monkeypatch.setattr(tcal, "Calibrator", stub)
    plan = ttuner.plan_stream(1 << 16, 4, method="zfp", backend="torch", params={"rate": 16})
    assert plan.source == "calibrated"
    sweeps = tcal.SWEEPS_RUN
    ttuner.clear_caches()
    assert ttuner.plan_stream(1 << 16, 4, method="zfp", backend="torch").source == "calibrated"
    assert tcal.SWEEPS_RUN == sweeps


def test_auto_stream_bytes_equal_explicit_and_reference(cal_dirs):
    """With both stores seeded alike, ``chunk_size="auto"`` resolves to the
    same chunking in both packages, and the port's auto stream is byte for
    byte its explicit twin and the reference's auto stream."""
    from repro.core import api as japi
    from repro_torch.core.context import GLOBAL_CMM

    _seed(tcm, tcal, backend="torch")
    _seed(jcm, jcal)
    data = np.random.default_rng(5).normal(size=(48, 24, 24)).astype(np.float32)
    tres = tapi.CompressorStream("zfp", chunk_size="auto", window="auto", backend="torch",
                                 rate=16).compress(data)
    jres = japi.CompressorStream("zfp", chunk_size="auto", window="auto", rate=16).compress(data)
    assert tres.tuned == jres.tuned and tres.tuned["source"] == "calibrated"
    misses = GLOBAL_CMM.miss_count
    explicit = tapi.CompressorStream("zfp", mode="fixed", c_fixed_elems=tres.tuned["chunk_elems"],
                                     window=1, backend="torch", rate=16).compress(data)
    assert GLOBAL_CMM.miss_count == misses  # the resolved chunking hits the same plans
    raw = tapi.CompressorStream.to_bytes(tres)
    assert raw == tapi.CompressorStream.to_bytes(explicit) == japi.CompressorStream.to_bytes(jres)


def test_auto_small_payload_degrades_to_serial(cal_dirs):
    _seed(tcm, tcal, backend="torch")
    tiny = np.random.default_rng(4).normal(size=(4, 16, 16)).astype(np.float32)
    res = tapi.CompressorStream("zfp", chunk_size="auto", window="auto", backend="torch",
                                rate=16).compress(tiny)
    assert res.window == 1 and res.max_in_flight == 1
