"""The metric arithmetic, on synthetic timings and a synthetic trace."""

import pytest

from hpdr_bench import spec, stats, tracing
from hpdr_bench.harness import Phase, Window
from hpdr_bench.tracing import Call, DeviceOp, TraceData

MB = 1 << 20


def test_phase_rate_counts_the_gaps():
    # two phases of 3 calls of 100 MB; calls take 10 ms, the gaps make each phase 40 ms
    calls = [0.010] * 3
    assert stats.phase_rate_gbps([300 * MB], [sum(calls)]) == pytest.approx(300 * MB / 0.030 / 1e9)
    rate = stats.phase_rate_gbps([300 * MB, 300 * MB], [0.040, 0.040])
    assert rate == pytest.approx(600 * MB / 0.080 / 1e9)
    with pytest.raises(ValueError):
        stats.phase_rate_gbps([1], [0.0])


@pytest.mark.parametrize("n,value,beyond", [(20, 19, 1), (200, 190, 10), (204, 194, 10), (1, 1, 0)])
def test_p95_nearest_rank_and_its_count(n, value, beyond):
    assert stats.p95([float(i) for i in range(n, 0, -1)]) == (float(value), n, beyond)


def test_spread_is_python_quartiles_over_median():
    assert stats.spread([1, 2, 3, 4, 5, 6]) == pytest.approx((5.25 - 1.75) / 3.5)


@pytest.mark.parametrize("field,stored", [(536870912, 99376890), (536870912, 276824064)])
def test_roofline_bytes(field, stored):
    assert stats.compress_roofline_bytes(field, stored) == field + stored
    assert stats.decompress_roofline_bytes(field, stored) == field + stored
    # 3.35 TB/s, 0.30 ms of kernel: the ZFP cell's share
    pct = stats.roofline_pct(field + stored, 3.35e12, 0.30e-3)
    assert pct == pytest.approx(100 * (field + stored) / 3.35e12 / 0.30e-3)
    assert stats.roofline_pct(field, 3.35e12, 0.0) is None


def test_union_and_gaps():
    iv = [(0, 10), (5, 20), (30, 40), (50, 60)]
    assert stats.union_seconds(iv, 0, 45) == pytest.approx(30e-9)
    assert stats.gaps(iv, 0, 70) == [(20, 30), (40, 50), (60, 70)]
    assert stats.gaps([], 3, 9) == [(3, 9)]


def _window() -> Window:
    w = Window(setup_s=12.5)
    w.calls = [Call(0, "compress", 0, 0, 0.010, 100, 25),
               Call(1, "compress", 1, 0, 0.030, 100, 25),
               Call(2, "decompress", 0, 0, 0.005, 100, 25),
               Call(3, "decompress", 1, 0, 0.005, 100, 25)]
    w.phases = [Phase("compress", 200, 0.050), Phase("decompress", 200, 0.020)]
    return w


def test_end_to_end_readers():
    w = _window()
    read = {m: spec.module("end_to_end", m).read(w) for m in
            ("compress_GBps", "decompress_GBps", "compress_p95_ms", "ratio", "setup_s")}
    assert read["compress_GBps"] == pytest.approx(200 / 0.050 / 1e9)
    assert read["decompress_GBps"] == pytest.approx(200 / 0.020 / 1e9)
    assert read["compress_p95_ms"] == pytest.approx(30.0)
    assert read["ratio"] == pytest.approx(4.0)
    assert read["setup_s"] == 12.5


def _trace() -> TraceData:
    calls = [Call(0, "compress", 0, 0, 0.0, 1000, 500), Call(1, "decompress", 0, 0, 0.0, 1000, 500)]
    t = TraceData(calls=calls, device_name="NVIDIA H100 80GB HBM3")
    t.spans = {0: (0, 1000), 1: (1000, 2000)}
    t.device_ops = [DeviceOp("enc", 100, 300, "kernel"),
                    DeviceOp("Memcpy DtoH", 300, 700, "memcpy"),
                    DeviceOp("Memcpy HtoD", 1050, 1150, "memcpy"),
                    DeviceOp("dec", 1200, 1400, "kernel"), DeviceOp("tail", 1950, 2150, "kernel")]
    t.host_ops = [("aten::copy_", 250, 800), ("cudaMemcpyAsync", 300, 790)]
    t.plan_misses = 0
    t.stage_seconds = [{"encode.bit_pack": 0.04, "decode.invert[mgard_decorrelate]": 0.03},
                       {"encode.bit_pack": 0.02, "decode.invert[mgard_decorrelate]": 0.01}]
    return t


def test_trace_attribution_and_readers():
    t = _trace()
    assert t.window == (0, 2000)
    assert t.seconds_in("compress") == pytest.approx(200e-9)  # the copy is no kernel
    assert t.seconds_in("decompress") == pytest.approx(200e-9)  # "tail" ends outside
    assert t.seconds_in("compress", "memcpy", "DtoH") == pytest.approx(400e-9)
    assert t.seconds_in("compress", "memcpy", "HtoD") == 0
    assert t.busy_seconds() == pytest.approx(950e-9)  # clipped to the window
    read = {m: spec.module("metrics", m).read(t) for m in
            ("plan_misses", "fetch_ms", "stage_in_ms", "bit_pack_ms", "recompose_ms",
             "compress_roofline", "decompress_roofline", "device_idle_pct")}
    assert read["plan_misses"] == 0
    assert read["fetch_ms"] == pytest.approx(400e-6)  # one compress call, 400 ns of DtoH
    assert read["stage_in_ms"] == pytest.approx(100e-6)
    assert read["bit_pack_ms"] == pytest.approx(30.0) and read["recompose_ms"] == pytest.approx(20.0)
    least = 1500 / 3.35e12
    assert read["compress_roofline"] == pytest.approx(100 * least / 200e-9)
    assert read["decompress_roofline"] == pytest.approx(100 * least / 200e-9)
    assert read["device_idle_pct"] == pytest.approx(100 * (1 - 950 / 2000))


def test_readers_return_nothing_to_read():
    empty = TraceData(calls=[], device_name="some other card")
    for m in ("fetch_ms", "stage_in_ms", "bit_pack_ms", "compress_roofline",
              "decompress_roofline", "device_idle_pct", "plan_misses"):
        assert spec.module("metrics", m).read(empty) is None
    t = _trace()
    t.device_name = "a card without peaks"
    assert spec.module("metrics", "compress_roofline").read(t) is None


def test_breakdown_labels_idle_time_by_host_activity():
    b = tracing.breakdown(_trace())
    assert b["device_ops"][0] == ["Memcpy DtoH", pytest.approx(400e-9)]
    idle = dict(b["idle_gaps"])
    # a gap goes whole to what was open at its middle: [0, 100) and [700, 1050) in compress
    assert idle["compress/python"] == pytest.approx(450e-9)
    assert idle["decompress/python"] == pytest.approx(600e-9)  # [1150, 1200), [1400, 1950)
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
