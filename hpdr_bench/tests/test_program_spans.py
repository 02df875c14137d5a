"""The readers of the program's spans (``program_spans.py`` and the six
metrics on it), on a synthetic trace with program spans, nested children,
launch calls and device operations whose timestamps drift off the host's."""

import pytest

from hpdr_bench import program_spans, spec, tracing
from hpdr_bench.tracing import Call, DeviceOp, TraceData

NEW_READERS = ("decorrelate_dev_ms", "bit_pack_dev_ms", "recompose_dev_ms", "codebook_host_ms",
               "compress_lead_ms", "decompress_lead_ms")
OLD_READERS = ("plan_misses", "fetch_ms", "stage_in_ms", "bit_pack_ms", "recompose_ms",
               "compress_roofline", "decompress_roofline", "device_idle_pct")
P = "repro_torch."

# (device op, kind, device start, device end, host start of its launch call)
OPS = [("lerp", "kernel", 40, 140, 30), ("solve", "kernel", 150, 250, 180),
       ("Memcpy DtoH (Device -> Pageable)", "memcpy", 330, 350, 325),
       ("pack", "kernel", 620, 720, 610), ("pack2", "kernel", 720, 760, 690),
       ("Memcpy HtoD (Pageable -> Device)", "memcpy", 1050, 1080, 1040),  # in no stage span
       ("recompose", "kernel", 1200, 1500, 1150),
       ("zfp_encode", "kernel", 2150, 2450, 2130), ("zfp_decode", "kernel", 3080, 3300, 3060),
       ("late", "kernel", 4150, 4180, 4110)]  # outside every call
LAUNCH = {"kernel": "cudaLaunchKernel", "memcpy": "cudaMemcpyAsync"}


def _program_trace(drift: int = 0, spans: bool = True, launches: bool = True) -> TraceData:
    """Two mgard-like calls and two zfp-like calls: compress [0, 1000] and
    decompress [1000, 2000], then [2000, 3000] and [3000, 4000].  Device
    timestamps are ``drift`` ns off the host's (``solve`` starts before its
    launch even at 0)."""
    calls = [Call(0, "compress", 0, 0, 0.0, 1000, 500), Call(1, "decompress", 0, 0, 0.0, 1000, 500),
             Call(2, "compress", 1, 0, 0.0, 1000, 500), Call(3, "decompress", 1, 0, 0.0, 1000, 500)]
    t = TraceData(calls=calls, device_name="NVIDIA H100 80GB HBM3")
    t.spans = {0: (0, 1000), 1: (1000, 2000), 2: (2000, 3000), 3: (3000, 4000)}
    if spans:
        t.host_ops += [
            (P + "api.encode", 10, 990), (P + "stage.mgard_decorrelate", 20, 200),
            (P + "stage.codebook_build", 300, 500), (P + "stage.codebook_build.fetch", 320, 360),
            (P + "stage.bit_pack", 600, 700),
            (P + "api.decode", 1010, 1990), (P + "stage.invert[mgard_decorrelate]", 1100, 1400),
            (P + "zfp.compress", 2010, 2500), (P + "zfp.place", 2020, 2040),
            (P + "zfp.pad", 2050, 2100), (P + "zfp.launch", 2120, 2200),
            (P + "zfp.decompress", 3010, 3400), (P + "zfp.launch", 3050, 3100),
            (P + "zfp.cast", 3200, 3300),
            (P + "stage.mgard_decorrelate", 4100, 4200),  # outside every call: not counted
        ]
    # runtime calls that enqueue nothing, the first inside zfp.compress before its launch
    t.host_ops += [("cudaStreamIsCapturing", 2110, 2112), ("cudaEventRecordWithFlags", 5, 6),
                   ("cudaStreamSynchronize", 340, 355), ("cudaMalloc", 3055, 3058),
                   ("cudaLaunchHostFunc", 900, 901), ("aten::add", 25, 40)]
    if launches:
        t.host_ops += [(LAUNCH[kind], h, h + 5) for _, kind, _, _, h in OPS]
    t.device_ops = [DeviceOp(n, a + drift, b + drift, k) for n, k, a, b, _ in OPS]
    t.plan_misses = 0
    t.stage_seconds = [{"encode.bit_pack": 0.04, "decode.invert[mgard_decorrelate]": 0.03}]
    return t


@pytest.mark.parametrize("drift", [0, -25_000, 7_000_000])
def test_program_span_readers(drift):
    t = _program_trace(drift)
    read = {m: spec.module("metrics", m).read(t) for m in NEW_READERS}
    # per compress call (2 of them): lerp + solve, launched inside the stage
    assert read["decorrelate_dev_ms"] == pytest.approx((100 + 100) / 2 / 1e6)
    assert read["bit_pack_dev_ms"] == pytest.approx((100 + 40) / 2 / 1e6)
    assert read["recompose_dev_ms"] == pytest.approx(300 / 2 / 1e6)
    # the codebook's 200 ns less its fetch child's 40, over 2 compress calls
    assert read["codebook_host_ms"] == pytest.approx(160 / 2 / 1e6)
    # one call of each direction launched: from the span's start to the launch
    assert read["compress_lead_ms"] == pytest.approx(120 / 1e6)
    assert read["decompress_lead_ms"] == pytest.approx(50 / 1e6)


def test_self_time_and_attribution_to_the_innermost_span():
    t = _program_trace()
    assert program_spans.self_ns(t, "stage.codebook_build", "compress") == [160, 0]
    assert program_spans.self_ns(t, "zfp.compress", "compress") == [0, 490 - 20 - 50 - 80]
    # a parent span is charged what its children launched; a child only its own
    enc = program_spans.device_ms_per_call(t, "api.encode", "compress")
    assert enc == pytest.approx((100 + 100 + 20 + 100 + 40) / 2 / 1e6)
    assert program_spans.device_ms_per_call(t, "stage.codebook_build.fetch", "compress") == \
        pytest.approx(20 / 2 / 1e6)
    assert program_spans.device_ms_per_call(t, "zfp.launch", "decompress") == \
        pytest.approx(220 / 2 / 1e6)
    assert program_spans.device_ms_per_call(t, "zfp.cast", "decompress") == 0
    assert program_spans.per_call(t, "stage.mgard_decorrelate", "compress") == [[(20, 200)], []]


@pytest.mark.parametrize("name,kind", [
    ("cudaLaunchKernel", "kernel"), ("cudaLaunchKernelExC", "kernel"), ("cuLaunchKernel", "kernel"),
    ("cuLaunchKernelEx", "kernel"), ("cudaMemcpyAsync", "memcpy"), ("cudaMemcpy", "memcpy"),
    ("cuMemcpyDtoHAsync_v2", "memcpy"), ("cudaMemsetAsync", "memset"),
    ("cudaLaunchHostFunc", None), ("cudaStreamSynchronize", None), ("cudaMalloc", None),
    ("cudaEventRecordWithFlags", None), ("cudaFuncSetAttribute", None),
    ("aten::copy_", None), ("repro_torch.zfp.launch", None)])
def test_launch_kind(name, kind):
    assert program_spans.launch_kind(name) == kind


@pytest.mark.parametrize("drift", [0, -25_000, 7_000_000])
def test_operations_link_to_launches_by_order_not_by_time(drift):
    t = _program_trace(drift)
    assert program_spans.launch_times(t) == [h for *_, h in OPS]
    # one kernel launch missing from the profile: no kernel is linked, the copies still are
    t.host_ops = [h for h in t.host_ops if (h[0], h[1]) != ("cudaLaunchKernel", 610)]
    assert program_spans.launch_times(t) == [h if k == "memcpy" else None for _, k, _, _, h in OPS]


def test_program_span_readers_have_nothing_to_read_without_spans_or_launches():
    # a program without spans, as the parent of the spans
    for t in (_program_trace(spans=False), TraceData(calls=[])):
        for m in NEW_READERS:
            assert spec.module("metrics", m).read(t) is None, m
    unlinked = _program_trace(launches=False)
    for m in ("decorrelate_dev_ms", "bit_pack_dev_ms", "recompose_dev_ms", "compress_lead_ms",
              "decompress_lead_ms"):
        assert spec.module("metrics", m).read(unlinked) is None, m
    assert spec.module("metrics", "codebook_host_ms").read(unlinked) == pytest.approx(80 / 1e6)


@pytest.mark.parametrize("drift", [0, -25_000])
def test_old_readers_read_the_same_with_and_without_program_spans(drift):
    spanned = _program_trace(drift)
    bare = _program_trace(drift, spans=False, launches=False)
    for m in OLD_READERS:
        reader = spec.module("metrics", m)
        assert reader.read(spanned) == reader.read(bare), m
    assert tracing.breakdown(spanned)["device_ops"] == tracing.breakdown(bare)["device_ops"]
