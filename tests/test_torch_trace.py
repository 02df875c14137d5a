"""The port's spans (``repro_torch.runtime.trace``): off, a shared no-op;
under ``torch.profiler``, ``record_function`` ranges ``repro_torch.<name>``
around the API calls, the pipeline stages and the standalone ZFP API's steps,
nested in the order the work runs, with the outputs unchanged.

This file imports neither JAX nor the reference.  The CPU tests run the
plain versions (``backend="torch"``); the ``gpu`` test traces the card and
skips without one:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_trace.py
"""

import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import api, zfp
from repro_torch.core.context import GLOBAL_CMM
from repro_torch.runtime import trace

PREFIX = trace.PREFIX


def _field(method: str, device: str = "cpu") -> torch.Tensor:
    g = torch.Generator().manual_seed(7)
    if method == "huffman":
        return torch.randint(0, 40, (4096,), generator=g, dtype=torch.int32).to(device)
    x = torch.linspace(0, 6.0, 17)
    f = torch.sin(x)[:, None, None] * torch.cos(x)[None, :, None] * x[None, None, :]
    return (f + 0.01 * torch.randn(f.shape, generator=g)).to(device)


def _spans(prof) -> list[tuple[str, int, int]]:
    """The program's spans, ``(name without the prefix, start, end)``, by start
    (a parent before the child that starts with it)."""
    found = [(e.name()[len(PREFIX):], e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith(PREFIX) and e.device_type() == torch.autograd.DeviceType.CPU]
    return sorted(found, key=lambda s: (s[1], -s[2]))


def _inside(spans, parent: str) -> list[str]:
    """Names of the spans inside the first span ``parent``, by start."""
    _, lo, hi = next(s for s in spans if s[0] == parent)
    return [n for n, a, b in spans if lo <= a and b <= hi and (n, a, b) != (parent, lo, hi)]


def test_span_off_is_one_shared_null_context():
    assert not torch.autograd.profiler._is_profiler_enabled
    first, second = trace.span("api.encode"), trace.span("zfp.launch")
    assert first is second is trace._OFF
    assert isinstance(first, contextlib.nullcontext)
    with first:
        pass


def test_span_on_is_a_record_function_range():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert torch.autograd.profiler._is_profiler_enabled
        with trace.span("probe"):
            torch.ones(3).sum()
    assert [n for n, _, _ in _spans(prof)] == ["probe"]
    assert trace.span("probe") is trace._OFF  # off again once the profile ends


@pytest.mark.parametrize("method", ["mgard", "zfp", "huffman"])
def test_api_spans_nest_in_graph_order(method):
    data = _field(method)
    spec = api.make_spec(data, method, backend="torch")
    stages = api.get_plan(spec).pipeline.graph.stages
    c0 = api.compress(data, method, backend="torch")  # the decode plan built too
    api.decompress(c0, backend="torch")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        c = api.compress(data, method, backend="torch")
        api.decompress(c, backend="torch")
    spans = _spans(prof)
    top = [n for n, _, _ in spans if n in ("api.encode", "api.decode")]
    assert top == ["api.encode", "api.decode"]

    encode = [n for n in _inside(spans, "api.encode") if n.startswith("stage.")
              and not n.endswith(".fetch")]
    assert encode == ["stage.stage_in"] + [f"stage.{st.name}" for st in stages]
    assert "codec.fetch" in _inside(spans, "api.encode")
    for st in stages:
        if not st.device and st.fetches:
            assert _inside(spans, f"stage.{st.name}") == [f"stage.{st.name}.fetch"]

    decode = [n for n in _inside(spans, "api.decode") if n.startswith("stage.")]
    assert decode == ([f"stage.{st.name}" for st in stages if not st.device] + ["stage.stage_in"]
                      + [f"stage.invert[{st.name}]" for st in reversed(stages)
                         if st.device and st.inv_writes])
    if method == "mgard":
        assert "stage.codebook_build.fetch" in _inside(spans, "stage.codebook_build")
        assert "stage.mgard_decorrelate" in encode and "stage.bit_pack" in encode
        assert "stage.invert[mgard_decorrelate]" in decode


def test_one_plan_build_per_plan_cache_miss():
    data = _field("mgard")
    GLOBAL_CMM.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        api.compress(data, "mgard", backend="torch")
        api.compress(data, "mgard", backend="torch")
    names = [n for n, _, _ in _spans(prof)]
    assert names.count("api.plan_build") == 1 and names.count("api.encode") == 2
    assert "api.plan_build" in _inside(_spans(prof), "api.encode")


@pytest.mark.parametrize("direction,children", [
    ("compress", ["zfp.place", "zfp.pad", "zfp.launch"]),
    ("decompress", ["zfp.launch", "zfp.cast"]),
])
def test_standalone_zfp_spans(direction, children):
    data = _field("zfp")
    z = zfp.compress(data, rate=16)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        if direction == "compress":
            zfp.compress(data, rate=16)
        else:
            zfp.decompress(z)
    spans = _spans(prof)
    assert [n for n, _, _ in spans][0] == f"zfp.{direction}"
    inside = _inside(spans, f"zfp.{direction}")
    assert inside == children and len(inside) <= 4


@pytest.mark.parametrize("method", ["mgard", "zfp", "huffman", "standalone-zfp"])
def test_outputs_bit_identical_with_profiler_on_and_off(method):
    data = _field("zfp" if method == "standalone-zfp" else method)

    def run():
        if method == "standalone-zfp":
            z = zfp.compress(data, rate=12)
            return [z.payload.numpy().tobytes(), z.emax.numpy().tobytes()], zfp.decompress(z)
        c = api.compress(data, method, backend="torch")
        return [c.to_bytes()], api.decompress(c, backend="torch")

    stored_off, values_off = run()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        stored_on, values_on = run()
    assert _spans(prof)  # the profile saw the program's spans
    assert stored_on == stored_off
    assert np.array_equal(values_on.numpy().view(np.uint8), values_off.numpy().view(np.uint8))


@pytest.mark.gpu
def test_cuda_every_device_op_launched_inside_a_program_span():
    """A traced mgard compress and decompress on the card: each device
    operation is linked to its launch (``hpdr_bench.program_spans``), and
    every launch lies inside a ``repro_torch.`` span."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels run only there")
    from hpdr_bench import program_spans, tracing

    data = _field("mgard", "cuda")
    c = api.compress(data, "mgard", backend="cuda")  # kernels loaded, plans built
    api.decompress(c, backend="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        c = api.compress(data, "mgard", backend="cuda")
        out = api.decompress(c, backend="cuda")
        torch.cuda.synchronize()
    assert out.shape == data.shape
    found = tracing.collect(prof, [])
    spans = sorted((a, b) for n, a, b in found.host_ops if n.startswith(PREFIX))
    assert found.device_ops and spans
    for op, launched in zip(found.device_ops, program_spans.launch_times(found)):
        assert launched is not None, op.name
        assert any(a <= launched <= b for a, b in spans), op.name
