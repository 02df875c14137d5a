"""The ``mgard.stream`` cell on the CPU at a small size: the plain chunked
reference (``reference/stream.py``) against the program's stream, the
check's planted faults, the control, and the cell's four metric readers on
synthetic traces."""

import copy

import numpy as np
import pytest
import torch

from hpdr_bench import data, harness, spec
from hpdr_bench.checks import stream as check
from hpdr_bench.reference import stream as ref
from hpdr_bench.tests.test_bench_imports import BENCH, FORBIDDEN, top_level_imports
from hpdr_bench.tracing import Call, DeviceOp, TraceData

CPU = torch.device("cpu")
SHAPE = [24, 16, 16]
CHUNK = 5 * 16 * 16          # chunks of 5, 5, 5, 5 and 4 planes
SMALL = {"shape": SHAPE, "fields": ["a", "b"]}
READERS = ("stream_stage_ms", "stream_overlap", "restore_overlap", "copy_exposed_pct")


def _cell():
    cell = copy.deepcopy(spec.find_cell("mgard.stream"))
    cell.config["program"]["params"]["c_fixed_elems"] = CHUNK
    return cell


@pytest.fixture(scope="module")
def made():
    """One small field, the program's stream of it and its read-back."""
    cell = _cell()
    config = harness.scaled(cell.config, SMALL)
    field = data.make_fields(config["data"], 2 ** 31 + 11, CPU)[0]
    driver = spec.module("drivers", "stream").Driver(config, CPU)
    res = driver.compress(field)
    return config, field, driver, res, driver.decompress(res)


def _numbers(made, res=None, recon=None):
    config, field, driver, base, _ = made
    res = base if res is None else res
    return check.compare(field, driver.sections(res), driver.meta(res), recon, config)


def _over(numbers) -> list[str]:
    return [k for k, (_, limit) in check.LIMITS.items() if k in numbers and numbers[k] > limit]


# ---------------------------------------------------------------------------
# the reference against the program
# ---------------------------------------------------------------------------


def test_the_reference_holds_the_program_byte_for_byte(made):
    config, field, driver, res, recon = made
    want = ref.compress(field, CHUNK, 0.01, 4096)
    assert [c["meta"]["shape"][0] for c in want["chunks"]] == [5, 5, 5, 5, 4]
    assert res.boundaries == want["boundaries"] == [0, 5, 10, 15, 20]
    for c, w in zip(res.chunks, want["chunks"]):
        assert sorted(c.arrays) == sorted(w["arrays"])
        for k, v in c.arrays.items():
            assert np.array_equal(np.asarray(v).view(np.uint8), np.asarray(w["arrays"][k])
                                  .astype(np.asarray(v).dtype).view(np.uint8)), k
    expect = ref.reconstruct(want)
    assert torch.equal(recon.view(torch.int32), expect.view(torch.int32))
    numbers = _numbers(made, recon=recon)
    assert not _over(numbers) and numbers["err_over_bound"] <= 1.0


@pytest.mark.parametrize("shape,chunk", [((512, 512, 512), 26214400), ((24, 16, 16), CHUNK),
                                         ((7, 30, 9), 50), ((16, 16, 16), 16 ** 3),
                                         ((9, 40), 130), ((100, 3), 1)])
def test_the_row_schedule_is_the_program_s(shape, chunk):
    from repro_torch.core import pipeline as tpl

    axis, rows = ref.row_schedule(shape, chunk)
    pipe = tpl.ChunkedPipeline(compute_fn=lambda c, s: c, mode="fixed", c_fixed_elems=chunk)
    assert axis == int(np.argmax(shape))
    assert rows == pipe._row_schedule(torch.empty(shape, device="meta"), axis)
    if shape == (512, 512, 512):
        assert rows == [100] * 5 + [12]


def test_the_reference_imports_nothing_of_the_program():
    names = top_level_imports(BENCH / "reference" / "stream.py")
    assert not names & (FORBIDDEN | {"repro_torch"})


# ---------------------------------------------------------------------------
# planted faults
# ---------------------------------------------------------------------------


def _faulted(made, fault):
    config, field, driver, base, _ = made
    res = copy.copy(base)
    res.chunks = [copy.copy(c) for c in base.chunks]
    for c in res.chunks:
        c.arrays = dict(c.arrays)
    if fault == "flipped_word":
        words = np.array(res.chunks[1].arrays["words"])
        words[len(words) // 2] ^= np.uint32(1 << 5)
        res.chunks[1].arrays["words"] = words
    elif fault == "swapped":
        res.chunks[1], res.chunks[2] = res.chunks[2], res.chunks[1]
    elif fault == "field_bound":  # one chunk bounded by the field's range, not its own
        from repro_torch.core import api

        span = float(np.float32(field.max().item()) - np.float32(field.min().item()))
        part = field[10:15].contiguous()
        res.chunks[2] = api.compress(part, "mgard", error_bound=0.01 * span, relative=False,
                                     backend="torch")
    elif fault == "missing":
        res.chunks = res.chunks[:-1]
        res.boundaries = res.boundaries[:-1]
    return res


@pytest.mark.parametrize("fault", ["flipped_word", "swapped", "field_bound", "missing"])
def test_the_check_catches_a_planted_fault(made, fault):
    numbers = _numbers(made, _faulted(made, fault))
    assert _over(numbers), numbers
    if fault == "missing":
        assert numbers["chunk_count_diff"] == 1


def test_a_reconstruction_from_a_flipped_word_is_caught(made):
    config, field, driver, _, _ = made
    res = _faulted(made, "flipped_word")
    recon = driver.decompress(res)
    numbers = _numbers(made, res, recon)
    assert numbers["recon_values_diff"] > 0


def test_the_control_fails_and_the_program_passes():
    cell = _cell()
    control = check.Control(harness.scaled(cell.config, SMALL), CPU, torch.bfloat16)
    out = harness.run_cell(cell, 3 * 10 ** 9, 0.05, False, CPU, driver=control, scale=SMALL)
    failed = [k for k, v in out.checks.items() if v["value"] is None or v["value"] > v["limit"]]
    assert failed and "failed_calls" not in failed and "samples_missing" not in failed
    out = harness.run_cell(cell, 3 * 10 ** 9, 0.05, False, CPU, scale=SMALL)
    assert out.correct, out.checks
    assert set(out.metrics) == {"compress_GBps", "decompress_GBps", "ratio", "setup_s"}


# ---------------------------------------------------------------------------
# the readers
# ---------------------------------------------------------------------------


def _trace(with_program: bool) -> TraceData:
    calls = [Call(0, "compress", 0, 0, 0.0, 1000, 500), Call(1, "decompress", 0, 0, 0.0, 1000, 500),
             Call(2, "compress", 1, 0, 0.0, 1000, 500)]
    t = TraceData(calls=calls, device_name="NVIDIA H100 80GB HBM3")
    t.spans = {0: (0, 1000), 1: (1000, 2000), 2: (2000, 3000)}
    t.device_ops = [DeviceOp("decode", 1100, 1500, "kernel"), DeviceOp("fill", 1700, 1800, "memset")]
    if with_program:
        P = "repro_torch."
        t.host_ops = [(P + "pipeline.stage", 10, 4_000_010), (P + "pipeline.stage", 500, 600),
                      (P + "pipeline.restore_stage", 1010, 1100),
                      (P + "pipeline.stage", 2010, 2_000_010)]
        t.device_ops += [DeviceOp("Memcpy HtoD (Pinned -> Device)", 1400, 1600, "memcpy"),
                         DeviceOp("encode", 2100, 2500, "kernel"),
                         DeviceOp("Memcpy HtoD (Pinned -> Device)", 2400, 2600, "memcpy")]
        t.stage_seconds = [{"stream_overlap": 1.5, "restore_overlap": 1.2},
                           {"stream_overlap": 2.5, "restore_overlap": 1.4}]
    return t


def test_the_readers_read_a_synthetic_trace():
    t = _trace(True)
    got = {name: spec.module("metrics", name).read(t) for name in READERS}
    # compress call 0: 4.0 + 0.0001 ms of staging; call 2: 1.998 ms
    assert got["stream_stage_ms"] == pytest.approx((4_000_000 + 100 + 1_998_000) / 2 / 1e6)
    assert got["stream_overlap"] == pytest.approx(2.0)
    assert got["restore_overlap"] == pytest.approx(1.3)
    # inside the compress calls: busy 2100-2600 (500 ns), the copy alone
    # 2500-2600 (100 ns); the decompress call's copy is not counted
    assert got["copy_exposed_pct"] == pytest.approx(100 * 100 / 500)


def test_the_readers_give_nothing_without_the_program_s_numbers():
    t = _trace(False)
    assert {name: spec.module("metrics", name).read(t) for name in READERS} == dict.fromkeys(READERS)
    empty = TraceData(calls=[])
    assert all(spec.module("metrics", name).read(empty) is None for name in READERS)
