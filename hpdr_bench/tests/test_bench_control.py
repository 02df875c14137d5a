"""The control: the plain reference in the program's place, computed in the
precision below the configuration's float32 (bfloat16), must come out not
correct; the program, at the same size, correct.  On the CPU at a tiny size;
the ``gpu`` test repeats it on the card at a size that a test run holds."""

import pytest
import torch

from hpdr_bench import harness, spec

CELLS = ["mgard.snapshot", "zfp.resident"]


def _run(workload, seed, device, scale, control):
    cell = spec.find_cell(workload)
    driver = None
    if control:
        driver = spec.module("checks", cell.config["check"]).Control(cell.config, device,
                                                                    torch.bfloat16)
    return harness.run_cell(cell, seed, 0.05, False, device, driver=driver, scale=scale)


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("seed", [1, 2 ** 31 + 5, 3 * 10 ** 9])
def test_control_fails_and_program_passes(workload, seed, tiny):
    cpu = torch.device("cpu")
    control = _run(workload, seed, cpu, tiny, True)
    assert not control.correct
    failed = [k for k, v in control.checks.items() if v["value"] is None or v["value"] > v["limit"]]
    assert failed and "failed_calls" not in failed and "samples_missing" not in failed
    assert _run(workload, seed, cpu, tiny, False).correct


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_control_on_the_card(workload, card):
    scale = {"shape": [128, 128, 128], "fields": ["a", "b"]}
    assert not _run(workload, 77, card, scale, True).correct
    assert _run(workload, 77, card, scale, False).correct
