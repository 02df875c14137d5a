"""A run with the timed path broken underneath must come out not correct.

The harness's look for a card is skipped (the CPU, a tiny size); the program
runs through its own driver, wrapped so that one fault is planted where the
output is produced.  The cells run on one card, so the exchange between cards
that a four-card cell could leave out does not exist here.
"""

import numpy as np
import pytest
import torch

from hpdr_bench import harness, spec, traffic

CPU = torch.device("cpu")


class Broken:
    """The program's driver with one fault planted."""

    def __init__(self, workload, fault):
        cell = spec.find_cell(workload)
        self.inner = spec.module("drivers", cell.config["driver"]).Driver(cell.config, CPU)
        self.fault = fault

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def compress(self, field):
        if self.fault == "half_batch":  # half the values left out, their mean in their place
            flat = field.reshape(-1).clone()
            half = flat.numel() // 2
            flat[half:] = flat[:half].mean()
            field = flat.reshape(field.shape)
        out = self.inner.compress(field)
        if self.fault == "altered_output":  # one bit of the stored form flipped
            if hasattr(out, "arrays"):
                words = np.array(out.arrays["words"])
                words[len(words) // 2] ^= np.uint32(1 << 7)
                out.arrays["words"] = words
            else:
                out.payload[out.payload.shape[0] // 2, 3] ^= 1 << 7
        return out

    def decompress(self, out):
        recon = self.inner.decompress(out)
        if self.fault == "state_unchanged":  # the output buffer handed back as allocated
            return torch.zeros_like(recon)
        if self.fault == "altered_answer":  # one reconstructed value changed
            recon = recon.clone()
            recon.view(-1)[recon.numel() // 3] += 1.0
        return recon


@pytest.mark.parametrize("workload", ["mgard.snapshot", "zfp.resident"])
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "altered_output",
                                   "altered_answer"])
def test_fault_is_not_correct(workload, fault, tiny):
    cell = spec.find_cell(workload)
    out = harness.run_cell(cell, 2 ** 31 + 9, 0.05, False, CPU, driver=Broken(workload, fault),
                           scale=tiny)
    assert not out.correct, out.checks


def test_a_failing_call_is_counted_and_not_correct(tiny):
    cell = spec.find_cell("zfp.resident")
    warm = len(tiny["fields"]) * (traffic.WARMUP_ROUNDS + cell.config["resident_snapshots"])

    class Failing(Broken):
        calls = 0

        def decompress(self, out):
            Failing.calls += 1
            if Failing.calls > warm:  # the warm-up rounds pass, the window's calls raise
                raise RuntimeError("device lost")
            return self.inner.decompress(out)

    out = harness.run_cell(cell, 4, 0.05, False, CPU, driver=Failing("zfp.resident", None),
                           scale=tiny)
    assert not out.correct and out.failed > 0 and out.attempted > out.failed
    assert out.checks["failed_calls"]["value"] == out.failed
