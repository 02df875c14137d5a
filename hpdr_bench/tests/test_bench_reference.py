"""The plain references against the program at tiny sizes on the CPU's plain
backend: the same container sections, metadata and reconstruction, bit for bit."""

import numpy as np
import pytest
import torch

from hpdr_bench.reference import mgard as ref_mgard
from hpdr_bench.reference import zfp as ref_zfp
from hpdr_bench.reference import zfp_tables as ref_tables

SHAPES = [(24, 20, 17), (33, 33, 33), (16, 16, 16), (9, 40)]


def _field(shape, seed):
    g = torch.Generator().manual_seed(seed)
    ramp = torch.linspace(0, 3, shape[-1])
    return torch.exp(torch.randn(shape, generator=g) * 0.5 + ramp)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("eps", [1e-2, 1e-4])
def test_mgard_reference_is_the_container(shape, eps):
    from repro_torch.core import api

    x = _field(shape, 7)
    c = api.compress(x, "mgard", error_bound=eps, relative=True, backend="torch")
    want = ref_mgard.compress(x, eps, 4096)
    assert set(c.arrays) == set(want["arrays"])
    for k, v in want["arrays"].items():
        got = np.asarray(c.arrays[k])
        assert got.dtype == v.dtype and got.shape == v.shape and np.array_equal(got, v), k
    for k, v in want["meta"].items():
        got = c.meta[k]
        assert (list(got) if isinstance(got, tuple) else got) == v, k
    out = api.decompress(c, backend="torch")
    rec = ref_mgard.reconstruct(want["q"], want["arrays"]["bins"], shape)
    assert torch.equal(out, rec)
    assert float((rec - x).abs().max()) <= want["meta"]["error_bound"]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("rate", [16, 7])
def test_zfp_reference_is_the_stream(shape, rate):
    from repro_torch.core import zfp

    x = _field(shape, 11)
    z = zfp.compress(x, rate)
    payload, emax = ref_zfp.compress(x, rate)
    assert torch.equal(z.payload, payload) and torch.equal(z.emax, emax)
    assert torch.equal(zfp.decompress(z), ref_zfp.decompress(payload, emax, rate, shape))


def test_lower_precision_differs():
    x = _field((17, 17, 17), 3)
    a = ref_mgard.compress(x, 1e-2, 4096)
    b = ref_mgard.compress(x, 1e-2, 4096, torch.bfloat16)
    assert not np.array_equal(a["arrays"]["words"], b["arrays"]["words"])
    p, _ = ref_zfp.compress(x, 16)
    q, _ = ref_zfp.compress(x, 16, torch.bfloat16)
    assert not torch.equal(p, q)


@pytest.mark.parametrize("sign, name", [(-1, "ENC_SCALE_BITS"), (1, "DEC_SCALE_BITS")])
def test_zfp_scale_tables_from_the_formula_are_the_program_s(sign, name):
    """The reference works its tables out from the format's formula; not one
    entry differs from the program's constants (which its own tests hold to
    JAX's exp2), and the formula is not an exact power of two."""
    from repro_torch.core import zfp_tables as program_tables

    got = ref_tables.scale_values(sign).view(np.uint32)
    want = np.asarray(getattr(program_tables, name), dtype=np.uint32)
    assert got.shape == want.shape == (ref_tables.EMAX - ref_tables.EMIN + 1,)
    assert int(np.count_nonzero(got != want)) == 0
    x = sign * (np.arange(ref_tables.EMIN, ref_tables.EMAX + 1) - 30)
    with np.errstate(over="ignore"):
        exact = np.ldexp(np.float32(1), x).astype(np.float32)
    finite = np.isfinite(exact) & (exact >= np.finfo(np.float32).tiny)
    assert np.count_nonzero(ref_tables.scale_values(sign)[finite] != exact[finite]) > 100
    ends = ref_tables.scale_values(sign)[[0, -1]]
    assert sorted(ends.tolist()) == [0.0, float("inf")]  # both tables saturate before their ends
