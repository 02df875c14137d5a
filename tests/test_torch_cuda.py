"""The port's CUDA kernels against their plain PyTorch versions, on the card.

This file imports neither JAX nor the reference, so it runs on a machine that
has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

Every test is marked ``gpu`` and skips where ``torch.cuda.is_available()`` is
False (the kernels have no CPU mode).  Tolerance: none — payload words, emax
and decoded floats (as bit patterns) must be identical.
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.core import api
from repro_torch.kernels.zfp_block import kernel, ref

torch.set_num_threads(2)

RATES = (1, 7, 16, 32)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the zfp_block kernels run only there")
    return torch.device("cuda")


def _blocks(dims: int, n: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    bs = 4 ** dims
    tiny = np.finfo(np.float32).tiny
    x = (rng.normal(size=(n, bs)) * np.exp2(rng.integers(-30, 30, size=(n, 1))))
    x = x.astype(np.float32)
    x[0] = 0.0
    x[1] = rng.uniform(-1, 1, bs).astype(np.float32) * tiny * 0.5
    x[2] = rng.normal(size=bs).astype(np.float32) * np.float32(2.0 ** -100)
    x[3] = rng.uniform(-1, 1, bs).astype(np.float32) * np.float32(3.4e38)
    x[4, 0] = math.inf
    x[5, 1] = math.nan
    x[6, ::2] = tiny * 0.25
    x[7] = -math.inf
    return torch.from_numpy(x)


@pytest.mark.gpu
@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("dims", [1, 2, 3, 4])
def test_cuda_kernel_matches_plain_version(cuda_device, dims, rate):
    x = _blocks(dims, 2000 // dims + 3, seed=dims + rate)
    before = dict(kernel.launches)
    p, e = kernel.compress_blocks(x.to(cuda_device), rate, dims)
    d = kernel.decompress_blocks(p, e, rate, dims)
    torch.cuda.synchronize()
    assert kernel.launches["compress_blocks"] == before["compress_blocks"] + 1
    assert kernel.launches["decompress_blocks"] == before["decompress_blocks"] + 1
    rp, re_ = ref.compress_blocks(x, rate, dims)
    rd = ref.decompress_blocks(rp, re_, rate, dims)
    assert torch.equal(p.cpu(), rp) and torch.equal(e.cpu(), re_)
    assert torch.equal(d.cpu().view(torch.int32), rd.view(torch.int32))


@pytest.mark.gpu
def test_cuda_kernel_rejects_bad_inputs(cuda_device):
    x = torch.zeros((5, 64), device=cuda_device)
    with pytest.raises(TypeError):
        kernel.compress_blocks(x.double(), 16, 3)
    with pytest.raises(ValueError, match="shape"):
        kernel.compress_blocks(x, 16, 2)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.compress_blocks(torch.zeros((64, 5), device=cuda_device).t(), 16, 3)
    with pytest.raises(ValueError, match="rate"):
        kernel.compress_blocks(x, 33, 3)


@pytest.mark.gpu
def test_cuda_api_matches_torch_backend(cuda_device):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(33, 47, 65)).astype(np.float32)
    c = api.compress(torch.from_numpy(x).to(cuda_device), "zfp", rate=16)
    assert c.to_bytes() == api.compress(x, "zfp", rate=16, backend="torch").to_bytes()
    out = api.decompress(c)
    assert out.device.type == "cuda"
    want = api.decompress(c, backend="torch")
    assert torch.equal(out.cpu().view(torch.int32), want.view(torch.int32))
