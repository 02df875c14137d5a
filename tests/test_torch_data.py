"""The port's synthetic LM stream (``repro_torch.data``) against the
reference's, on the CPU: the tokens are numpy's from ``SeedSequence([seed,
step])``, so they must equal the reference's bit for bit (tolerance 0),
before and after a ``load_state_dict``."""

import numpy as np
import pytest
import torch

from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLMStream as JStream
from repro.data.pipeline import _batch_tokens as jbatch_tokens
from repro_torch.data import DataConfig, SyntheticLMStream
from repro_torch.data.pipeline import _batch_tokens

CPU = torch.device("cpu")


@pytest.mark.parametrize("vocab,seq,batch,seed", [(512, 16, 4, 7), (151936, 33, 2, 0),
                                                   (256, 1, 1, 3)])
def test_tokens_equal_reference_for_steps_0_to_3(vocab, seq, batch, seed):
    ours = SyntheticLMStream(DataConfig(vocab, seq, batch, seed), CPU)
    theirs = JStream(JDataConfig(vocab, seq, batch, seed))
    for step in range(4):
        np.testing.assert_array_equal(_batch_tokens(ours.cfg, step),
                                      jbatch_tokens(theirs.cfg, step))
        b, jb = ours.next_batch(), theirs.next_batch()
        for k in ("tokens", "labels"):
            assert b[k].dtype == torch.int32 and b[k].device == CPU
            assert tuple(b[k].shape) == (batch, seq)
            np.testing.assert_array_equal(b[k].numpy(), np.asarray(jb[k]))
        assert ours.state_dict() == theirs.state_dict() == {"step": step + 1, "seed": seed}


def test_resume_from_either_package_s_state():
    cfg, jcfg = DataConfig(512, 16, 4, 7), JDataConfig(512, 16, 4, 7)
    a, ja = SyntheticLMStream(cfg, CPU), JStream(jcfg)
    for _ in range(5):
        a.next_batch()
        ja.next_batch()
    b = SyntheticLMStream(cfg, CPU)
    b.load_state_dict(ja.state_dict())
    jb = JStream(jcfg)
    jb.load_state_dict(a.state_dict())
    want = np.asarray(ja.next_batch()["tokens"])
    np.testing.assert_array_equal(b.next_batch()["tokens"].numpy(), want)
    np.testing.assert_array_equal(np.asarray(jb.next_batch()["tokens"]), want)
    np.testing.assert_array_equal(a.next_batch()["tokens"].numpy(), want)


def test_labels_are_the_next_tokens():
    s = SyntheticLMStream(DataConfig(64, 8, 2, 0), CPU)
    b = s.next_batch()
    window = _batch_tokens(s.cfg, 0)
    np.testing.assert_array_equal(b["tokens"].numpy(), window[:, :-1])
    np.testing.assert_array_equal(b["labels"].numpy(), window[:, 1:])
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_seed_mismatch_on_restore_raises_and_iter_yields():
    s = SyntheticLMStream(DataConfig(64, 8, 2, seed=1), CPU)
    with pytest.raises(ValueError, match="seed"):
        s.load_state_dict({"step": 3, "seed": 2})
    it = iter(s)
    first, second = next(it), next(it)
    assert s.state_dict()["step"] == 2
    assert not torch.equal(first["tokens"], second["tokens"])


def test_stream_defaults_to_the_card():
    cfg = DataConfig(64, 8, 2)
    if torch.cuda.is_available():
        assert SyntheticLMStream(cfg).next_batch()["tokens"].is_cuda
        return
    with pytest.raises((RuntimeError, AssertionError)):
        SyntheticLMStream(cfg)
