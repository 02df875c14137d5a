"""The port's ``train_loop`` resuming a run the reference checkpointed, on the
CPU: the reference trains qwen2.5-3b's smoke cut with an exact checkpoint
every 5 steps and a failure injected at step 5; the port restarts on that
directory, restores the reference's leaves and ``extra["data"]``, and
trains on to step 10.  Its tokens are the reference's for steps 5–9 (bit
for bit), its restored state is the checkpoint's (bit for bit), and its
losses stay within 1e-4 of the reference's own restart (five float32
steps, each within ``tests/test_torch_train.py``'s bounds)."""

import shutil

import numpy as np
import pytest

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.data import DataConfig as JDataConfig
from repro.data.pipeline import _batch_tokens as jbatch_tokens
from repro.launch.train import train_loop as jtrain_loop
from repro_torch.checkpoint import manager as ckpt_manager
from repro_torch.core import api
from repro_torch.data import pipeline as data_pipeline
from repro_torch.launch.train import train_loop

STEPS, FAIL_AT = 10, 5
KW = dict(steps=STEPS, batch=4, seq=32, log_every=100)


@pytest.fixture(scope="module")
def cross(tmp_path_factory):
    root = tmp_path_factory.mktemp("cross")
    with pytest.raises(RuntimeError, match="injected failure at step 5"):
        jtrain_loop("qwen2.5-3b", ckpt_dir=str(root / "ck"), ckpt_every=5,
                    inject_failure_at=FAIL_AT, sync_ckpt=True, **KW)
    shutil.copytree(root / "ck", root / "ck_ref")
    jtree, jmanifest = JCheckpointManager(str(root / "ck_ref")).restore(FAIL_AT)
    seen, restored = [], []
    next_batch = data_pipeline.SyntheticLMStream.next_batch
    restore = ckpt_manager.CheckpointManager.restore

    def batch_spy(self):
        step = self.step
        batch = next_batch(self)
        seen.append((step, batch["tokens"].clone(), batch["labels"].clone()))
        return batch

    def restore_spy(self, *args, **kwargs):
        tree, manifest = restore(self, *args, **kwargs)
        restored.append({k: v.clone() for k, v in api.flatten_with_keys(tree, "::")})
        return tree, manifest

    data_pipeline.SyntheticLMStream.next_batch = batch_spy
    ckpt_manager.CheckpointManager.restore = restore_spy
    try:
        out = train_loop("qwen2.5-3b", device="cpu", ckpt_dir=str(root / "ck"), ckpt_every=5,
                         **KW)
    finally:
        data_pipeline.SyntheticLMStream.next_batch = next_batch
        ckpt_manager.CheckpointManager.restore = restore
    ref = jtrain_loop("qwen2.5-3b", ckpt_dir=str(root / "ck_ref"), **KW)
    return {"out": out, "ref": ref, "seen": seen, "restored": restored, "jtree": jtree,
            "jmanifest": jmanifest}


def test_port_resumes_the_reference_s_checkpoint(cross):
    out, ref = cross["out"], cross["ref"]
    assert out["steps_run"] == ref["steps_run"] == STEPS - FAIL_AT and all(out["finite"])
    assert abs(out["first_loss"] - ref["first_loss"]) <= 1e-4
    assert abs(out["last_loss"] - ref["last_loss"]) <= 1e-4


def test_resumed_tokens_come_from_the_checkpoint_s_stream_state(cross):
    assert cross["jmanifest"]["extra"]["data"] == {"step": FAIL_AT, "seed": 0}
    seen = cross["seen"]
    assert [s for s, _t, _l in seen] == list(range(FAIL_AT, STEPS))
    cfg = JDataConfig(vocab=256, seq_len=KW["seq"], global_batch=KW["batch"])
    for step, tokens, labels in seen:
        window = jbatch_tokens(cfg, step)
        np.testing.assert_array_equal(tokens.numpy(), window[:, :-1])
        np.testing.assert_array_equal(labels.numpy(), window[:, 1:])


def test_restored_state_is_the_reference_s_checkpoint(cross):
    """The port's restore of the reference's exact checkpoint, inside its
    ``train_loop``: every leaf bit for bit (params, moments and the int32
    step), as the reference's own restore reads it."""
    (flat,) = cross["restored"]
    want = {k: np.asarray(v) for k, v in cross["jtree"].items()}
    assert flat.keys() == want.keys()
    for k, v in want.items():
        got = flat[k]
        assert str(got.dtype) == f"torch.{v.dtype}" and tuple(got.shape) == v.shape, k
        assert np.array_equal(got.numpy().reshape(-1).view(np.uint8),
                              np.ascontiguousarray(v).reshape(-1).view(np.uint8)), k
    assert int(flat["opt::step"]) == FAIL_AT


def test_state_after_resume_is_on_the_cpu(cross):
    leaves = [x for _k, x in api.flatten_with_keys(cross["out"]["state"])]
    assert all(x.device.type == "cpu" for x in leaves)
    assert int(cross["out"]["state"]["opt"]["step"]) == STEPS
