"""Checkpoints of row-sharded runs (map_tpu `tests/test_restore_sharding.py`
on the port): a run on a (1, 2) mesh, its tables split over 2 gloo ranks,
saves the same `{step}.model` and `resume.state` (moments included) as one
rank; and restore (the test pass), finetune and resume cut a whole save to
the mesh that loads it, whichever mesh wrote it.
"""

import shutil

import numpy as np
import pytest
import torch

from map_tpu_torch.data import synth
from map_tpu_torch.data.dataset import CTRDataset
from map_tpu_torch.train import checkpoints

from test_torch_port_multiprocess import _agree, batch_flags, model_flags, run_ranks

ROWS = ["--num_model_shards=2"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A 1-rank run of 2 epochs; and 1-rank and (1, 2)-mesh runs stopped
    after their first epoch, the resume state written at its last step."""
    root = tmp_path_factory.mktemp("ckpt")
    data = str(root / "data")
    synth.generate(data, name="synth", num_rows=1500, num_fields=6, vocab_per_field=30,
                   seed=11)
    per_epoch = -(-len(CTRDataset(data, "synth").Y["train"]) // 128)
    flags = model_flags(data) + ["--num_train_epochs=2", "--exact_eval_allgather",
                                 f"--save_steps={per_epoch}", "--logging_steps=1000"]
    out = {"flags": flags, "root": root, "per_epoch": per_epoch}
    out["straight"] = run_ranks(1, flags + batch_flags(1), root / "straight")[0]
    out["killed1"] = run_ranks(1, flags + batch_flags(1) + ["--stop_after_epochs", "1"],
                               root / "killed1")[0]
    out["killed2"] = run_ranks(2, flags + batch_flags(1) + ROWS
                               + ["--stop_after_epochs", "1"], root / "killed2")
    return out


def _model_files(d):
    return sorted(p.name for p in d.iterdir() if p.name.endswith(".model"))


def test_sharded_save_equals_unsharded_save(runs):
    root = runs["root"]
    assert _model_files(root / "killed1") == _model_files(root / "killed2") != []
    for name in _model_files(root / "killed1"):
        a = torch.load(root / "killed1" / name, weights_only=True)
        b = torch.load(root / "killed2" / name, weights_only=True)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].shape == b[k].shape and torch.equal(a[k], b[k]), k
    sa, ma = checkpoints.load_train_state(str(root / "killed1"))
    sb, mb = checkpoints.load_train_state(str(root / "killed2"))
    assert ma == mb and ma["global_step"] == runs["per_epoch"]
    assert sa["optimizer"]["names"] == sb["optimizer"]["names"]
    for k in ("mu", "nu"):
        for x, y in zip(sa["optimizer"][k], sb["optimizer"][k]):
            assert torch.equal(x, y)
    for k in sa["model"]:
        assert torch.equal(sa["model"][k], sb["model"][k]), k
    v = sa["model"]["embed.embedding.weight"].shape[0]
    assert sa["optimizer"]["mu"][sa["optimizer"]["names"].index(
        "embed.embedding.weight")].shape[0] == v  # the moments whole too
    np.testing.assert_allclose(runs["killed2"][0]["eval_metrics"],
                               runs["killed1"]["eval_metrics"], rtol=0, atol=1e-9)


@pytest.mark.parametrize("writer,ranks", [("killed2", 1), ("killed1", 2)])
def test_resume_reshards_to_the_loading_mesh(runs, tmp_path, writer, ranks):
    """A resume state written on one mesh resumes on the other: the run
    ends where the 2-epoch run did (the evals after the resume point, the
    test pass included; the state was written at the first epoch's last
    step, before that epoch's eval, which a resumed run does not repeat)."""
    shutil.copy(runs["root"] / writer / "resume.state", tmp_path / "resume.state")
    flags = runs["flags"] + batch_flags(1) + (ROWS if ranks == 2 else []) + ["--resume"]
    got = run_ranks(ranks, flags, tmp_path)
    want = runs["straight"]["eval_metrics"]
    assert len(got[0]["eval_metrics"]) == len(want) - 1
    np.testing.assert_allclose(got[0]["eval_metrics"], want[1:], rtol=0, atol=1e-9)
    _agree(got)
    assert got[0]["global_step"] == runs["straight"]["global_step"]


def test_finetune_reshards(runs, tmp_path):
    """Finetune from a whole checkpoint under a (1, 2) mesh gives the
    1-rank finetune's evals."""
    src = runs["root"] / "killed1" / _model_files(runs["root"] / "killed1")[-1]
    flags = runs["flags"] + batch_flags(1) + ["--num_train_epochs=1", "--finetune",
                                             f"--pretrained_model_path={src}"]
    one = run_ranks(1, flags, tmp_path / "one")[0]
    two = run_ranks(2, flags + ROWS, tmp_path / "two")
    np.testing.assert_allclose(two[0]["eval_metrics"], one["eval_metrics"], rtol=0,
                               atol=1e-9)
    log = open(tmp_path / "two" / "train.log").read()
    assert "finetune restore: " in log and "table sharding: rows" in log
