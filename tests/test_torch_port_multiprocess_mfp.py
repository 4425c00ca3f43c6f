"""Multi-rank runs of the port on the CPU, continued from
`test_torch_port_multiprocess.py` (the same worker and launcher): MFP with
row-sharded tables on a 2 x 2 mesh, and FGCNN's BatchNorm statistics over
the global batch.
"""

import numpy as np

from test_torch_port_multiprocess import (  # noqa: F401  (data_dirs: a fixture)
    _agree,
    batch_flags,
    data_dirs,
    model_flags,
    run_ranks,
)


def test_rowsharded_mfp_2x2_matches_one_rank(data_dirs, tmp_path):
    """MFP on a (data, model) = 2 x 2 mesh, the input table and the NCE
    decoder's emb and bias row-sharded (4 ranks): the eval loss within 2e-5
    and the accuracy within 2e-3 of one rank's; the ranks agree exactly."""
    mfp = model_flags(data_dirs["mfp"], "dnn") + [
        "--pretrain", "--pt_type=MFP", "--sampling_method=randint", "--mask_ratio=0.3",
        "--pt_neg_num=5", "--proj_size=8", "--logging_steps=1000"]
    one = run_ranks(1, mfp + batch_flags(1), tmp_path / "one")[0]
    four = run_ranks(4, mfp + batch_flags(4, data_axis=2) + ["--num_model_shards=2"],
                     tmp_path / "four")
    assert all(r["mesh"] == [2, 2] for r in four)
    _agree(four)
    (loss1, acc1), (loss4, acc4) = one["eval_metrics"][-1], four[0]["eval_metrics"][-1]
    assert abs(loss1 - loss4) < 2e-5 and abs(acc1 - acc4) < 2e-3
    log = open(tmp_path / "four" / "train.log").read()
    assert "table sharding: rows over mesh {'data': 2, 'model': 2}" in log


def test_fgcnn_batchnorm_statistics_over_two_ranks(data_dirs, tmp_path):
    """FGCNN's BatchNorm takes the global batch's statistics: its running
    mean and variance after one step over 2 ranks (the whole train split in
    one padded global batch, the ranks holding unequal real rows) equal one rank's.
    One step: the conv biases before a BatchNorm have a gradient of zero
    up to rounding, which AdamW turns into +-lr, so from the second step
    on the running means (not the normalised outputs) follow that noise."""
    flags = model_flags(data_dirs["mfp"], "fgcnn") + [
        "--num_hidden_layers=1", "--channels=3,4", "--kernel_heights=3,3",
        "--pooling_sizes=2,2", "--recombined_channels=2,2", "--exact_eval_allgather"]
    one = run_ranks(1, flags + batch_flags(1, train=2048), tmp_path / "one")[0]
    two = run_ranks(2, flags + batch_flags(2, train=2048), tmp_path / "two")
    assert one["global_step"] == two[0]["global_step"] == 1
    assert one["bn"] and set(one["bn"]) == set(two[0]["bn"])
    for k, v in one["bn"].items():
        np.testing.assert_allclose(two[0]["bn"][k], v, rtol=1e-5, atol=1e-6)
        assert two[0]["bn"][k] == two[1]["bn"][k]
