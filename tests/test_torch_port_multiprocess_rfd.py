"""Multi-rank runs of the port on the CPU, continued from
`test_torch_port_multiprocess.py` (the same worker and launcher): RFD
pretraining data-parallel over 2 gloo ranks against one rank. Each rank
draws the global batch's masked positions and replacements from the shared
generator and keeps its own rows: a flat (B * M,) draw (`Uniform`), a
(B, M) one (`Whole-Uniform`), and the loader's noise rows (`Unigram`).
"""

import pytest

from test_torch_port_multiprocess import (  # noqa: F401  (data_dirs: a fixture)
    _agree,
    batch_flags,
    data_dirs,
    model_flags,
    run_ranks,
)


@pytest.mark.parametrize("replace", ["Unigram", "Uniform", "Whole-Uniform"])
def test_data_parallel_rfd_matches_one_rank(data_dirs, tmp_path, replace):
    """RFD on a 2 x 1 mesh, 3 of the 6 fields masked a row (a ratio of 0.3
    masks one, where a flat draw and a per-row one slice alike): the eval
    loss within 2e-5 and the accuracy within 2e-3 of one rank's (the
    tolerances of the MFP case), the ranks agree exactly."""
    rfd = model_flags(data_dirs["mfp"]) + [
        "--pretrain", "--pt_type=RFD", f"--RFD_replace={replace}",
        "--sampling_method=randint", "--mask_ratio=0.5", "--proj_size=8",
        "--logging_steps=1000"]
    one = run_ranks(1, rfd + batch_flags(1), tmp_path / "one")[0]
    two = run_ranks(2, rfd + batch_flags(2), tmp_path / "two")
    assert all(r["mesh"] == [2, 1] for r in two)
    _agree(two)
    (loss1, acc1), (loss2, acc2) = one["eval_metrics"][-1][:2], two[0]["eval_metrics"][-1][:2]
    assert abs(loss1 - loss2) < 2e-5 and abs(acc1 - acc2) < 2e-3
