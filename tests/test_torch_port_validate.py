"""`python -m map_tpu_torch.validate` on the CPU.

- the five stages run through the Trainer on a tiny synthazu (3,000 rows,
  small vocabularies, a narrow MLP), each stage's line read from its
  metrics.jsonl, both finetunes restoring 13 tensors and skipping 4;
- each stage's flags are `validation/run_tpu.sh`'s, parsed from the script
  by the port's own CLI parser; a finetune reads its source's newest
  checkpoint (`sort -V | tail -1`);
- the verdict is `validation/seed_stats.py`'s mean and std and
  `tests/test_multiseed_parity.py`'s band on fixed numbers;
- the mode and pf-shared stages and their sources are planned in order;
- the MFP run's metrics.jsonl, from which a stage's line is read, has the
  (kind, step) sequence and key sets of map_tpu's for the same run
  (`tests/test_metrics_jsonl.py`; RFD's in `test_torch_port_run_records.py`).
"""

import dataclasses
import json
import math
import os
import re
import shlex
import sys

import pytest
import torch

from map_tpu_torch import validate
from map_tpu_torch.config import parse_args

from test_torch_port_run_records import assert_pretrain_records_match_map_tpus

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def one_thread():
    """One intra-op thread: the tiny stages' many small ops crawl when the
    test workers' thread pools contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_five_stages_run_on_a_tiny_synthazu(tmp_path, capsys, one_thread):
    assert validate.main([
        "--seeds", "42", "--rows", "3000", "--vocab_sizes", "8,8,25,30,24,50,5,60",
        "--batch", "512", "--hidden_size", "64", "--device", "cpu",
        "--output_dir", str(tmp_path)]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    data, stages, rows = lines[0], lines[1:-1], lines[-1]["validate_rows"]
    assert data["rows"] == 3000 and data["num_fields"] == 8 and data["train_rows"] == 2400
    assert [s["stage"] for s in stages] == list(validate.BASE_STAGES)
    by = {s["stage"]: s for s in stages}
    # 2,400 train rows at batch 512: 5 steps an epoch
    assert [by[n]["steps"] for n in validate.BASE_STAGES] == [5, 15, 15, 5, 5]
    assert by["finetune"]["finetune_counts"] == [13, 4]
    assert by["finetune_rfd"]["finetune_counts"] == [13, 4]
    assert by["scratch"]["finetune_counts"] is None
    for s in stages:
        assert math.isfinite(s["metric"]) and math.isfinite(s["loss"])
        run_dir = tmp_path / "s42" / s["stage"]
        assert (s["metric"], s["loss"]) == validate.stage_result(str(run_dir), s["kind"])
        assert (run_dir / "train.log").exists() and (run_dir / "config.json").exists()
    assert 0.0 < by["mfp"]["metric"] < 1.0 and 0.0 < by["rfd"]["metric"] < 1.0
    assert [(r["stage"], r["metric"]) for r in rows] == [
        (st, m) for st in validate.BASE_STAGES for m in validate.METRICS[by[st]["kind"]]]
    assert all(r["within"] is not None for r in rows)


def _run_tpu_flags():
    """{stage: map_tpu's flags} of validation/run_tpu.sh, COMMON included."""
    text = open(os.path.join(ROOT, "validation", "run_tpu.sh")).read()
    subst = {"$DATA": "/data", "$SEED": "42", "${EXTRA:-}": "", "$RUNS": "/runs",
             "$ckpt": "/runs/mfp/12.model"}

    def words(s):
        s = s.replace("\\\n", " ")
        for k, v in subst.items():
            s = s.replace(k, v)
        return shlex.split(s)

    common = words(re.search(r'COMMON="(.*?)"', text, re.S).group(1))
    out = {}
    for name, body in re.findall(r"run_(\w+)\(\) \{\n(.*?)\n\}", text, re.S):
        cmd = body[body.index("python -m map_tpu.run"):]
        out[name] = common + words(cmd.split("$COMMON", 1)[1])
    return out


def test_stage_flags_are_run_tpu_sh(tmp_path):
    flags = _run_tpu_flags()
    assert sorted(flags) == sorted(validate.BASE_STAGES)
    for src in ("mfp", "rfd"):
        os.makedirs(tmp_path / "s42" / src)
        for step in (3, 12, 100):
            if not (src == "mfp" and step == 100):
                (tmp_path / "s42" / src / f"{step}.model").write_bytes(b"")
    skip = {"output_dir", "data_dir", "dataset_name", "pretrained_model_path", "device"}
    for name in validate.BASE_STAGES:
        ref_m, ref_t = parse_args(flags[name])
        got_m, got_t = validate.stage_args(validate.STAGES[name], 42, str(tmp_path))
        assert dataclasses.asdict(got_m) == dataclasses.asdict(ref_m), name
        ref, got = dataclasses.asdict(ref_t), dataclasses.asdict(got_t)
        assert {k: v for k, v in got.items() if k not in skip} == {
            k: v for k, v in ref.items() if k not in skip}, name
    _, t = validate.stage_args(validate.STAGES["finetune"], 42, str(tmp_path))
    assert t.finetune and t.pretrained_model_path.endswith(os.path.join("mfp", "12.model"))
    _, t = validate.stage_args(validate.STAGES["finetune_rfd"], 42, str(tmp_path))
    assert t.pretrained_model_path.endswith(os.path.join("rfd", "100.model"))


def test_verdict_is_seed_stats_rule():
    sys.path.insert(0, os.path.join(ROOT, "validation"))
    try:
        import seed_stats
    finally:
        sys.path.remove(os.path.join(ROOT, "validation"))
    port = [0.7461, 0.7483, 0.7470, 0.7452]
    ref = [0.7480, 0.7466, 0.7478, 0.7472, 0.7460, 0.7490]
    assert validate.mean_std(port) == seed_stats.mean_std(port)
    rmu, rsd = seed_stats.mean_std(ref)
    tmu, tsd = seed_stats.mean_std(port)
    se = math.sqrt(rsd ** 2 / len(ref) + tsd ** 2 / len(port))
    for eps in (0.0, 5e-4, 1e-3):
        v = validate.verdict(port, rmu, rsd, len(ref), eps)
        assert v["delta"] == tmu - rmu and v["two_sigma"] == pytest.approx(2 * se, rel=1e-15)
        assert v["within"] == (abs(tmu - rmu) <= 2 * se + eps)
    assert not validate.verdict([0.740, 0.741], 0.7474, 0.001078, 4, 5e-4)["within"]
    assert validate.verdict([0.7470, 0.7476], 0.7474, 0.001078, 4, 5e-4)["within"]
    # one run: 2 sqrt(s² + s²/n) + eps
    assert validate.single_run_band(0.001078, 4, 5e-4) == pytest.approx(
        2 * math.sqrt(0.001078 ** 2 * 1.25) + 5e-4)
    # MFP: accuracy at twice the eps, n = 8; a pf-shared finetune: its AUC
    # alone against map_tpu's single run; a pf-shared pretraining: no band
    assert validate.reference_rows(validate.STAGES["mfp"]) == [
        (0.728718, 0.002796, 8, 1e-3), (1.376592, 0.007622, 8, 5e-4)]
    assert validate.reference_rows(validate.STAGES["finetune@pf25"]) == [
        (0.744174, 0.001236, 1, 5e-4)]
    assert validate.reference_rows(validate.STAGES["mfp@pf25"]) == []
    rows = validate.table([{"stage": "mfp@pf25", "metric": 0.26, "loss": 3.7},
                           {"stage": "finetune@pf25", "metric": 0.745, "loss": 0.399}],
                          [validate.STAGES["mfp@pf25"], validate.STAGES["finetune@pf25"]])
    assert [(r["metric"], r["within"]) for r in rows] == [
        ("acc", None), ("loss", None), ("test_auc", True), ("logloss", None)]


def test_plan_orders_sources_before_finetunes():
    names = [s.name for s in validate.plan(["finetune", "scratch"], ["matmul", "bwd_pallas"],
                                           pf_shared=True)]
    assert names == ["scratch", "mfp", "mfp@bwd_pallas", "mfp@pf25", "mfp@pf100",
                     "finetune", "finetune@bwd_pallas", "finetune@pf25", "finetune@pf100"]
    st = validate.STAGES
    assert st["mfp@bwd_pallas"].train["hybrid_mode"] == "bwd_pallas"
    assert st["finetune@bwd_pallas"].source == "mfp@bwd_pallas"
    pf = st["mfp@pf100"]
    assert pf.model["pt_neg_num"] == 100 and pf.train["pt_shared_noise"] \
        and pf.train["pt_per_field_noise"] and pf.kind == "mfp"
    with pytest.raises(ValueError):
        validate.plan(["nope"])
    with pytest.raises(ValueError):
        validate.plan([], ["dense"])


def test_mfp_metrics_jsonl_kinds_steps_and_keys(synth_dir, tmp_path):
    assert_pretrain_records_match_map_tpus(synth_dir, tmp_path, "mfp")
