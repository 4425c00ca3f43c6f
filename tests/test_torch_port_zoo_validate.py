"""`python -m map_tpu_torch.validate --model NAME` on the CPU, and the
zoo probe's lockstep of both Trainers.

- each of the nine other models runs its stages end to end through the
  Trainer on a tiny synthazu (1,000 rows, small vocabularies, a narrow
  MLP): the rows parsed, each stage's steps, the finetunes restoring the
  backbone and skipping the pretraining head's 4 tensors; LR and FM run
  `scratch` alone and refuse every pretraining stage, as map_tpu's models
  refuse `--pretrain`;
- every (model, stage) pair that `validate.plan` yields has its row of
  map_tpu's CPU band (`MAP_TPU_ZOO_CPU_BAND`), at least seeds 42-45;
- `tests/torch_port_zoo_probe.py`'s lockstep (both Trainers from map_tpu's
  initial weights on the same host batches, the port handed map_tpu's
  draws) for each kind of stage, supervised, MFP and RFD, and a finetune
  from map_tpu's lockstep checkpoint: the final eval metric and loss and
  every per-step loss within 1e-5 of map_tpu's;
- a fault the zoo's stages met on the card: a CUDA graph held by a dead
  reference cycle, freed by the collector inside another graph's capture,
  invalidated that capture; a capture now collects first and holds the
  collector off (`graph.no_collection`), checked here with a stand-in for
  the capture.
"""

import contextlib
import gc
import json
import weakref

import pytest
import torch

from map_tpu_torch import validate

VOCABS = "8,8,25,30,24,50,5,60"


@pytest.fixture
def one_thread():
    """One intra-op thread: the tiny stages' many small ops crawl when the
    test workers' thread pools contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("model", list(validate.ZOO_KNOBS))
def test_model_stages_run_on_a_tiny_synthazu(model, tmp_path, capsys, one_thread):
    assert validate.main([
        "--model", model, "--seeds", "42", "--rows", "1000", "--vocab_sizes", VOCABS,
        "--batch", "400", "--hidden_size", "16", "--device", "cpu",
        "--output_dir", str(tmp_path)]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    data, stages, rows = lines[0], lines[1:-1], lines[-1]
    assert data["rows"] == 1000 and data["num_fields"] == 8 and data["train_rows"] == 800
    names = list(validate.model_stages(model))
    assert [s["stage"] for s in stages] == names
    assert all(s["model"] == model for s in stages)
    by = {s["stage"]: s for s in stages}
    # 800 train rows at batch 400: 2 steps an epoch, 3 epochs of pretraining
    steps = {"scratch": 2, "mfp": 6, "rfd": 6, "finetune": 2, "finetune_rfd": 2}
    assert [by[n]["steps"] for n in names] == [steps[n] for n in names]
    for name in ("finetune", "finetune_rfd"):
        if name in by:
            loaded, skipped = by[name]["finetune_counts"]
            assert loaded > 0 and skipped == 4
    assert rows["model"] == model
    assert [(r["stage"], r["metric"]) for r in rows["validate_rows"]] == [
        (n, m) for n in names for m in validate.METRICS[validate.STAGES[n].kind]]


@pytest.mark.parametrize("model", validate.SUPERVISED_ONLY)
@pytest.mark.parametrize("stage", ["mfp", "rfd", "finetune", "finetune_rfd"])
def test_lr_and_fm_refuse_pretraining(model, stage):
    assert validate.model_stages(model) == ("scratch",)
    with pytest.raises(ValueError, match=f"{model.upper()} is not pretrain-capable"):
        validate.plan([stage], model=model)
    with pytest.raises(ValueError, match="not pretrain-capable"):
        validate.plan(["scratch"], ["matmul"], model=model)


def test_unknown_model_is_refused():
    with pytest.raises(ValueError, match="not one of"):
        validate.plan(["scratch"], model="pnn")


@pytest.mark.parametrize("model", list(validate.ZOO_KNOBS))
def test_every_planned_pair_has_a_band_row(model):
    bands = validate.MAP_TPU_ZOO_CPU_BAND[model]
    for stage in validate.plan(validate.model_stages(model), model=model):
        refs = validate.reference_rows(stage, bands)
        assert len(refs) == 2, (model, stage.name)
        for mean, std, n, eps in refs:
            # seeds 42-45, or more where a pair was taken further (42-45 kept)
            assert n >= 4 and std > 0 and eps in (validate.EPS, 2 * validate.EPS)
            assert mean == mean  # not nan
    assert set(bands) == set(validate.model_stages(model))


def test_zoo_knobs_are_model_arguments():
    from map_tpu_torch.config import ModelArguments

    for model in validate.MODELS:
        margs = ModelArguments(**validate.model_flags(model))
        assert margs.model_name == model
    assert validate.model_flags("trans")["hidden_size"] == validate.COMMON_MODEL["embed_size"]
    assert validate.ZOO_KNOBS["autoint"]["attn_probs_dropout_rate"] == 0.1


@pytest.fixture(scope="module")
def tiny_data(tmp_path_factory):
    from map_tpu_torch.data import synth

    d = tmp_path_factory.mktemp("synthazu")
    synth.generate_realistic(str(d), name="synthazu", num_rows=1000, seed=validate.DATA_SEED,
                             vocab_sizes=[int(v) for v in VOCABS.split(",")])
    return str(d)


@pytest.fixture(scope="module")
def lockstep_lines(tiny_data, tmp_path_factory):
    """The probe's lockstep of DNN's five stages at seed 42 (narrow MLP)."""
    import torch_port_zoo_probe as probe

    out = str(tmp_path_factory.mktemp("lockstep"))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return {s.name: probe.lockstep_stage(
                    "dnn", s.name, 42, tiny_data, out,
                    dict(hidden_size=16, num_hidden_layers=2, per_device_train_batch_size=400,
                         per_device_eval_batch_size=400))
                for s in validate.plan(validate.BASE_STAGES)}
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("stage", validate.BASE_STAGES)
def test_lockstep_of_both_trainers_within_1e_5(stage, lockstep_lines):
    r = lockstep_lines[stage]
    assert r["steps"][0] == r["steps"][1] == (2 if validate.STAGES[stage].kind == "supervised"
                                              else 6)
    assert r["max_step_gap"] <= 1e-5, r
    assert abs(r["d_metric"]) <= 1e-5 and abs(r["d_loss"]) <= 1e-5, r
    if validate.STAGES[stage].source:
        # the port restored map_tpu's checkpoint of the source stage
        loaded, skipped = r["finetune_counts"]
        assert loaded > 0 and skipped == 4


def test_a_capture_collects_first_and_holds_the_collector_off(monkeypatch):
    """`GraphedCalls._capture` with a stand-in for `torch.cuda.graph`: a dead
    reference cycle (standing for an old Trainer's graphs) is freed before
    the capture begins, and the collector is off while it runs and on
    after it."""
    from map_tpu_torch.train.graph import GraphedCalls

    events = []

    class Graph:
        def register_generator_state(self, generator):
            pass

    @contextlib.contextmanager
    def capture(graph):
        events.append(("capture", gc.isenabled()))
        yield
        events.append(("end", gc.isenabled()))

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph", capture)

    class Held:
        pass

    dead = Held()
    dead.cycle = dead
    weakref.finalize(dead, events.append, ("freed", None))
    del dead
    assert gc.isenabled()
    calls = GraphedCalls(lambda b: {"y": b["x"] * 2}, 2, "cpu")
    captured = calls._capture(2, {"x": torch.ones(2, 3)})
    assert events == [("freed", None), ("capture", False), ("end", False)]
    assert gc.isenabled()
    assert captured.outputs["y"].shape == (2, 3)  # the calls ran on the static inputs
