"""The two MFP items that sit on the canonical MFP path, on the CPU.

- The masked-position selection (`models/base.py:SelectMasked`): the
  forward is `torch.gather`'s, bit for bit; the backward adds the M slots'
  gradients slot by slot, so a field a row masks three or more times
  (`randint`) gets the same float32 sum in the same order on every run:
  bit-equal to that running sum, and within float64 rounding of the exact
  one. (Two graph-path MFP runs from one seed end bit-equal on the card:
  `tests/test_torch_port_cuda.py`, `chip_smoke.py`.)
- The port's alias draws against q: 10^5 draws of the global draw
  (`alias.alias_draw_logq`) and of the per-field one
  (`per_field_alias_draw_logq`) on synthazu's unigram, a chi-square with
  the buckets expected below 5 draws pooled, p > 1e-3 at a fixed seed; each
  draw's log q is the table's. `chi_square_p` against scipy's.
"""

import numpy as np
import pytest
import scipy.stats
import torch

from map_tpu_torch.data import synth
from map_tpu_torch.models.base import SelectMasked
from map_tpu_torch.objectives import alias

DRAWS = 100_000


def _positions(rng, b, f, m):
    idx = rng.integers(0, f, (b, m))
    idx[:8] = 2  # rows that mask one field M times
    idx[8:16, :3] = 5
    return torch.from_numpy(idx)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_select_masked_backward_sums_slot_by_slot(dtype):
    rng = np.random.default_rng(0)
    b, f, m, p = 64, 8, 7, 5
    enc = torch.from_numpy(rng.standard_normal((b, f, p))).to(dtype).requires_grad_()
    idx = _positions(rng, b, f, m)
    out = SelectMasked.apply(enc, idx)
    ref = torch.gather(enc, 1, idx[..., None].expand(-1, -1, p))
    assert torch.equal(out, ref)
    g = torch.from_numpy(rng.standard_normal((b, m, p)) * 10.0 ** rng.integers(-4, 4, (b, m, 1))
                         ).to(dtype)
    (grad,) = torch.autograd.grad(out, enc, g)
    running = np.zeros((b, f, p), g.numpy().dtype)
    for j in range(m):  # slot by slot, in the gradient's dtype
        running[np.arange(b), idx[:, j].numpy()] += g[:, j].numpy()
    np.testing.assert_array_equal(grad.numpy(), running)
    exact = np.zeros((b, f, p))
    np.add.at(exact, (np.arange(b)[:, None], idx.numpy()), g.double().numpy())
    np.testing.assert_allclose(grad.double().numpy(), exact, rtol=1e-5, atol=1e-5)
    (again,) = torch.autograd.grad(SelectMasked.apply(enc, idx), enc, g)
    assert torch.equal(again, grad)


def test_select_masked_under_inference_mode():
    enc = torch.randn(4, 6, 3)
    idx = torch.tensor([[0, 0, 5], [1, 2, 1], [3, 3, 3], [5, 4, 0]])
    with torch.inference_mode():
        out = SelectMasked.apply(enc, idx)
    assert torch.equal(out, enc[torch.arange(4)[:, None], idx])


@pytest.fixture(scope="module")
def unigram():
    data = synth.in_memory(synth.generate_realistic_arrays(num_rows=20_000, seed=7),
                           pretrain=True)
    return data


def test_global_alias_draws_follow_q(unigram):
    probs, logprob, _ = alias.noise_log_prior(unigram.feat_count)
    prob, alias_ids = alias.build_alias_table(probs)
    fused = torch.from_numpy(alias.build_fused_alias(prob, alias_ids, logprob))
    gen = torch.Generator().manual_seed(42)
    ids, logq = alias.alias_draw_logq(gen, fused, (DRAWS // 100, 4, 25))
    ids = ids.reshape(-1).numpy()
    assert (logq.reshape(-1).numpy() == logprob[ids]).all()
    stat, dof = alias.chi_square(np.bincount(ids, minlength=len(probs)), probs)
    p = alias.chi_square_p(stat, dof)
    assert p > 1e-3, (stat, dof, p)
    assert p == pytest.approx(scipy.stats.chi2.sf(stat, dof), abs=2e-3)


def test_per_field_alias_draws_follow_each_fields_q(unigram):
    d = unigram
    prob, alias_ids, logprob, _ = alias.build_per_field_alias(d.feat_count, d.idx_low,
                                                             d.idx_high)
    fused = torch.from_numpy(alias.build_fused_alias(prob, alias_ids, logprob))
    low = torch.tensor(d.idx_low, dtype=torch.int32)
    sizes = torch.tensor(d.idx_high, dtype=torch.int32) - low
    nf = d.num_fields
    fields = torch.arange(nf).repeat_interleave(DRAWS // nf // 25)
    gen = torch.Generator().manual_seed(43)
    ids, logq = alias.per_field_alias_draw_logq(gen, fused, low, sizes, fields, 25)
    assert (logq.numpy() == logprob[ids.numpy()]).all()
    stat = dof = 0
    for f in range(nf):
        lo, hi = d.idx_low[f], d.idx_high[f]
        got = ids[fields == f].reshape(-1).numpy()
        assert ((got >= lo) & (got < hi)).all(), f
        s, k = alias.chi_square(np.bincount(got - lo, minlength=hi - lo),
                                alias.noise_distribution(d.feat_count[lo:hi]))
        stat, dof = stat + s, dof + k
    p = alias.chi_square_p(stat, dof)
    assert p > 1e-3, (stat, dof, p)


def test_chi_square_sees_a_wrong_distribution(unigram):
    probs, _, _ = alias.noise_log_prior(unigram.feat_count)
    rng = np.random.default_rng(0)
    skewed = probs * np.where(np.arange(len(probs)) % 2, 1.1, 0.9)
    draws = rng.choice(len(probs), DRAWS, p=skewed / skewed.sum())
    stat, dof = alias.chi_square(np.bincount(draws, minlength=len(probs)), probs)
    assert alias.chi_square_p(stat, dof) < 1e-3  # the bound the draws above pass
