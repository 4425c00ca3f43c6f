"""map_tpu_torch's field-blocked hybrid lookup and its K6 plain versions
against map_tpu on the CPU.

The same numpy-made inputs go through map_tpu and the port: the field
routing on the Avazu- and Criteo-shaped geometries of `bench.py`, the
hybrid forward (out-of-contract and reserved ids included) and the table
gradient of every backward mode against map_tpu's lane-packed
`hybrid_rows_gather` (its gradient unpacked to (V, E)), the K6 plain
versions against map_tpu's Pallas kernels in interpret mode, and
`build_config`'s rules. On the CPU every port op takes its plain version;
the kernels are held against those on the card by `chip_smoke.py` and
`tests/test_torch_port_cuda.py`.

Tolerances: exact where map_tpu's sum runs in the port's order (the forward,
`fwd`'s flat scatter, the gathers); otherwise 1e-6 (atol and rtol, values
of order 1): map_tpu sums the reserved rows, the one-hot products and its
Pallas kernel's three bf16 passes in other orders than the port.
"""

import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import map_tpu.ops.hybrid_gather as jax_hg
import map_tpu.ops.pallas_field_gather as jax_pfg
from map_tpu import config as jax_config
from map_tpu.data.dataset import CTRDataset as JaxDataset
from map_tpu.ops.packed_table import pack_table, packed_lookup, unpack_table
from map_tpu_torch.config import ModelArguments, TrainingArguments, build_config
from map_tpu_torch.data.dataset import field_blocked_ok
from map_tpu_torch.ops import field_gather, hybrid_gather

E = 16
PACK = 8
NRESV = 10
AVAZU = [7, 7, 24, 26, 4100, 7600, 26, 8500, 560, 36, 8200, 5, 4, 2600, 8, 450, 70,
         170, 60, 101_000, 380_000, 500_000, 30, 26]
CRITEO = [45, 50, 60, 40, 35, 80, 55, 100, 65, 30, 90, 70, 50, 1400, 550, 180_000,
          110_000, 300, 20, 12_000, 600, 3, 48_000, 5200, 150_000, 3100, 26, 10_000,
          90_000, 10, 4300, 2000, 4, 120_000, 15, 15, 45_000, 70, 35_000]


def _bounds(sizes, lo=NRESV):
    out = []
    for s in sizes:
        out.append((lo, lo + s))
        lo += s
    return tuple(out)


# ---- routing ---------------------------------------------------------------------

@pytest.mark.parametrize("case", ["avazu", "criteo", "all_small", "all_big",
                                  "below_nresv", "descending"])
@pytest.mark.parametrize("pack", [1, PACK])
def test_field_groups_match_map_tpu(case, pack):
    bounds = {"avazu": _bounds(AVAZU), "criteo": _bounds(CRITEO),
              "all_small": _bounds([5, 300, 16_384]),
              "all_big": _bounds([20_000, 16_385]),
              "below_nresv": ((3, 9), (9, 40), (40, 90_000)),
              "descending": ((500, 600), (10, 500), (600, 700_000))}[case]
    got = hybrid_gather.field_groups(bounds, pack, NRESV)
    assert got == jax_hg.field_groups(bounds, pack, NRESV)
    if case == "avazu" and pack == 1:
        small, big = got
        assert len(small) == 21 and big == (19, 20, 21)
        assert sum(hi - lo for _, lo, hi, _, _ in small) == 32_509
        utiles, _ = field_gather.plan_pairs(tuple((p, s[3], s[4]) for p, s in
                                                  enumerate(small)), 1_013_519)
        assert len(utiles) == 65 and utiles[-1] == 1979  # the ragged last tile


def test_mode_resolution_matches_map_tpu(monkeypatch):
    monkeypatch.delenv("MAP_TPU_HYBRID_MODE", raising=False)
    assert hybrid_gather.resolve_mode("") == jax_hg._resolve_mode("") == "fwd"
    monkeypatch.setenv("MAP_TPU_HYBRID_MODE", "both")
    assert hybrid_gather.resolve_mode(None) == jax_hg._resolve_mode(None) == "both"
    assert hybrid_gather.resolve_mode("matmul") == "matmul"
    for resolve in (hybrid_gather.resolve_mode, jax_hg._resolve_mode):
        with pytest.raises(ValueError, match="unknown hybrid mode"):
            resolve("bwd-pallas")
    assert hybrid_gather.MODES == jax_hg._VALID_MODES
    assert hybrid_gather.SMALL_FIELD_MAX == jax_hg.SMALL_FIELD_MAX


# ---- the lookup against map_tpu's packed hybrid_rows_gather ------------------------

def _case(seed=0, b=48):
    """Small and big fields (one exactly SMALL_FIELD_MAX ids), reserved ids
    and out-of-contract ids (another field's block) in every column."""
    rng = np.random.default_rng(seed)
    bounds = _bounds([7, 24, 300, 5000, hybrid_gather.SMALL_FIELD_MAX, 40_000])
    v = bounds[-1][1] + 3
    ids = np.stack([rng.integers(a, h, b) for a, h in bounds], axis=1)
    resv = rng.random(ids.shape) < 0.1
    ids[resv] = rng.integers(0, NRESV, resv.sum())
    stray = rng.random(ids.shape) < 0.05
    ids[stray] = rng.integers(NRESV, v, stray.sum())
    table = rng.normal(size=(v, E)).astype(np.float32)
    cot = rng.normal(size=(b, len(bounds), E)).astype(np.float32)
    return bounds, ids.astype(np.int32), table, cot


def _map_tpu_lookup(bounds, ids, table, cot, mode):
    """map_tpu's packed lookup -> (rows (B, F, E), table gradient (V, E))."""
    v = table.shape[0]
    packed = pack_table(jnp.asarray(table), E)
    f = functools.partial(packed_lookup, ids=jnp.asarray(ids), embed_size=E,
                          field_bounds=bounds, hybrid_mode=mode, nresv=NRESV)
    rows = f(packed)
    grad = jax.grad(lambda p: jnp.sum(f(p) * jnp.asarray(cot)))(packed)
    return np.asarray(rows), np.asarray(unpack_table(grad, v, E))


@pytest.mark.parametrize("mode", sorted(hybrid_gather.MODES))
def test_lookup_and_table_grad_match_map_tpu(mode, monkeypatch):
    bounds, ids, table, cot = _case()
    if mode == "bwd_pallas":
        # map_tpu's TPU route (tests/test_hybrid_gather.py), its kernel in
        # interpret mode
        monkeypatch.setattr(jax_hg, "_on_tpu", lambda: True)
        monkeypatch.setattr(jax_pfg, "field_block_scatter", functools.partial(
            jax_pfg.field_block_scatter, interpret=True))
    ref_rows, ref_grad = _map_tpu_lookup(bounds, ids, table, cot, mode)
    t = torch.from_numpy(table).requires_grad_()
    rows = hybrid_gather.hybrid_lookup(t, torch.from_numpy(ids), bounds, NRESV, mode)
    np.testing.assert_array_equal(rows.detach().numpy(), ref_rows)
    (rows * torch.from_numpy(cot)).sum().backward()
    if mode == "fwd":
        np.testing.assert_array_equal(t.grad.numpy(), ref_grad)
    else:
        np.testing.assert_allclose(t.grad.numpy(), ref_grad, rtol=1e-6, atol=1e-6)
    # the modes differ only where the contract is broken: stray ids are
    # zeroed forward (but `bwd`) and scattered back by `fwd` alone
    small, _ = hybrid_gather.field_groups(bounds)
    lo = np.full(len(bounds), -1)
    hi = np.full(len(bounds), 2 ** 31)
    for fi, a, h, _, _ in small:
        lo[fi], hi[fi] = a, h
    stray = ~((ids >= lo) & (ids < hi)) & (ids >= NRESV)
    assert stray.any()
    zeroed = (rows.detach().numpy() == 0).all(-1)
    assert (zeroed[stray] == (mode != "bwd")).all()


def test_bf16_cotangent_is_summed_in_f32():
    bounds, ids, table, cot = _case(seed=1)
    cot16 = torch.from_numpy(cot).bfloat16()
    grads = {}
    for mode in ("fwd", "bwd_pallas", "matmul"):
        t = torch.from_numpy(table).requires_grad_()
        rows = hybrid_gather.hybrid_lookup(t, torch.from_numpy(ids), bounds, NRESV, mode,
                                           torch.bfloat16)
        assert rows.dtype == torch.bfloat16
        rows.backward(cot16)
        grads[mode] = t.grad
    ref = hybrid_gather.table_grad(torch.from_numpy(ids), cot16.float(), len(table),
                                   bounds, NRESV, "bwd_pallas")
    assert torch.equal(grads["bwd_pallas"], ref)
    torch.testing.assert_close(grads["matmul"], ref, rtol=1e-6, atol=1e-6)


# ---- K6's plain versions against map_tpu's kernels in interpret mode --------------

R_K6, B_K6 = 4096, 96


def _k6_case(w, seed=0):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(R_K6, w)).astype(np.float32)
    # windows: two fields in one tile, one across tiles, one at the tail
    small = ((0, 10, 40), (1, 40, 300), (2, 600, 1400), (3, 3900, R_K6))
    phys = np.stack([rng.integers(plo, pe, B_K6) for _, plo, pe in small])
    phys[rng.random(phys.shape) < 0.1] = -1
    # an id outside its window but inside one of its field's tiles counts
    phys[1, :3] = [5, 311, 511]
    g = rng.normal(size=(B_K6, len(small) * w)).astype(np.float32)
    return table, small, phys.astype(np.int32), g


@pytest.mark.parametrize("w", [16, 128])
def test_field_block_gather_plain_matches_map_tpu(w):
    table, small, phys, _ = _k6_case(w)
    ref = jax_pfg.field_block_gather(jnp.asarray(table), jnp.asarray(phys), small, R_K6,
                                     interpret=True)
    got = field_gather.field_block_gather(torch.from_numpy(table),
                                          torch.from_numpy(phys), small, R_K6)
    assert got.shape == ref.shape == (B_K6, len(small) * w)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("w", [16, 128])
def test_field_block_scatter_plain_matches_map_tpu(w):
    _, small, phys, g = _k6_case(w, seed=1)
    ref = jax_pfg.field_block_scatter(jnp.asarray(g), jnp.asarray(phys), small, R_K6,
                                      interpret=True)
    got = field_gather.field_block_scatter(torch.from_numpy(g), torch.from_numpy(phys),
                                           small, R_K6)
    assert got.shape == ref.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    utiles, pairs = field_gather.plan_pairs(small, R_K6)
    assert (utiles, pairs) == jax_pfg.plan_pairs(small, R_K6)
    dense = field_gather.assemble_dense(got, utiles, R_K6)
    np.testing.assert_array_equal(
        dense.numpy(), np.asarray(jax_pfg.assemble_dense(jnp.asarray(got.numpy()),
                                                         utiles, R_K6)))
    base = torch.from_numpy(np.random.default_rng(2).normal(size=(R_K6, w)).astype(
        np.float32))
    added = field_gather.field_block_scatter_add(base.clone(), torch.from_numpy(g),
                                                 torch.from_numpy(phys), small)
    assert torch.equal(added, base + dense)


def test_field_block_scatter_sums_each_row_in_order_on_a_ragged_last_tile():
    # an unpadded table: the last tile runs past R, which map_tpu's plan
    # refuses and the port's allows
    r, w, b = 1300, 8, 200
    small = ((0, 20, 30), (1, 30, 1100), (2, 1290, r))
    with pytest.raises(AssertionError):
        jax_pfg.plan_pairs(small, r)
    utiles, pairs = field_gather.plan_pairs(small, r)
    assert utiles == (0, 1, 2) and len(pairs) == 5
    rng = np.random.default_rng(3)
    phys = np.stack([rng.integers(plo, pe, b) for _, plo, pe in small]).astype(np.int32)
    phys[0, ::7] = -1
    g = torch.from_numpy((rng.normal(size=(b, 3 * w)) * 10.0 ** rng.integers(
        -4, 4, (b, 1))).astype(np.float32))
    got = field_gather.assemble_dense(
        field_gather.field_block_scatter(g, torch.from_numpy(phys), small, r), utiles, r)
    want = torch.zeros(r, w)
    for pos in range(3):  # one row at a time, in order of b
        for bb in range(b):
            if phys[pos, bb] >= 0:
                want[phys[pos, bb]] += g[bb, pos * w:(pos + 1) * w]
    assert torch.equal(got, want)
    rows = field_gather.field_block_gather(want, torch.from_numpy(phys), small, r)
    assert torch.equal(rows[:, 2 * w:], want[phys[2].astype(np.int64)])


# ---- build_config's rules --------------------------------------------------------

def _dataset(blocked=True):
    lo = np.asarray([10, 17, 41], np.int32)
    hi = np.asarray([17, 41, 5000], np.int32)
    if not blocked:
        lo[1] = 12  # overlaps field 0's block
    return SimpleNamespace(
        feat_map=dict.fromkeys(range(5000)), field_map=dict.fromkeys(range(4)),
        input_size=5000, num_fields=3, feat_count=np.ones(5000, np.float32),
        idx_low=lo, idx_high=hi, feat_num_per_field=hi - lo,
        field_blocked_ok=field_blocked_ok(lo, hi))


@pytest.mark.parametrize("pt,replace,mode,blocked,want", [
    ("", "Unigram", "", True, (True, "")),
    ("MFP", "Unigram", "", True, (True, "matmul")),
    ("MFP", "Unigram", "bwd_pallas", True, (True, "bwd_pallas")),
    ("RFD", "Unigram", "", True, (True, "")),
    ("RFD", "Uniform", "bwd_pallas", True, (True, "bwd_pallas")),
    ("RFD", "Whole-Uniform", "", True, (False, "")),
    ("RFD", "Whole-Unigram", "", True, (False, "")),
    ("MFP", "Unigram", "", False, (False, "")),
])
def test_build_config_rules_match_map_tpu(pt, replace, mode, blocked, want):
    ds = _dataset(blocked)
    flags = dict(pretrain=bool(pt), pt_type=pt or "MFP", RFD_replace=replace,
                 hybrid_mode=mode)
    cfg = build_config(ModelArguments(), TrainingArguments(**flags), ds)
    ref = jax_config.build_config(jax_config.ModelArguments(),
                                  jax_config.TrainingArguments(**flags), ds)
    assert (cfg.field_blocked_lookup, cfg.hybrid_mode) == want
    assert (ref.field_blocked_lookup, ref.hybrid_mode) == want
    assert cfg.RFD_replace == ref.RFD_replace == replace


@pytest.mark.parametrize("lo,hi", [
    ([10, 17, 41], [17, 41, 90]), ([9, 17, 41], [17, 41, 90]),
    ([10, 16, 41], [17, 41, 90]), ([41, 10, 17], [90, 17, 41])])
def test_field_blocked_ok_matches_map_tpu(lo, hi):
    ref = JaxDataset.__new__(JaxDataset)
    ref.idx_low, ref.idx_high = np.asarray(lo, np.int32), np.asarray(hi, np.int32)
    ref._derive_field_invariants()
    assert field_blocked_ok(np.asarray(lo), np.asarray(hi)) == ref.field_blocked_ok
