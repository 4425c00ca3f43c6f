"""K1's launch plan and list update (`map_tpu_torch/ops/fused_adamw.py`), on
the CPU.

One K1 launch updates a list of leaves: `plan` lays the non-empty leaves'
4-element units end to end, at most MAX_LEAVES leaves a launch, and
`descriptor` packs each leaf's pointers, size, first unit, wd and alignment
for the kernel (`csrc/fused_adamw.cu`). Here the plan is held to what the
kernel's indexing needs: block b, thread t and unit k take unit
b * THREADS * UNITS_PER_THREAD + k * THREADS + t, whose leaf is the last one
starting at or before it, and every element of every leaf is touched by
exactly one unit, whatever the mix of sizes, empty leaves and alignments.
The list-level plain update is held bit for bit to the per-leaf one, and
to map_tpu's `fused_adamw_dense` (interpret mode) within the rounding XLA
adds on the CPU, on a small DCNv2's parameter list with `optimizer.decays`'s
mask.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import base_model_config
from map_tpu.ops.fused_adamw import ROWS_PER_TILE, fused_adamw_dense, pack_scalars
from map_tpu_torch import models
from map_tpu_torch.config import Config
from map_tpu_torch.ops import fused_adamw as k1
from map_tpu_torch.train.optimizer import AdamW, decays
from map_tpu_torch.train.schedules import make_schedule

SIZES = {
    "dcnv2 canonical": [1_013_519 * 16, 384 * 1000, 1000, 1000 * 1000, 1000,
                        1000 * 1000, 1000, 384 * 384, 384, 384 * 384, 384, 384 * 384,
                        384, 1384, 1, 16, 16],
    "odd and empty": [0, 1, 2, 3, 5, 0, 7, 4096, 4097, 0, 33, 1],
    "all empty": [0, 0, 0],
    "one leaf": [37 * 12],
    "64 leaves": list(range(1, 65)),
    "65 leaves": [3] * 65,
    "200 leaves with empties": [(i * 37) % 101 for i in range(200)],
}


def _units(numels, launch):
    """The units the kernel's threads take, and each one's leaf (an index
    into the launch) and first element: csrc/fused_adamw.cu's indexing."""
    per_block = k1.THREADS * k1.UNITS_PER_THREAD
    b, k, t = np.meshgrid(np.arange(launch.blocks), np.arange(k1.UNITS_PER_THREAD),
                          np.arange(k1.THREADS), indexing="ij")
    u = (b * per_block + k * k1.THREADS + t).reshape(-1)
    assert len(np.unique(u)) == u.size
    u = u[u < launch.units]
    leaf = np.searchsorted(np.asarray(launch.starts), u, side="right") - 1
    return u, leaf, (u - np.asarray(launch.starts)[leaf]) * k1.UNIT


@pytest.mark.parametrize("case", sorted(SIZES))
def test_plan_covers_every_element_once(case):
    numels = SIZES[case]
    launches = k1.plan(numels)
    live = [i for i, n in enumerate(numels) if n > 0]
    assert [i for launch in launches for i in launch.leaves] == live
    assert len(launches) == -(-len(live) // k1.MAX_LEAVES)
    for launch in launches:
        assert 1 <= len(launch.leaves) <= k1.MAX_LEAVES
        assert launch.blocks * k1.THREADS * k1.UNITS_PER_THREAD >= launch.units
        assert (launch.blocks - 1) * k1.THREADS * k1.UNITS_PER_THREAD < launch.units
        u, leaf, e0 = _units(numels, launch)
        assert u.size == launch.units
        for j, i in enumerate(launch.leaves):
            # unit e0 takes elements e0 .. e0 + 3 below numel: the leaf's
            # units must start at 0, 4, 8, ... once each
            first = np.sort(e0[leaf == j])
            assert np.array_equal(first, np.arange(0, numels[i], k1.UNIT)), (case, i)


@pytest.mark.parametrize("aligned", ["all", "none", "alternate"])
def test_vector_and_element_paths_split_as_the_kernel_does(aligned):
    # a unit goes as one 16-byte vector where its leaf is aligned and the
    # unit whole; else element by element (csrc/fused_adamw.cu `vec`)
    numels = SIZES["odd and empty"]
    flags = {"all": [True] * len(numels), "none": [False] * len(numels),
             "alternate": [i % 2 == 0 for i in range(len(numels))]}[aligned]
    (launch,) = k1.plan(numels)
    _, leaf, e0 = _units(numels, launch)
    for j, i in enumerate(launch.leaves):
        vec = flags[i] & (e0[leaf == j] + k1.UNIT <= numels[i])
        want = numels[i] // k1.UNIT if flags[i] else 0
        assert int(vec.sum()) == want


@pytest.mark.parametrize("count,max_leaves", [(1, 64), (63, 64), (64, 64), (65, 64),
                                              (129, 64), (10, 3), (7, 1)])
def test_plan_splits_at_the_descriptor_capacity(count, max_leaves):
    numels = [4 * (i + 1) for i in range(count)]
    launches = k1.plan(numels, max_leaves)
    assert len(launches) == -(-count // max_leaves)
    assert all(len(launch.leaves) == min(max_leaves, count - k * max_leaves)
               for k, launch in enumerate(launches))
    for launch in launches:
        assert launch.starts[0] == 0
        ends = [s + numels[i] // k1.UNIT for s, i in zip(launch.starts, launch.leaves)]
        assert list(launch.starts[1:]) == ends[:-1] and ends[-1] == launch.units


def test_descriptor_block_fits_the_kernel_parameter():
    # fused_adamw.cu: Leaf is 56 bytes (start at 40, wd at 48); the block,
    # 48 bytes of scalars, count and units, then MAX_LEAVES leaves, <= 4 KB
    assert k1.LEAF_DTYPE.itemsize == 56
    assert k1.LEAF_DTYPE.fields["start"][1] == 40 and k1.LEAF_DTYPE.fields["wd"][1] == 48
    assert 48 + k1.MAX_LEAVES * k1.LEAF_DTYPE.itemsize <= 4096


def test_descriptor_gives_each_leaf_its_own_pointers_size_and_wd():
    numels = [5, 0, 4096, 3]
    ptrs = [(1000 * i + 1, 1000 * i + 2, 1000 * i + 3, 1000 * i + 4) for i in range(4)]
    wds = [0.1, 0.5, 0.0, 1e-2]
    aligned = [False, True, True, False]
    (launch,) = k1.plan(numels)
    d = k1.descriptor(launch, ptrs, numels, wds, aligned)
    assert d.dtype == k1.LEAF_DTYPE and len(d) == 3
    for row, i in enumerate((0, 2, 3)):
        assert tuple(int(v) for v in (d["p"][row], d["mu"][row], d["nu"][row],
                                      d["g"][row])) == ptrs[i]
        assert d["numel"][row] == numels[i] and d["start"][row] == launch.starts[row]
        assert d["wd"][row] == np.float32(wds[i]) and d["aligned"][row] == aligned[i]


def test_plan_refuses_an_empty_descriptor_block():
    with pytest.raises(ValueError):
        k1.plan([4], max_leaves=0)


def _dcnv2_leaves(seed):
    """A small DCNv2's parameters (a LayerNorm among them), with moments
    and gradients drawn by numpy, and optimizer.decays's mask."""
    cfg = Config.from_dict(base_model_config(embed_norm=True, num_hidden_layers=2,
                                             num_cross_layers=2).to_dict())
    model = models.from_config(cfg, torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    names, ps, mus, nus, gs = [], [], [], [], []
    for name, p in model.named_parameters():
        names.append(name)
        ps.append(p.detach().clone())
        mus.append(torch.from_numpy((rng.normal(size=p.shape) * 1e-2).astype(np.float32)))
        nus.append(torch.from_numpy((rng.random(size=p.shape) * 1e-4).astype(np.float32)))
        gs.append(torch.from_numpy((rng.normal(size=p.shape) * 1e-2).astype(np.float32)))
    return names, ps, mus, nus, gs


def _to_tiles(t):
    """A leaf flattened and zero-padded to (R, 128) with R % 512 == 0:
    fused_adamw_dense's Pallas path."""
    flat = t.reshape(-1).numpy()
    tile = ROWS_PER_TILE * 128
    out = np.zeros(-(-flat.size // tile) * tile, np.float32)
    out[:flat.size] = flat
    return out.reshape(-1, 128)


@pytest.mark.parametrize("count_inc", [1, 3])
def test_list_update_matches_per_leaf_and_map_tpu(count_inc):
    names, ps, mus, nus, gs = _dcnv2_leaves(count_inc)
    mask = [decays(n) for n in names]
    assert not all(mask) and any(mask)  # biases and the LayerNorm's weight take none
    ss = [k1.scalars(1e-3, 0.1 if d else 0.0, 0.9, 0.999, 1e-8, count_inc) for d in mask]
    per_leaf = [[t.clone() for t in leaf] for leaf in zip(ps, mus, nus)]
    for (p, mu, nu), g, s in zip(per_leaf, gs, ss):
        k1.fused_adamw_plain(p, mu, nu, g, s)
    got = [[t.clone() for t in leaf] for leaf in zip(ps, mus, nus)]
    before = k1.launches
    k1.fused_adamw_multi(*([leaf[j] for leaf in got] for j in range(3)), gs, ss)
    assert k1.launches == before  # the CPU route launches nothing
    for name, a, b in zip(names, got, per_leaf):
        assert all(torch.equal(x, y) for x, y in zip(a, b)), name
    # map_tpu's Pallas kernel in interpret mode, leaf by leaf: XLA on the CPU
    # rounds some of the algebra's products and sums in fused operations, so
    # the two agree within a float32 ulp or so, as in test_torch_port_ops.py
    for name, p, mu, nu, g, d, (gp, gmu, gnu) in zip(names, ps, mus, nus, gs, mask, got):
        ref = fused_adamw_dense(*(jnp.asarray(_to_tiles(t)) for t in (p, mu, nu, g)),
                                pack_scalars(1e-3, 0.1 if d else 0.0, 0.9, 0.999, 1e-8,
                                             count_inc), interpret=True)
        for part, a, r in zip(("p", "mu", "nu"), (gp, gmu, gnu), ref):
            np.testing.assert_allclose(a.reshape(-1).numpy(),
                                       np.asarray(r).reshape(-1)[:a.numel()],
                                       rtol=1e-6, atol=1e-9, err_msg=f"{name} {part}")


def test_list_update_refuses_what_one_launch_cannot_take():
    p, mu, nu, g = (torch.zeros(8) for _ in range(4))
    s = k1.scalars(1e-3, 0.1, 0.9, 0.999, 1e-8, 2)
    with pytest.raises(ValueError):  # lr differs: not one launch
        k1.fused_adamw_multi([p, p], [mu, mu], [nu, nu], [g, g], [s, s._replace(lr=2e-3)])
    with pytest.raises(ValueError):
        k1.fused_adamw_multi([p], [mu], [nu, nu], [g], [s])
    k1.fused_adamw_multi([], [], [], [], [])
    # wd alone may differ
    k1.fused_adamw_multi([p, p.clone()], [mu, mu.clone()], [nu, nu.clone()], [g, g],
                         [s, s._replace(wd=0.0)])


def test_optimizer_step_makes_one_list_call():
    names, ps, _, _, gs = _dcnv2_leaves(7)
    params = [torch.nn.Parameter(p) for p in ps]
    calls = []

    def update(ps, mus, nus, grads, wds, scal, slot):
        calls.append(([list(a) for a in (ps, mus, nus, grads, wds)], scal.clone(), slot))
        k1.fused_adamw_leaves(ps, mus, nus, grads, wds, scal, slot)

    opt = AdamW(zip(names, params), make_schedule("const", 1e-3, 0, 10), 0.9, 0.999,
                1e-8, 0.1, update=update)
    opt.count = 6
    opt.step(gs)
    assert len(calls) == 1
    (got_p, _, _, got_g, got_wds), scal, slot = calls[0]
    assert [id(t) for t in got_p] == [id(t) for t in params]
    assert all(torch.equal(a, b) for a, b in zip(got_g, gs))
    assert got_wds == [np.float32(0.1).item() if decays(n) else 0.0 for n in names]
    # the step's scalars, in its slot of the buffer: pack_scalars' row at t = 7
    assert scal[slot].tolist() == list(k1.scalar_row(k1.scalars(1e-3, 0.1, 0.9, 0.999,
                                                                1e-8, 7)))
    assert opt.count == 7
