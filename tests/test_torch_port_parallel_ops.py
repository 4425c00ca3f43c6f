"""The port's row-sharded exchange (`map_tpu_torch/parallel/`) against
map_tpu's (`map_tpu/parallel/embedding.py`) on the 8-device CPU mesh.

The port's shard-local primitives run once per shard in one process, each
shard on a thread of its own; a thread group stands in for the model
group's all_reduce (each collective sums the shards' tensors in shard
order). Forward and gradients are held to map_tpu's at 1e-6 in float32, and
hotcold's counters must equal map_tpu's `with_stats`. Also: which
parameters are tables in every model, the hot-row lists against map_tpu's
`Trainer._build_hot_rows`, and the uneven last block (V not divisible by
the shards) against a plain gather.
"""

import threading
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from map_tpu.parallel import embedding as jax_pe
from map_tpu.parallel.mesh import build_mesh as jax_build_mesh
from map_tpu.train.trainer import Trainer as JaxTrainer
from map_tpu_torch import models
from map_tpu_torch.config import Config, TrainingArguments
from map_tpu_torch.ops.dedup_scatter import sort_and_fold
from map_tpu_torch.parallel import embedding as pe
from map_tpu_torch.parallel.mesh import Group, Mesh
from map_tpu_torch.parallel.sharding import (
    SHARD_ATTR,
    gather_tables,
    is_vocab_table,
    shard_rows,
    shard_tables,
    slice_tables,
)
from map_tpu_torch.train.optimizer import build_optimizer
from map_tpu_torch.train.trainer import Trainer

from conftest import base_model_config

ATOL = 1e-6


class ThreadGroup:
    """In-process stand-in for a model group of `size` shards, one thread
    each: a collective sums every shard's tensor in shard order."""

    def __init__(self, size: int):
        self.size = size
        self._barrier = threading.Barrier(size)
        self._slots = [None] * size

    def member(self, index: int) -> "Member":
        return Member(self, index)


class Member:
    def __init__(self, group: ThreadGroup, index: int):
        self.g, self.index, self.size = group, index, group.size
        self.ranks, self.active, self.backend = list(range(group.size)), True, "threads"

    def all_reduce_(self, t):
        self.g._slots[self.index] = t.detach().clone()
        self.g._barrier.wait()
        total = self.g._slots[0].clone()
        for x in self.g._slots[1:]:
            total += x
        self.g._barrier.wait()
        return t.copy_(total)

    def all_gather(self, t):
        self.g._slots[self.index] = t.detach().clone()
        self.g._barrier.wait()
        out = torch.stack(self.g._slots)
        self.g._barrier.wait()
        return out

    def barrier(self):
        self.g._barrier.wait()


def run_shards(num: int, fn):
    """fn(member, index) on `num` threads -> their results, in shard order."""
    group, results, errors = ThreadGroup(num), [None] * num, []

    def body(i):
        try:
            results[i] = fn(group.member(i), i)
        except BaseException as e:  # re-raised below
            errors.append(e)
            group._barrier.abort()

    threads = [threading.Thread(target=body, args=(i,)) for i in range(num)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results


def block_of(table: np.ndarray, num: int, index: int, grad: bool = True):
    s = shard_rows(table.shape[0], num, index)
    p = torch.nn.Parameter(torch.from_numpy(table[s.lo:s.lo + s.rows].copy()),
                           requires_grad=grad)
    setattr(p, SHARD_ATTR, s)
    return p


def _stream(v=4096, w=16, n=512, hot_frac=0.5, seed=0):
    """map_tpu's `test_hotcold_exchange._mk`: half the ids from a hot set."""
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((v, w)).astype(np.float32)
    hot_rows = np.unique(rng.integers(0, v // 8, 64)).astype(np.int32)
    n_hot = int(n * hot_frac)
    ids = np.concatenate([rng.choice(hot_rows, n_hot),
                          rng.integers(0, v, n - n_hot)]).astype(np.int32)
    rng.shuffle(ids)
    return table, ids.reshape(-1, 8), np.sort(hot_rows)


def _jax_mesh(model_shards):
    return jax_build_mesh(1, model_shards, devices=jax.devices()[:model_shards])


def _port_lookup(table, ids, cot, num, lookup):
    """Each shard's output (the same on all) and the table gradient put
    together from the blocks."""
    def shard(member, i):
        p = block_of(table, num, i)
        out = lookup(p, torch.from_numpy(ids), member)
        stats = None
        if isinstance(out, tuple):
            out, stats = out
        (out * torch.from_numpy(cot)).sum().backward()
        return out.detach().numpy(), p.grad.numpy(), stats

    res = run_shards(num, shard)
    return [r[0] for r in res], np.concatenate([r[1] for r in res]), [r[2] for r in res]


def _jax_grad(fn, table, cot):
    return np.asarray(jax.jit(jax.grad(lambda t: jnp.sum(fn(t) * cot)))(jnp.asarray(table)))


@pytest.mark.parametrize("num", [2, 4])
def test_sharded_lookup_matches_map_tpu(num):
    mesh = _jax_mesh(num)
    table, ids, _ = _stream(seed=1)
    cot = np.random.default_rng(2).standard_normal(ids.shape + (16,)).astype(np.float32)
    lookup = lambda t: jax_pe.sharded_embedding_lookup(t, jnp.asarray(ids), mesh)  # noqa: E731
    want = np.asarray(jax.jit(lookup)(jnp.asarray(table)))
    want_g = _jax_grad(lookup, table, cot)
    outs, grad, _ = _port_lookup(table, ids, cot, num,
                                 lambda p, i, m: pe.sharded_embedding_lookup(p, i, m))
    for out in outs:
        np.testing.assert_allclose(out, want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(grad, want_g, rtol=0, atol=ATOL)


@pytest.mark.parametrize("cap_frac", [1.5, 0.02])  # 0.02 forces the overflow path
def test_hotcold_matches_map_tpu(cap_frac):
    num = 4
    mesh = _jax_mesh(num)
    table, ids, hot = _stream(n=1024, seed=5)
    cot = np.random.default_rng(3).standard_normal(ids.shape + (16,)).astype(np.float32)
    want, stats = jax.jit(lambda t, i: jax_pe.hotcold_embedding_lookup(
        t, i, mesh, hot, capacity_frac=cap_frac, with_stats=True))(
        jnp.asarray(table), jnp.asarray(ids))
    want_g = _jax_grad(lambda t: jax_pe.hotcold_embedding_lookup(
        t, jnp.asarray(ids), mesh, hot, capacity_frac=cap_frac), table, cot)
    hot_t = torch.from_numpy(hot)
    outs, grad, port_stats = _port_lookup(
        table, ids, cot, num, lambda p, i, m: pe.hotcold_embedding_lookup(
            p, i, m, hot_t, capacity_frac=cap_frac, with_stats=True))
    for out in outs:
        np.testing.assert_allclose(out, np.asarray(want), rtol=0, atol=ATOL)
    np.testing.assert_allclose(grad, want_g, rtol=0, atol=ATOL)
    for i, st in enumerate(port_stats):
        assert int(st["total_overflow"]) == int(np.asarray(stats["total_overflow"])[0])
        np.testing.assert_array_equal(st["seg_counts"].numpy(),
                                      np.asarray(stats["seg_counts"])[0])
        assert int(st["seg_count"]) == int(np.asarray(stats["seg_counts"])[0][i])
        assert int(st["num_cold"]) == int(np.asarray(stats["num_cold"])[0])
        assert st["capacity"] == stats["capacity"] and st["n"] == stats["n_per_data_shard"]
    if cap_frac == 0.02:
        assert int(port_stats[0]["total_overflow"]) > 0
    else:
        assert int(port_stats[0]["total_overflow"]) == 0
        assert int(port_stats[0]["seg_counts"].sum()) == int(port_stats[0]["num_cold"])


def test_hotcold_matches_psum_exchange_bit_for_bit():
    table, ids, hot = _stream(v=1024, seed=3)
    hot_t = torch.from_numpy(hot)
    with torch.no_grad():
        a = run_shards(2, lambda m, i: pe.sharded_embedding_lookup(
            block_of(table, 2, i, False), torch.from_numpy(ids), m).numpy())
        b = run_shards(2, lambda m, i: pe.hotcold_embedding_lookup(
            block_of(table, 2, i, False), torch.from_numpy(ids), m, hot_t).numpy())
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[0], table[ids])


@pytest.mark.parametrize("num", [2, 4])
def test_decoder_rows_gather_and_scatter_match_map_tpu(num):
    mesh = _jax_mesh(num)
    rng = np.random.default_rng(7)
    v, w, n = 1024, 33, 700
    table = rng.standard_normal((v, w)).astype(np.float32)
    ids = rng.integers(0, v, n).astype(np.int32)
    want = np.asarray(jax.jit(lambda t, i: jax_pe.sharded_rows_gather(t, i, mesh))(
        jnp.asarray(table), jnp.asarray(ids)))
    with torch.no_grad():
        got = run_shards(num, lambda m, i: pe.sharded_rows_gather(
            block_of(table, num, i, False), torch.from_numpy(ids), m).numpy())
    for g in got:
        np.testing.assert_allclose(g, want, rtol=0, atol=ATOL)
    # the folded decoder stream: sorted unique ids, sentinels v behind them
    grads = torch.from_numpy(rng.standard_normal((n, w)).astype(np.float32))
    uids, vals, _ = sort_and_fold(torch.from_numpy(ids), grads, v)
    want_s = np.asarray(jax.jit(lambda u, x: jax_pe.sharded_rows_scatter_add(
        u, x, v, mesh))(jnp.asarray(uids.numpy()), jnp.asarray(vals.numpy())))
    blocks = [pe.sharded_rows_scatter_add(uids, vals, shard_rows(v, num, i))[0]
              for i in range(num)]
    np.testing.assert_allclose(torch.cat(blocks).numpy(), want_s, rtol=0, atol=ATOL)
    e_blocks = [pe.sharded_rows_scatter_add(uids, vals, shard_rows(v, num, i),
                                            widths=(w - 1, 1)) for i in range(num)]
    np.testing.assert_array_equal(torch.cat([b[0] for b in e_blocks]).numpy(),
                                  torch.cat(blocks).numpy()[:, :w - 1])


@pytest.mark.parametrize("v,num", [(1001, 4), (1003, 2), (1000, 3)])
def test_uneven_last_block(v, num):
    """Blocks of ceil(V / M) rows, the last shorter: every exchange gives
    the plain gather and the plain table gradient, bit for bit."""
    rng = np.random.default_rng(v)
    table = rng.standard_normal((v, 8)).astype(np.float32)
    ids = rng.integers(0, v, (40, 6)).astype(np.int32)
    ids[0, :num] = v - 1 - np.arange(num)  # the last block's rows
    cot = rng.standard_normal(ids.shape + (8,)).astype(np.float32)
    shards = [shard_rows(v, num, i) for i in range(num)]
    assert shards[-1].rows < shards[0].rows and sum(s.rows for s in shards) == v
    ref = torch.from_numpy(table).requires_grad_()
    (ref[torch.from_numpy(ids).long()] * torch.from_numpy(cot)).sum().backward()
    hot = torch.from_numpy(np.arange(0, v, 7, dtype=np.int32))
    for lookup in (lambda p, i, m: pe.sharded_embedding_lookup(p, i, m),
                   lambda p, i, m: pe.hotcold_embedding_lookup(p, i, m, hot),
                   lambda p, i, m: pe.hotcold_embedding_lookup(p, i, m, hot, 0.01)):
        outs, grad, _ = _port_lookup(table, ids, cot, num, lookup)
        np.testing.assert_array_equal(outs[0], table[ids])
        np.testing.assert_array_equal(grad, ref.grad.numpy())
    # a state dict of blocks goes whole and back
    full = {"t": torch.from_numpy(table), "b": torch.ones(3)}
    cut = [slice_tables(full, {"t": s}) for s in shards]
    whole = run_shards(num, lambda m, i: gather_tables(cut[i], {"t": shards[i]}, m))
    for w in whole:
        assert torch.equal(w["t"], full["t"]) and torch.equal(w["b"], full["b"])


ZOO = {"lr": {}, "fm": {}, "dnn": {}, "deepfm": {}, "dcnv2": {},
       "xdeepfm": dict(use_lr=True), "autoint": {}, "trans": dict(hidden_size=16),
       "fgcnn": dict(share_embedding=False), "fignn": {}}
PRETRAIN = ("dnn", "deepfm", "dcnv2", "xdeepfm", "autoint", "trans", "fgcnn", "fignn")


@pytest.mark.parametrize("name,pretrain", [(n, False) for n in ZOO]
                         + [(n, True) for n in PRETRAIN])
def test_every_table_of_every_model_is_sharded(name, pretrain):
    """map_tpu `test_sharding.py:154` on the port: the tables are exactly
    the parameters of V rows (the input embedding, FGCNN's `fg_embed`, the
    LR table, the NCE emb and bias), each becomes a block of ceil(V / M)
    rows under shard_tables, and its AdamW moments take the block's shape."""
    v = 600
    cfg = base_model_config(model_name=name, input_size=v, num_fields=8, embed_size=16,
                            **ZOO[name])
    d = cfg.to_dict()
    if pretrain:
        d.update(pretrain=True, pt_type="MFP", proj_size=8, pt_neg_num=5)
    port_cfg = Config.from_dict(d)
    if pretrain:
        port_cfg.feat_count = np.ones(v, np.float32)
    model = models.from_config(port_cfg)
    params = dict(model.named_parameters())
    tables = {k for k, p in params.items() if is_vocab_table(k, p.shape)}
    assert tables == {k for k, p in params.items() if p.dim() == 2 and p.shape[0] == v}
    assert any(k.endswith("embedding.weight") or k.endswith("embed_w.weight")
               for k in tables)
    if pretrain:
        assert {"mfp_criterion.emb.weight", "mfp_criterion.bias.weight"} <= tables
    if name == "fgcnn":
        assert "fg_embed.embedding.weight" in tables
    solo = Group([0, 1], 1)
    shards = shard_tables(model, Mesh(1, 2, 1, solo, solo, solo))
    assert set(shards) == tables
    params = dict(model.named_parameters())
    for k in tables:
        assert getattr(params[k], SHARD_ATTR) == shards[k] == shard_rows(v, 2, 1)
        assert params[k].shape[0] == 300
    targs = TrainingArguments(output_dir="", steps_per_call=1)
    opt, _ = build_optimizer(model, targs, 10, 0)
    for n, p, m in zip(opt.names, opt.params, opt.mu):
        assert m.shape == p.shape, n


def test_build_hot_rows_matches_map_tpu():
    """The port's `_build_hot_rows` is map_tpu's at pack factor 1 (one list,
    keyed by V, for every table)."""
    lo = [10, 40, 45, 300, 310]
    hi = [40, 45, 300, 310, 600]
    cfg = Config(model_name="dcnv2", input_size=600, num_fields=5, embed_size=16,
                 idx_low=lo, idx_high=hi, pretrain=True, pt_type="MFP", proj_size=8)
    for r in (4, 512):
        args = SimpleNamespace(hot_rows_per_field=r)
        jax_self = SimpleNamespace(config=SimpleNamespace(
            idx_low=lo, idx_high=hi, input_size=600, embed_size=16, proj_size=8,
            packed_tables=False, pretrain=True, pt_type="MFP"), args=args)
        want = JaxTrainer._build_hot_rows(jax_self)
        got = Trainer._build_hot_rows(SimpleNamespace(config=cfg, args=args))
        assert set(got) == set(want) == {600}
        np.testing.assert_array_equal(got[600], want[600])
        assert got[600].dtype == np.int32 and np.all(np.diff(got[600]) > 0)
    cfg.idx_low = None
    assert Trainer._build_hot_rows(SimpleNamespace(config=cfg, args=args)) == {}
