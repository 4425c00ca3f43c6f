"""map_tpu_torch CUDA kernels against their plain versions, on the card.

Marked `cuda`: each test skips without a CUDA device. On a machine with one
(and without JAX) run them as
    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py -q
Shapes here are the awkward ones (odd batch, ragged D, E not a multiple of
4, empty and all-duplicate id segments, a last tile running past the
table); chip_smoke.py holds the same kernels at the serving and training
shapes. The last cases capture each train step kind into CUDA graphs
(`train/graph.py`) and hold them to eager steps bit for bit, with draws
that move on from replay to replay; then a resumed run to the straight one
on the graph path, the checkpoint writer's device snapshot to a sync save,
and the streaming eval's histograms to the CPU's; MFP's masked-position
selection (its backward the CPU's slot-order sum; two 'randint' runs
bit-equal), the grouped eval passes' graphs to the eager passes, and the
pipelined Predictor to an eager forward, bit for bit.
"""

import dataclasses

import pytest
import torch

from map_tpu_torch import models
from map_tpu_torch.config import Config
from map_tpu_torch.ops import (
    cross,
    dedup_scatter,
    embedding,
    field_gather,
    fused_adamw,
    hybrid_gather,
    scan,
    scatter,
    scatter_unique,
    sparse_adamw,
)
from map_tpu_torch.objectives.supervised import bce_loss

pytestmark = pytest.mark.cuda

TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2e-2, 2e-2)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _gather_twice(table, ids, out_dtype):
    """K4 twice, one launch each, and its plain version: (out, again, ref)."""
    before = embedding.launches
    out = embedding.embedding_lookup(table, ids, out_dtype)
    again = embedding.embedding_lookup(table, ids, out_dtype)
    assert embedding.launches == before + 2
    ref = embedding.embedding_lookup_plain(table, ids, out_dtype)
    torch.cuda.synchronize()
    return out, again, ref


@pytest.mark.parametrize("e", [16, 12, 1, 64, 32])
@pytest.mark.parametrize("out_dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("shape", [(37, 5), (1,), (31,), (33,), (4097,)])
def test_gather_is_exact(dev, e, out_dtype, shape):
    """Every width, both dtypes, n off a chunk: bit-equal to the plain
    version, the same bits twice; ids 0 and V - 1 at the ends."""
    g = torch.Generator().manual_seed(e)
    table = torch.randn(1001, e, generator=g).to(dev)
    ids = torch.randint(0, 1001, shape, generator=g, dtype=torch.int32)
    ids.view(-1)[0], ids.view(-1)[-1] = 1000, 0
    out, again, ref = _gather_twice(table, ids.to(dev), out_dtype)
    assert out.shape == (*shape, e)
    assert out.dtype == ref.dtype and torch.equal(out, ref) and torch.equal(out, again)


@pytest.mark.parametrize("out_dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("e", [16, 32])
def test_gather_at_the_decoder_shape(dev, out_dtype, e):
    """The MFP per-position candidates, (4096, 7, 26) = 745,472 ids, into a
    1,013,519-row table (the decoder's at E = 32): bit-equal, twice."""
    g = torch.Generator().manual_seed(7)
    table = torch.randn(1_013_519, e, generator=g).to(dev)
    ids = torch.randint(0, 1_013_519, (4096, 7, 26), generator=g, dtype=torch.int32).to(dev)
    out, again, ref = _gather_twice(table, ids, out_dtype)
    assert torch.equal(out, ref) and torch.equal(out, again)


@pytest.mark.parametrize("e", [16, 32, 12])
@pytest.mark.parametrize("out_dtype", [None, torch.bfloat16])
def test_gather_one_hot_row(dev, e, out_dtype):
    """All ids equal (every lane on one row), and all at V - 1."""
    table = torch.randn(500, e, generator=torch.Generator().manual_seed(e)).to(dev)
    for v in (17, 499):
        ids = torch.full((4097,), v, dtype=torch.int32, device=dev)
        out, again, ref = _gather_twice(table, ids, out_dtype)
        assert torch.equal(out, ref) and torch.equal(out, again)
        assert torch.equal(out[-1], ref[0])


@pytest.mark.parametrize("e", [16, 32])
@pytest.mark.parametrize("out_dtype", [None, torch.bfloat16])
def test_gather_unaligned_table_takes_the_scalar_path(dev, e, out_dtype):
    """A table view one element off 16 bytes: the scalar path, bit-equal."""
    buf = torch.randn(300 * e + 1, generator=torch.Generator().manual_seed(e)).to(dev)
    table = buf[1:].view(300, e)
    assert table.is_contiguous() and table.data_ptr() % 16 == 4
    ids = torch.randint(0, 300, (33, 3), generator=torch.Generator().manual_seed(1),
                        dtype=torch.int32).to(dev)
    assert embedding.plan(ids.numel(), e, out_dtype == torch.bfloat16, False).vec == 0
    out, again, ref = _gather_twice(table, ids, out_dtype)
    assert torch.equal(out, ref) and torch.equal(out, again)


def test_gather_entry_refuses_a_plan_that_does_not_fit(dev):
    from map_tpu_torch.kernels import build

    table = torch.randn(64, 16, device=dev)
    ids = torch.zeros(40, dtype=torch.int32, device=dev)
    out = torch.empty(40, 16, device=dev)
    lib = build.library()
    stream = torch.cuda.current_stream().cuda_stream
    args = (table.data_ptr(), ids.data_ptr(), out.data_ptr(), 40, 16)
    # (out_bf16, vec, units_a_thread, blocks): vec 8 with f32 out, 0 and 3
    # units a thread, no blocks and too many; then an unaligned table, and
    # vec not dividing E
    for bad in ((0, 8, 1, 1), (0, 4, 0, 1), (0, 4, 3, 1), (1, 8, 1, 0), (0, 4, 2, 65536)):
        assert lib.map_tpu_embedding_gather(*args, *bad, stream) != 0
    assert lib.map_tpu_embedding_gather(table.data_ptr() + 4, *args[1:], 0, 4, 1, 1,
                                        stream) != 0
    assert lib.map_tpu_embedding_gather(table.data_ptr(), ids.data_ptr(), out.data_ptr(),
                                        40, 12, 1, 8, 1, 1, stream) != 0
    assert lib.map_tpu_embedding_gather(*args, 0, 4, 2, 1, stream) == 0
    torch.cuda.synchronize()
    assert torch.equal(out, table[ids.long()])


def test_gather_rejects_what_it_does_not_take(dev):
    table = torch.randn(10, 16, device=dev)
    with pytest.raises(ValueError):
        embedding.embedding_lookup(table, torch.zeros(3, dtype=torch.int64, device=dev))
    with pytest.raises(ValueError):
        embedding.embedding_lookup(table.double(),
                                   torch.zeros(3, dtype=torch.int32, device=dev))
    # a table that needs a gradient goes through K4 forward and K3 backward
    out = embedding.embedding_lookup(table.requires_grad_(),
                                     torch.zeros(3, dtype=torch.int32, device=dev))
    assert out.grad_fn is not None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch,d,layers", [(37, 40, 2), (130, 384, 3),
                                            (1, 624, 1), (200, 1000, 2),
                                            (19, 37, 3), (70, 100, 2),
                                            # the training call; batches off the 64-row tile
                                            (4096, 384, 3), (1, 384, 3), (63, 384, 3),
                                            (65, 384, 3), (4097, 384, 3),
                                            # Criteo's ragged width, the widest cluster
                                            (1000, 624, 3), (300, 1024, 3),
                                            # one layer (the config's default) over
                                            # many clusters of 3 and 6 blocks
                                            (4096, 384, 1), (10000, 768, 1)])
def test_cross_matches_plain(dev, dtype, batch, d, layers):
    g = torch.Generator().manual_seed(batch + d)
    x0 = (torch.randn(batch, d, generator=g) * 0.3).to(dev, dtype)
    w = (torch.randn(layers, d, d, generator=g) / d ** 0.5).to(dev, dtype)
    b = (torch.randn(layers, d, generator=g) * 0.1).to(dev, dtype)
    before = cross.launches
    y, xs, us = cross.cross_net(x0, w, b, save_residuals=True)
    assert cross.launches == before + 1
    y_ref, xs_ref, us_ref = cross.cross_net_plain(x0, w, b, save_residuals=True)
    atol, rtol = TOL[dtype]
    for got, ref in ((y, y_ref), (xs, xs_ref), (us, us_ref)):
        assert got.dtype == dtype and got.shape == ref.shape
        torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=rtol)
    # the same bits again, with and without the residuals
    torch.testing.assert_close(cross.cross_net(x0, w, b), y, atol=0, rtol=0)
    for got, again in zip((y, xs, us), cross.cross_net(x0, w, b, save_residuals=True)):
        assert torch.equal(got, again)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [128, 384])
@pytest.mark.parametrize("unaligned", ["w", "x0"])
def test_cross_reads_unaligned_weights(dev, dtype, d, unaligned):
    # w (or x0) starts one element into its buffer: not 16-byte aligned, so
    # the kernel takes its element-by-element path (no TMA, no 16-byte copies)
    g = torch.Generator().manual_seed(3)
    layers = 2
    shift = lambda t: torch.cat([t.reshape(-1)[:1], t.reshape(-1)])[1:].view(t.shape)  # noqa: E731
    x0 = (torch.randn(50, d, generator=g) * 0.3).to(dev, dtype)
    w = (torch.randn(layers, d, d, generator=g) / d ** 0.5).to(dev, dtype)
    if unaligned == "w":
        w = shift(w)
    else:
        x0 = shift(x0)
    moved = w if unaligned == "w" else x0
    assert moved.is_contiguous() and moved.data_ptr() % 16 != 0
    assert not cross.plan(50, d, dtype, aligned=False).vector
    b = (torch.randn(layers, d, generator=g) * 0.1).to(dev, dtype)
    atol, rtol = TOL[dtype]
    y, xs, us = cross.cross_net(x0, w, b, save_residuals=True)
    for got, ref in zip((y, xs, us), cross.cross_net_plain(x0, w, b, save_residuals=True)):
        torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=rtol)
    assert torch.equal(cross.cross_net(x0, w, b), y)


def test_cross_rejects_what_it_does_not_take(dev):
    x0 = torch.randn(8, 32, device=dev)
    w = torch.randn(2, 32, 32, device=dev)
    b = torch.randn(2, 32, device=dev)
    with pytest.raises(ValueError):
        cross.cross_net(x0, w.bfloat16(), b)
    with pytest.raises(ValueError):
        cross.cross_net(x0.t(), w, b)
    with pytest.raises(ValueError):
        cross.cross_net(x0, w[:, :16], b)
    # a D past the widest cluster: the plan refuses it, nothing runs
    before = cross.launches
    wide = torch.randn(4, 1025, device=dev)
    with pytest.raises(ValueError):
        cross.cross_net(wide, torch.randn(1, 1025, 1025, device=dev),
                        torch.randn(1, 1025, device=dev))
    assert cross.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cross_entry_refuses_a_plan_that_does_not_fit(dev, dtype):
    # the C entry checks the plan against the shapes and returns the CUDA
    # error, which the wrapper raises; no output is written
    from map_tpu_torch.kernels import build

    x0 = torch.randn(100, 384, device=dev, dtype=dtype)
    w = torch.randn(3, 384, 384, device=dev, dtype=dtype)
    b = torch.randn(3, 384, device=dev, dtype=dtype)
    y = torch.full_like(x0, 7.0)
    p = cross.plan(100, 384, dtype)
    bad = (p._replace(cluster=2), p._replace(grid=p.grid + 1), p._replace(smem=1024),
           p._replace(stages=1))
    for q in bad:
        status = build.library().map_tpu_cross_net(
            x0.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), None, None,
            torch.empty(2, 100, 384, device=dev, dtype=dtype).data_ptr(), 100, 384, 3,
            int(dtype == torch.bfloat16), q.tile_rows, q.cluster, q.grid, q.smem,
            q.stages, q.x_buffers, int(q.vector),
            torch.cuda.current_stream().cuda_stream)
        with pytest.raises(RuntimeError):
            build.check_status(status, "cross_net")
    torch.cuda.synchronize()
    assert bool((y == 7.0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cross_backward_at_the_training_call(dev, dtype):
    # one K2 launch a forward under autograd; the gradients are the chain of
    # cross_net_backward on the plain forward's residuals
    g = torch.Generator().manual_seed(11)
    x0 = (torch.randn(4096, 384, generator=g) * 0.3).to(dev, dtype)
    w = (torch.randn(3, 384, 384, generator=g) / 384 ** 0.5).to(dev, dtype)
    b = (torch.randn(3, 384, generator=g) * 0.1).to(dev, dtype)
    cot = (torch.randn(4096, 384, generator=g) * 0.1).to(dev, dtype)
    leaves = [t.clone().requires_grad_() for t in (x0, w, b)]
    before = cross.launches
    cross.cross_net(*leaves).backward(cot)
    assert cross.launches == before + 1
    with torch.no_grad():
        _, xs, us = cross.cross_net_plain(x0, w, b, save_residuals=True)
        ref = cross.cross_net_backward(x0, w, xs, us, cot)
    atol, rtol = TOL[dtype]
    for leaf, r in zip(leaves, ref):
        torch.testing.assert_close(leaf.grad.float(), r.float(), atol=atol, rtol=rtol)


# ---- K1: fused AdamW ---------------------------------------------------------

def _adam_state(shape, seed, dev):
    g = torch.Generator().manual_seed(seed)
    p = torch.randn(shape, generator=g)
    mu = torch.randn(shape, generator=g) * 1e-2
    nu = torch.rand(shape, generator=g) * 1e-4
    grad = torch.randn(shape, generator=g) * 1e-2
    return [t.to(dev) for t in (p, mu, nu, grad)]


@pytest.mark.parametrize("shape", [(1,), (7,), (1001, 1), (37, 12), (1013, 16),
                                   (1000, 384), (3, 64)])
@pytest.mark.parametrize("wd", [0.1, 0.0])
def test_adamw_matches_plain(dev, shape, wd):
    p, mu, nu, grad = _adam_state(shape, sum(shape), dev)
    s = fused_adamw.scalars(1e-3, wd, 0.9, 0.999, 1e-8, 3)
    ref = [t.clone() for t in (p, mu, nu)]
    fused_adamw.fused_adamw_plain(*ref, grad, s)
    before = fused_adamw.launches
    fused_adamw.fused_adamw(p, mu, nu, grad, s)
    assert fused_adamw.launches == before + 1
    for got, want in zip((p, mu, nu), ref):
        # every operation rounds on its own in both, in the same order
        torch.testing.assert_close(got, want, atol=1e-9, rtol=1e-6)


def test_adamw_unaligned_takes_the_scalar_path(dev):
    # each tensor starts one element into its buffer: not 16-byte aligned
    bufs = _adam_state((4 * 1000 + 1,), 5, dev)
    p, mu, nu, grad = (b[1:] for b in bufs)
    assert p.data_ptr() % 16 != 0
    s = fused_adamw.scalars(1e-3, 0.1, 0.9, 0.999, 1e-8, 1)
    ref = [t.clone() for t in (p, mu, nu)]
    fused_adamw.fused_adamw_plain(*ref, grad, s)
    fused_adamw.fused_adamw(p, mu, nu, grad, s)
    for got, want in zip((p, mu, nu), ref):
        torch.testing.assert_close(got, want, atol=1e-9, rtol=1e-6)
    assert bufs[0][0].item() == _adam_state((4 * 1000 + 1,), 5, "cpu")[0][0].item()


def test_adamw_rejects_what_it_does_not_take(dev):
    p, mu, nu, grad = _adam_state((64, 8), 1, dev)
    s = fused_adamw.scalars(1e-3, 0.1, 0.9, 0.999, 1e-8, 1)
    with pytest.raises(ValueError):
        fused_adamw.fused_adamw(p.double(), mu, nu, grad, s)
    with pytest.raises(ValueError):
        fused_adamw.fused_adamw(p, mu, nu, grad.cpu(), s)
    with pytest.raises(ValueError):
        fused_adamw.fused_adamw(p.t(), mu.t(), nu.t(), grad.t(), s)
    with pytest.raises(ValueError):
        fused_adamw.fused_adamw(p, mu, nu, grad[:32], s)


def _dcnv2_adam_lists(dev, seed):
    """A canonical-width DCNv2's parameter list (24 fields, embed 16, MLP
    3 x 1000, 3 cross layers, a vocabulary cut to 100,003 ids), with
    moments and gradients, and per-leaf scalars by optimizer.decays."""
    from map_tpu_torch.train.optimizer import decays

    cfg = Config(model_name="dcnv2", input_size=100_003, num_fields=24, embed_size=16,
                 hidden_size=1000, num_hidden_layers=3, hidden_act="relu",
                 num_cross_layers=3)
    model = models.from_config(cfg, torch.Generator().manual_seed(seed))
    names, ps = zip(*[(n, p.detach()) for n, p in model.named_parameters()])
    state = [_adam_state(p.shape, seed + i, dev) for i, p in enumerate(ps)]
    ps = [p.to(dev) for p in ps]
    ss = [fused_adamw.scalars(1e-3, 0.1 if decays(n) else 0.0, 0.9, 0.999, 1e-8, 5)
          for n in names]
    return ps, [s[1] for s in state], [s[2] for s in state], [s[3] for s in state], ss


def _adam_list_case(kind, dev):
    """(ps, mus, nus, gs, scalars, launches the list takes)"""
    if kind == "dcnv2":
        *lists, ss = _dcnv2_adam_lists(dev, 3)
        return (*lists, ss, 1)
    sizes = {"many leaves": [(i * 97) % 1031 + 1 for i in range(150)],
             "unaligned among aligned": [4096, 1001, 16, 4 * 1000 + 1, 7, 384],
             "an empty leaf": [64, 0, 13, 0, 4096]}[kind]
    leaves = [_adam_state((n,), 11 + i, dev) for i, n in enumerate(sizes)]
    if kind == "unaligned among aligned":
        # leaf 3 starts one element into its buffers: not 16-byte aligned
        leaves[3] = [t[1:] for t in leaves[3]]
        assert leaves[3][0].data_ptr() % 16 != 0
    ss = [fused_adamw.scalars(1e-3, 0.1 if i % 3 else 0.0, 0.9, 0.999, 1e-8, 2)
          for i in range(len(leaves))]
    expect = -(-sum(n > 0 for n in sizes) // fused_adamw.MAX_LEAVES)
    return (*([leaf[j] for leaf in leaves] for j in range(4)), ss, expect)


@pytest.mark.parametrize("kind", ["dcnv2", "many leaves", "unaligned among aligned",
                                  "an empty leaf"])
def test_adamw_list_is_bit_equal_to_plain(dev, kind):
    ps, mus, nus, gs, ss, expect = _adam_list_case(kind, dev)
    ref = [[t.clone() for t in leaf] for leaf in zip(ps, mus, nus)]
    for (p, mu, nu), g, s in zip(ref, gs, ss):
        fused_adamw.fused_adamw_plain(p, mu, nu, g, s)
    before = fused_adamw.launches
    fused_adamw.fused_adamw_multi(ps, mus, nus, gs, ss)
    assert fused_adamw.launches == before + expect
    torch.cuda.synchronize()
    for i, (got, want) in enumerate(zip(zip(ps, mus, nus), ref)):
        assert all(torch.equal(a, b) for a, b in zip(got, want)), i


def test_adamw_list_rejects_what_it_does_not_take(dev):
    (p, mu, nu, g), (q, qmu, qnu, qg) = _adam_state((64,), 1, dev), _adam_state((8,), 2, dev)
    s = fused_adamw.scalars(1e-3, 0.1, 0.9, 0.999, 1e-8, 1)
    with pytest.raises(ValueError):  # one leaf on the CPU
        fused_adamw.fused_adamw_multi([p, q.cpu()], [mu, qmu.cpu()], [nu, qnu.cpu()],
                                      [g, qg.cpu()], [s, s])
    with pytest.raises(ValueError):  # bc1 differs: not one launch
        fused_adamw.fused_adamw_multi([p, q], [mu, qmu], [nu, qnu], [g, qg],
                                      [s, s._replace(bc1=0.5)])
    with pytest.raises(ValueError):
        fused_adamw.fused_adamw_multi([p, q], [mu, qmu], [nu, qnu], [g, qg.double()], [s, s])


# ---- K3: gradient scatter-add ------------------------------------------------

def _summation_bound(ids, grads, vocab):
    """Per element of the (V, E) result: 2 (n - 1) u sum|g| over the row's n
    gradients, u = 2**-24, the sum of two f32 recursive-summation bounds."""
    flat = ids.reshape(-1).long()
    e = grads.shape[-1]
    g = grads.reshape(-1, e).double()
    abs_sum = torch.zeros(vocab, e, dtype=torch.float64, device=g.device)
    abs_sum.index_add_(0, flat, g.abs())
    count = torch.bincount(flat, minlength=vocab).double()
    ref = torch.zeros(vocab, e, dtype=torch.float64, device=g.device).index_add_(0, flat, g)
    return ref, 2 * (count - 1).clamp(min=0)[:, None] * 2.0 ** -24 * abs_sum


def _ragged_ids(kind, g):
    """(ids, vocab) of one id kind: n = 1037 rows over 4001 ids (not a
    multiple of any block), MFP's <mask> shape, or the training step's
    field-blocked shape."""
    vocab, n = 4001, 1037
    if kind == "all_duplicate":
        return torch.full((n,), 3, dtype=torch.int32), vocab
    if kind == "sparse":  # most rows have an empty segment
        return torch.randint(0, 40, (n,), generator=g, dtype=torch.int32) * 97, vocab
    if kind == "mask_25k":  # one id in 25,000 rows, as MFP's <mask> id 3
        ids = torch.randint(0, vocab, (n + 25_000,), generator=g, dtype=torch.int32)
        ids[torch.randperm(ids.numel(), generator=g)[:25_000]] = 3
        return ids, vocab
    if kind == "field_blocked":  # batch 4096; 4-8-id fields hit ~500-1000 times an id
        sizes = [4, 5, 7, 8, 560, 8500, 101_000]
        lo = torch.tensor([10] + sizes[:-1]).cumsum(0)
        ids = torch.stack([torch.randint(int(a), int(a) + s, (4096,), generator=g)
                           for a, s in zip(lo, sizes)], dim=1)
        return ids.int(), 10 + sum(sizes)
    return torch.randint(0, vocab, (n,), generator=g, dtype=torch.int32), vocab


@pytest.mark.parametrize("e", [1, 12, 16, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["uniform", "sparse", "all_duplicate", "mask_25k",
                                  "field_blocked"])
def test_scatter_matches_plain(dev, e, dtype, kind):
    g = torch.Generator().manual_seed(e)
    ids, vocab = _ragged_ids(kind, g)
    ids = ids.to(dev)
    grads = torch.randn(*ids.shape, e, generator=g).to(dev, dtype)
    before = scatter.launches
    out = scatter.scatter_add(ids, grads, vocab)
    assert scatter.launches == before + 1
    assert out.dtype == torch.float32 and out.shape == (vocab, e)
    ref64, bound = _summation_bound(ids, grads, vocab)
    assert bool(((out.double() - ref64).abs() <= bound).all())
    plain = scatter.scatter_add_plain(ids, grads, vocab)
    assert bool(((out.double() - plain.double()).abs() <= 2 * bound).all())
    untouched = torch.bincount(ids.reshape(-1).long(), minlength=vocab) == 0
    assert not out[untouched].any()
    # the same bits as the in-order sum: the plain version on the CPU
    # (index_add_, index order) and, but at width 1, the plain one on the
    # card (index_put_ sums a width-1 segment of 32 or more rows by warps)
    in_order = scatter.scatter_add_plain(ids.cpu(), grads.cpu(), vocab)
    assert torch.equal(out.cpu(), in_order)
    if e > 1:
        assert torch.equal(out, plain)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scatter_misaligned_grads_take_the_scalar_path(dev, dtype):
    g = torch.Generator().manual_seed(3)
    ids, vocab = _ragged_ids("mask_25k", g)
    ids = ids.to(dev)
    e = 16
    buf = torch.randn(ids.numel() * e + 1, generator=g).to(dev, dtype)
    grads = buf[1:].view(ids.numel(), e)  # contiguous, off the 8-byte grid
    assert grads.is_contiguous() and grads.data_ptr() % 8 != 0
    out = scatter.scatter_add(ids, grads, vocab)
    assert torch.equal(out.cpu(), scatter.scatter_add_plain(ids.cpu(), grads.cpu(), vocab))
    assert torch.equal(out, scatter.scatter_add_plain(ids, grads, vocab))


def test_scatter_is_deterministic(dev):
    g = torch.Generator().manual_seed(0)
    ids = torch.randint(0, 50, (4096, 24), generator=g, dtype=torch.int32).to(dev)
    grads = torch.randn(4096, 24, 16, generator=g).to(dev, torch.bfloat16)
    a = scatter.scatter_add(ids, grads, 1000)
    b = scatter.scatter_add(ids, grads, 1000)
    assert torch.equal(a, b)


def test_scatter_rejects_what_it_does_not_take(dev):
    ids = torch.zeros(8, dtype=torch.int32, device=dev)
    grads = torch.randn(8, 16, device=dev)
    with pytest.raises(ValueError):
        scatter.scatter_add(ids.long(), grads, 10)
    with pytest.raises(ValueError):
        scatter.scatter_add(ids, grads.half(), 10)
    with pytest.raises(ValueError):
        scatter.scatter_add(ids.cpu(), grads, 10)
    with pytest.raises(ValueError):
        scatter.scatter_add(ids, torch.randn(16, 8, device=dev).t(), 10)
    with pytest.raises(ValueError):
        scatter.scatter_add(ids[:4], grads, 10)


# ---- the kernels under autograd: a small DCNv2 ---------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dcnv2_gradients_match_the_plain_versions(dev, dtype):
    cfg = Config(model_name="dcnv2", input_size=700, num_fields=6, embed_size=16,
                 hidden_size=64, num_hidden_layers=2, num_cross_layers=2,
                 compute_dtype=dtype)
    model = models.from_config(cfg, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    ids = torch.randint(0, 700, (300, 6), generator=g, dtype=torch.int32)
    labels = torch.randint(0, 2, (300,), generator=g).float()
    weight = (torch.arange(300) < 290).float()

    def grads(m, device):
        m = m.to(device).train()
        loss = bce_loss(m(ids.to(device)).reshape(-1), labels.to(device),
                        weight.to(device))
        m.zero_grad()
        loss.backward()
        return loss.item(), {n: p.grad.cpu() for n, p in m.named_parameters()}

    import copy

    before = (embedding.launches, scatter.launches, cross.launches)
    loss, got = grads(copy.deepcopy(model), dev)
    assert (embedding.launches, scatter.launches, cross.launches) == tuple(
        x + 1 for x in before)
    ref_loss, ref = grads(model, "cpu")  # the plain versions
    # f32: sums in other orders; bf16: one bf16 ulp in the forward moves the
    # gradients by about 2**-8 of their scale
    tol = 1e-4 if dtype == "float32" else 3e-2
    assert abs(loss - ref_loss) <= tol * max(1.0, abs(ref_loss))
    for name, r in ref.items():
        scale = float(r.abs().max()) + 1e-12
        torch.testing.assert_close(got[name], r, atol=tol * scale, rtol=tol,
                                   msg=name)


# ---- K5: sorted-unique scatter and the decoder gather -------------------------

def _unique_stream(n, vocab, width, capacity, g):
    """A folded candidate stream as the decoder's backward builds it: the
    distinct ids of n Zipf-like draws ascending, then sentinels, cut to
    `capacity` entries: "n", the whole stream, as the port sizes it;
    "static", a capacity a little above the distinct count, as map_tpu's
    131,072 is when it fits; "none", no sentinel at all."""
    ids = (torch.rand(n, generator=g) ** 4 * vocab).int().clamp(max=vocab - 1)
    uids, vals, num_unique = dedup_scatter.sort_and_fold(
        ids, torch.randn(n, width, generator=g), vocab)
    assert int(num_unique) == len(torch.unique(ids))
    c = {"n": n, "static": int(num_unique) + 100, "none": int(num_unique)}[capacity]
    return uids[:c].contiguous(), vals[:c].contiguous(), int(num_unique)


@pytest.mark.parametrize("vocab,width,widths", [(100_003, 33, (32, 1)),
                                                (5000, 33, None),
                                                (4096, 16, None),
                                                (777, 6, (5, 1)),
                                                (3000, 3, (1, 2))])
@pytest.mark.parametrize("matmul", ["highest", "bf16x2"])
@pytest.mark.parametrize("capacity", ["n", "static", "none"])
def test_scatter_unique_sorted_is_exact(dev, vocab, width, widths, matmul, capacity):
    g = torch.Generator().manual_seed(vocab + width)
    uids, vals, num_unique = _unique_stream(20_000, vocab, width, capacity, g)
    uids, vals = uids.to(dev), vals.to(dev)
    before = scatter_unique.launches
    got = scatter_unique.scatter_unique_sorted(uids, vals, vocab, widths, matmul)
    assert scatter_unique.launches == before + 1
    ref = scatter_unique.scatter_unique_sorted_plain(uids, vals, vocab, widths, matmul)
    assert len(got) == len(ref) == len(widths or (width,))
    for a, b in zip(got, ref):
        assert a.is_contiguous() and a.dtype == torch.float32 and a.shape == b.shape
        assert torch.equal(a, b)
    out = torch.cat(got, 1)
    assert int((out != 0).any(1).sum()) <= num_unique
    # the same call writes the same bits
    again = scatter_unique.scatter_unique_sorted(uids, vals, vocab, widths, matmul)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_scatter_unique_sorted_dense_and_empty_streams(dev):
    # every row named (full windows), then no row named (sentinels only)
    vocab = 2 * 256 + 37
    vals = torch.randn(vocab, 33, device=dev)
    full = torch.arange(vocab, dtype=torch.int32, device=dev)
    (out,) = scatter_unique.scatter_unique_sorted(full, vals, vocab)
    assert torch.equal(out, vals)
    empty = torch.full((64,), vocab, dtype=torch.int32, device=dev)
    (out,) = scatter_unique.scatter_unique_sorted(empty, vals[:64], vocab)
    assert not out.any()


def test_scatter_unique_sorted_rejects_what_it_does_not_take(dev):
    uids = torch.arange(8, dtype=torch.int32, device=dev)
    vals = torch.randn(8, 33, device=dev)
    with pytest.raises(ValueError):
        scatter_unique.scatter_unique_sorted(uids.long(), vals, 10)
    with pytest.raises(ValueError):
        scatter_unique.scatter_unique_sorted(uids, vals.double(), 10)
    with pytest.raises(ValueError):
        scatter_unique.scatter_unique_sorted(uids.cpu(), vals, 10)
    with pytest.raises(ValueError):
        scatter_unique.scatter_unique_sorted(uids, vals.t().contiguous().t(), 10)
    with pytest.raises(ValueError):
        scatter_unique.scatter_unique_sorted(uids[:4], vals, 10)


def test_decoder_gather_gradient_through_k5(dev):
    # the card's fold (sort, cumsum, compaction, K5) against a float64
    # index_add_: float32 prefix differences carry the rounding of the
    # running prefix, so 16 ulps of each column's largest prefix
    g = torch.Generator().manual_seed(0)
    vocab, e = 50_000, 32
    ids = ((torch.rand(64, 7, 26, generator=g) ** 3) * vocab).int()
    emb = torch.randn(vocab, e, generator=g)
    bias = torch.randn(vocab, 1, generator=g)
    cot_rows = torch.randn(64, 7, 26, e, generator=g)
    cot_b = torch.randn(64, 7, 26, generator=g)
    t_emb, t_bias = emb.to(dev).requires_grad_(), bias.to(dev).requires_grad_()
    before = (embedding.launches, scatter_unique.launches)
    rows, b = dedup_scatter.decoder_gather(t_emb, t_bias, ids.to(dev))
    assert torch.equal(rows.cpu(), emb[ids]) and torch.equal(b.cpu(), bias[ids][..., 0])
    torch.autograd.backward((rows, b), (cot_rows.to(dev), cot_b.to(dev)))
    assert (embedding.launches, scatter_unique.launches) == (before[0] + 1, before[1] + 1)
    flat = ids.reshape(-1).long()
    gcat = torch.cat([cot_rows.reshape(-1, e), cot_b.reshape(-1, 1)], 1).double()
    ref = torch.zeros(vocab, e + 1, dtype=torch.float64).index_add_(0, flat, gcat)
    order = torch.sort(flat, stable=True).indices
    ulps = 16 * 2.0 ** -24 * gcat[order].cumsum(0).abs().max(0).values
    got = torch.cat([t_emb.grad, t_bias.grad], 1).cpu().double()
    assert bool(((got - ref).abs() <= 1e-6 + ulps).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mfp_dcnv2_gradients_match_the_plain_versions(dev, dtype):
    import numpy as np

    from map_tpu_torch.train.train_step import MFPDraws

    cfg = Config(model_name="dcnv2", input_size=3000, num_fields=6, embed_size=16,
                 hidden_size=64, num_hidden_layers=2, num_cross_layers=2,
                 compute_dtype=dtype, pretrain=True, pt_type="MFP", proj_size=32,
                 pt_neg_num=25, feat_count=np.arange(3000, dtype=np.float32))
    model = models.from_config(cfg, torch.Generator().manual_seed(0))
    assert len(list(model.parameters())) == 13
    g = torch.Generator().manual_seed(1)
    ids = torch.randint(10, 3000, (300, 6), generator=g, dtype=torch.int32)
    draws = MFPDraws(torch.randint(0, 6, (300, 2), generator=g),
                     torch.randint(10, 3000, (300, 2, 25), generator=g, dtype=torch.int32),
                     None)
    from map_tpu_torch.objectives.corruption import mfp_corrupt

    corrupted, labels = mfp_corrupt(ids, draws.masked_index)
    cand = torch.cat([labels[..., None], draws.noise], -1)

    def grads(m, device):
        m = m.to(device).train()
        logits = m.mfp_candidate_logits(corrupted.to(device), draws.masked_index.to(device),
                                        cand.to(device))
        loss = torch.log_softmax(logits, -1)[..., 0].mean().neg()
        m.zero_grad()
        loss.backward()
        return loss.item(), {n: p.grad.cpu() for n, p in m.named_parameters()}

    import copy

    counts = lambda: (embedding.launches, scatter.launches, cross.launches,  # noqa: E731
                      scatter_unique.launches)
    before = counts()
    loss, got = grads(copy.deepcopy(model), dev)
    assert counts() == (before[0] + 2, before[1] + 1, before[2] + 1, before[3] + 1)
    ref_loss, ref = grads(model, "cpu")  # the plain versions
    tol = 1e-4 if dtype == "float32" else 3e-2
    assert abs(loss - ref_loss) <= tol * max(1.0, abs(ref_loss))
    for name, r in ref.items():
        scale = float(r.abs().max()) + 1e-12
        torch.testing.assert_close(got[name], r, atol=tol * scale, rtol=tol, msg=name)


# ---- K8: block scan -------------------------------------------------------------

@pytest.mark.parametrize("n,w", [(1, 1), (31, 5), (1000, 33), (28_672, 33),
                                 (745_472, 33), (2048, 128), (777, 100), (5000, 1)])
def test_block_cumsum_matches_float64(dev, n, w):
    # the fold's stream shapes (the shared modes' target fold, the
    # per-position fold) and ragged ones; against a float64 scan, within
    # 1e-6 of the largest prefix of |x|, and against the plain version
    g = torch.Generator().manual_seed(n + w)
    x = (torch.randn(n, w, generator=g) * 1e-3).to(dev)
    before = scan.launches
    got = scan.block_cumsum(x)
    assert scan.launches == before + 1
    assert got.shape == x.shape and got.dtype == torch.float32
    ref = x.double().cumsum(0)
    tol = 1e-6 * float(x.double().abs().cumsum(0).max())
    assert float((got.double() - ref).abs().max()) <= tol
    assert float((got - scan.block_cumsum_plain(x)).abs().max()) <= 2 * tol
    assert torch.equal(got, scan.block_cumsum(x))  # the same bits again


@pytest.mark.parametrize("n,w,sms", [(1, 1, 132), (1, 128, 132), (1000, 33, 132),
                                     (2400, 33, 132), (28_672, 33, 132),
                                     (745_472, 33, 132), (50_000, 33, 4), (9_999, 128, 3),
                                     (70_001, 1, 2), (3_000_000, 33, 132),
                                     (400_001, 128, 132)])
def test_block_cumsum_is_its_association_bit_for_bit(dev, n, w, sms):
    # the plan test's cases (tests/test_torch_port_scan_plan.py): the kernel
    # under plan(n, w, sms) gives block_cumsum_order's bits, twice, in one
    # launch, within 1e-6 of the largest prefix of |x| of float64
    p = scan.plan(n, w, min(sms, torch.cuda.get_device_properties(dev).multi_processor_count))
    g = torch.Generator().manual_seed(n * w)
    x = (torch.randn(n, w, generator=g) * 1e-3).to(dev)
    before = scan.launches
    got = scan.block_cumsum(x, p)
    again = scan.block_cumsum(x, p)
    assert scan.launches == before + 2
    assert torch.equal(got, again)
    assert torch.equal(got, scan.block_cumsum_order(x, p))
    tol = 1e-6 * float(x.double().abs().cumsum(0).max())
    assert float((got.double() - x.double().cumsum(0)).abs().max()) <= tol


def test_block_cumsum_unaligned_takes_the_4_byte_path(dev):
    n, w = 20_001, 33
    buf = (torch.randn(n * w + 1, generator=torch.Generator().manual_seed(9)) * 1e-3).to(dev)
    x = buf[1:].view(n, w)
    assert x.data_ptr() % 16 != 0 and x.is_contiguous()
    got = scan.block_cumsum(x)
    p = scan.plan(n, w, torch.cuda.get_device_properties(dev).multi_processor_count, False)
    assert not p.vector
    assert torch.equal(got, scan.block_cumsum_order(x, p))


def test_block_cumsum_refuses_a_plan_that_does_not_fit(dev):
    x = torch.zeros(1000, 33, device=dev)
    p = scan.plan(1000, 33)
    for bad in (p._replace(tiles=p.tiles + 1), p._replace(smem=p.smem - 4),
                p._replace(tile_rows=p.tile_rows - 1), p._replace(seg_rows=1)):
        with pytest.raises(RuntimeError):
            scan.block_cumsum(x, bad)


def test_block_cumsum_rejects_what_it_does_not_take(dev):
    with pytest.raises(ValueError):
        scan.block_cumsum(torch.zeros(10, 129, device=dev))
    with pytest.raises(ValueError):
        scan.block_cumsum(torch.zeros(10, 4, device=dev, dtype=torch.float64))
    with pytest.raises(ValueError):
        scan.block_cumsum(torch.zeros(4, 10, device=dev).t())
    with pytest.raises(ValueError):
        scan.block_cumsum(torch.zeros(10, device=dev))


# ---- K7: sparse-stream decoder AdamW ---------------------------------------------

def _stream(n, vocab, e, g):
    """A folded stream as the decoder's backward gives it: the distinct ids
    of n skewed draws ascending, their summed values, sentinels behind."""
    ids = (torch.rand(n, generator=g) ** 3 * vocab).int().clamp(max=vocab - 1)
    uids, vals, _ = dedup_scatter.sort_and_fold(ids, torch.randn(n, e, generator=g), vocab)
    return sparse_adamw.Stream(uids, vals)


@pytest.mark.parametrize("vocab,e,nt,nn", [(1_013_519, 32, 28_672, 2400),
                                           (100_003, 32, 20_000, 100),
                                           (5000, 16, 3000, 3000),
                                           (777, 6, 500, 25),
                                           (300, 32, 0, 40)])
@pytest.mark.parametrize("wd", [5e-2, 0.0])
def test_sparse_adamw_matches_plain(dev, vocab, e, nt, nn, wd):
    g = torch.Generator().manual_seed(vocab + e)
    target = sparse_adamw.Stream(*(t.to(dev) for t in _stream(nt, vocab, e, g)))
    noise = sparse_adamw.Stream(*(t.to(dev) for t in _stream(nn, vocab, e, g)))
    p, mu, nu, _ = _adam_state((vocab, e), vocab, dev)
    s = fused_adamw.scalars(1e-3, wd, 0.9, 0.999, 1e-8, 4)
    ref = [t.clone() for t in (p, mu, nu)]
    sparse_adamw.sparse_adamw_plain(*ref, target, noise, s)
    before = sparse_adamw.launches
    got = [t.clone() for t in (p, mu, nu)]
    sparse_adamw.sparse_adamw(*got, target, noise, s)
    assert sparse_adamw.launches == before + 1
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    again = [t.clone() for t in (p, mu, nu)]
    sparse_adamw.sparse_adamw(*again, target, noise, s)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_sparse_adamw_is_k1_on_the_dense_gradient(dev):
    # K7 on two streams == K1 on the dense sum the dense route builds (K5 of
    # each stream, added), bit for bit
    g = torch.Generator().manual_seed(3)
    vocab, e = 50_000, 32
    target = sparse_adamw.Stream(*(t.to(dev) for t in _stream(9000, vocab, e, g)))
    noise = sparse_adamw.Stream(*(t.to(dev) for t in _stream(700, vocab, e, g)))
    p, mu, nu, _ = _adam_state((vocab, e), 5, dev)
    s = fused_adamw.scalars(1e-3, 5e-2, 0.9, 0.999, 1e-8, 2)
    dense = ((scatter_unique.scatter_unique_sorted(*target, vocab)[0]
              + scatter_unique.scatter_unique_sorted(*noise, vocab)[0]))
    ref = [t.clone() for t in (p, mu, nu)]
    fused_adamw.fused_adamw(*ref, dense, s)
    got = [t.clone() for t in (p, mu, nu)]
    sparse_adamw.sparse_adamw(*got, target, noise, s)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_sparse_adamw_rejects_what_it_does_not_take(dev):
    p, mu, nu = (torch.zeros(100, 8, device=dev) for _ in range(3))
    ok = sparse_adamw.Stream(torch.arange(4, dtype=torch.int32, device=dev),
                             torch.zeros(4, 8, device=dev))
    s = fused_adamw.scalars(1e-3, 0.0, 0.9, 0.999, 1e-8, 1)
    bad = [sparse_adamw.Stream(ok.uids.long(), ok.vals),
           sparse_adamw.Stream(ok.uids, ok.vals.double()),
           sparse_adamw.Stream(ok.uids, torch.zeros(4, 7, device=dev)),
           sparse_adamw.Stream(ok.uids.cpu(), ok.vals.cpu())]
    for stream in bad:
        with pytest.raises(ValueError):
            sparse_adamw.sparse_adamw(p, mu, nu, ok, stream, s)
    with pytest.raises(ValueError):
        sparse_adamw.sparse_adamw(p, mu, nu[:50], ok, ok, s)


@pytest.mark.parametrize("per_field", [True, False])
def test_shared_noise_sparse_steps_equal_dense_steps(dev, per_field):
    # 3 shared-noise MFP steps with K7 against 3 on the dense route (K5 + K1
    # on emb), from the same weights and draws, f32: target + noise is one
    # f32 add either way, so the parameters are bit-equal
    import numpy as np

    from map_tpu_torch.config import TrainingArguments
    from map_tpu_torch.train.train_step import draw_mfp
    from map_tpu_torch.train.trainer import Trainer

    vocab, fields = 6010, 6
    lo = [10 + 1000 * i for i in range(fields)]
    cfg = Config(model_name="dcnv2", input_size=vocab, num_fields=fields, embed_size=16,
                 hidden_size=64, num_hidden_layers=2, num_cross_layers=2,
                 compute_dtype="float32", pretrain=True, pt_type="MFP", proj_size=32,
                 pt_neg_num=25, pt_per_field_noise=per_field,
                 feat_count=np.arange(vocab, dtype=np.float32) % 97 + 1,
                 idx_low=lo, idx_high=[a + 1000 for a in lo])
    g = torch.Generator().manual_seed(0)
    ids = torch.stack([torch.randint(a, a + 1000, (3, 512), generator=g, dtype=torch.int32)
                       for a in lo], -1)
    batches = [{"input_ids": ids[i].numpy(), "labels": np.zeros(512, np.float32),
                "weight": np.ones(512, np.float32)} for i in range(3)]

    def run(sparse):
        args = TrainingArguments(learning_rate=1e-3, weight_decay=5e-2, pretrain=True,
                                 pt_shared_noise=True, pt_per_field_noise=per_field,
                                 sparse_table_update=sparse, mask_ratio=0.3,
                                 sampling_method="randint")
        data = type("D", (), {"X": {"train": ids[0].numpy()},
                              "Y": {"train": np.zeros(512, np.float32)}})()
        trainer = Trainer(models.from_config(cfg, torch.Generator().manual_seed(0)),
                          cfg, args, data, device=dev)
        trainer.build_steps(10)
        assert (trainer.model.mfp_criterion.handoff is not None) == sparse
        gen = torch.Generator(device=dev).manual_seed(1)
        before = sparse_adamw.launches
        for batch in batches:
            draws = draw_mfp(gen, trainer.noise, 512, fields, 1, 25, "randint",
                             shared_noise=True)
            trainer.train_step(batch, draws)
        assert sparse_adamw.launches == before + (3 if sparse else 0)
        return {n: p.detach().clone() for n, p in trainer.model.named_parameters()}

    dense, sparse = run(False), run(True)
    for name, ref in dense.items():
        assert torch.equal(sparse[name], ref), name


# ---- K6: field-block scatter and gather -----------------------------------------

def _field_block_case(r, w, b, dtype, g):
    """Windows: three tiny fields in tile 0 (each row hit by many of the b
    rows), one across tiles, one on the last tile, which runs past r."""
    small = ((0, 10, 14), (1, 14, 21), (2, 21, 45), (3, 600, 1900), (4, r - 40, r))
    phys = torch.stack([torch.randint(plo, pe, (b,), generator=g, dtype=torch.int32)
                        for _, plo, pe in small])
    phys[torch.rand(phys.shape, generator=g) < 0.1] = -1
    phys[3, :4] = torch.tensor([512, 511, 2047, 5], dtype=torch.int32)  # in tiles, not window
    gs = (torch.randn(b, len(small) * w, generator=g)
          * 10.0 ** torch.randint(-3, 3, (b, 1), generator=g)).to(dtype)
    return small, phys, gs


@pytest.mark.parametrize("w", [16, 8, 128, 20])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_field_block_scatter_is_exact_and_deterministic(dev, w, dtype):
    r, b = 2100, 1537
    small, phys, gs = _field_block_case(r, w, b, dtype, torch.Generator().manual_seed(w))
    phys, gs = phys.to(dev), gs.to(dev)
    before = field_gather.scatter_launches
    got = field_gather.field_block_scatter(gs, phys, small, r)
    again = field_gather.field_block_scatter(gs, phys, small, r)
    assert field_gather.scatter_launches == before + 2
    ref = field_gather.field_block_scatter_plain(gs, phys, small, r)
    torch.cuda.synchronize()
    assert got.shape == ref.shape == (5, 512, w)
    assert torch.equal(got, ref) and torch.equal(got, again)
    base = torch.randn(r, w, generator=torch.Generator().manual_seed(1)).to(dev)
    added = field_gather.field_block_scatter_add(base.clone(), gs, phys, small)
    want = field_gather.field_block_scatter_add_plain(base.clone(), gs, phys, small)
    assert torch.equal(added, want)
    utiles, _ = field_gather.plan_pairs(small, r)
    assert torch.equal(added, base + field_gather.assemble_dense(got, utiles, r))


# the canonical layout's 21 small fields (bench.py's 5-core-Avazu sizes)
CANONICAL_SMALL = [7, 7, 24, 26, 4100, 7600, 26, 8500, 560, 36, 8200, 5, 4, 2600, 8, 450,
                   70, 170, 60, 30, 26]


def _order_case(kind, b, w, dtype, g):
    """K6b's order-deciding hit patterns -> (small, r, phys (Fs, b), g_small)."""
    if kind == "canonical":  # ids uniform in their fields
        lo = [10]
        for size in CANONICAL_SMALL[:-1]:
            lo.append(lo[-1] + size)
        small = tuple((pos, a, a + size) for pos, (a, size) in enumerate(zip(lo, CANONICAL_SMALL)))
    elif kind in ("hot_chain", "one_row"):  # a 4-id field: rows of about b / 4 hits, or one of b
        small = ((0, 10, 14), (1, 14, 30), (2, 30, 900))
    else:  # multi_pair, all_minus_one: fields sharing tile 0, one across tiles 0-1
        small = ((0, 10, 14), (1, 14, 40), (2, 40, 700))
    r = small[-1][2] + 3
    phys = torch.stack([torch.randint(plo, pe, (b,), generator=g, dtype=torch.int32)
                        for _, plo, pe in small])
    if kind == "multi_pair":  # ids in a field's tile but outside its window
        phys[0, ::3] = torch.randint(14, 40, phys[0, ::3].shape, generator=g, dtype=torch.int32)
        phys[2, ::5] = torch.randint(10, 40, phys[2, ::5].shape, generator=g, dtype=torch.int32)
        phys[1, ::7] = -1
    elif kind == "one_row":
        phys[0] = 12
    elif kind == "all_minus_one":
        phys[:] = -1
    gs = (torch.randn(b, len(small) * w, generator=g)
          * 10.0 ** torch.randint(-3, 3, (b, 1), generator=g)).to(dtype)
    return small, r, phys, gs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,b,w", [
    ("multi_pair", 1537, 16), ("hot_chain", 4096, 16), ("one_row", 4096, 16),
    ("all_minus_one", 512, 16), ("multi_pair", 1, 16), ("multi_pair", 1537, 4),
    ("multi_pair", 1537, 20), ("multi_pair", 1537, 128), ("canonical", 4096, 16)])
def test_field_block_scatter_keeps_the_pair_b_order(dev, kind, b, w, dtype):
    small, r, phys, gs = _order_case(kind, b, w, dtype, torch.Generator().manual_seed(b + w))
    phys, gs = phys.to(dev), gs.to(dev)
    before = field_gather.scatter_launches
    got = field_gather.field_block_scatter(gs, phys, small, r)
    again = field_gather.field_block_scatter(gs, phys, small, r)
    ref = field_gather.field_block_scatter_plain(gs, phys, small, r)
    base = torch.randn(r, w, generator=torch.Generator().manual_seed(3)).to(dev)
    added = field_gather.field_block_scatter_add(base.clone(), gs, phys, small)
    added_again = field_gather.field_block_scatter_add(base.clone(), gs, phys, small)
    want = field_gather.field_block_scatter_add_plain(base.clone(), gs, phys, small)
    torch.cuda.synchronize()
    assert field_gather.scatter_launches == before + 4
    assert torch.equal(got, ref) and torch.equal(got, again)
    assert torch.equal(added, want) and torch.equal(added, added_again)
    if kind == "all_minus_one":
        assert not got.any() and torch.equal(added, base)


@pytest.mark.parametrize("w", [16, 4, 128, 32])
@pytest.mark.parametrize("b", [1001, 4097, 10_007])
def test_field_block_gather_is_exact(dev, w, b):
    """B off the block's range of b (4097 and 10,007 on 132 SMs), ids of
    -1, ids in a field's tiles outside its window, and ids outside its
    tiles (zeros): bit-equal to the plain version, twice, one launch each."""
    r = 2100
    g = torch.Generator().manual_seed(w)
    small, phys, _ = _field_block_case(r, w, b, torch.float32, g)
    phys[0, 4:8] = torch.tensor([600, 1500, 2099, 513], dtype=torch.int32)  # past tile 0
    phys[4, 8:10] = torch.tensor([0, 1000], dtype=torch.int32)  # before the last tile
    phys = phys.to(dev)
    table = torch.randn(r, w, generator=g).to(dev)
    before = field_gather.gather_launches
    got = field_gather.field_block_gather(table, phys, small, r)
    again = field_gather.field_block_gather(table, phys, small, r)
    assert field_gather.gather_launches == before + 2
    ref = field_gather.field_block_gather_plain(table, phys, small, r)
    torch.cuda.synchronize()
    assert got.shape == (b, 5 * w) and torch.equal(got, ref) and torch.equal(got, again)
    assert not got[4:8, :w].any() and not got[8:10, 4 * w:].any()


def test_field_block_kernels_reject_what_they_do_not_take(dev):
    small = ((0, 10, 20),)
    phys = torch.zeros(1, 8, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="multiple of 4"):
        field_gather.field_block_scatter(torch.zeros(8, 6, device=dev), phys, small, 100)
    with pytest.raises(ValueError, match="int32"):
        field_gather.field_block_scatter(torch.zeros(8, 16, device=dev), phys.long(),
                                         small, 100)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        field_gather.field_block_scatter(torch.zeros(8, 16, device=dev).half(), phys,
                                         small, 100)
    with pytest.raises(ValueError, match="does not fit"):
        field_gather.field_block_scatter(torch.zeros(9, 16, device=dev), phys, small, 100)
    with pytest.raises(ValueError, match="float32"):
        field_gather.field_block_gather(torch.zeros(100, 16, device=dev).double(), phys,
                                        small, 100)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sizes", [
    [7, 4, 26, 4100, 5, 300_000, 16_384, 30],
    # the canonical layout: bench.py's 5-core-Avazu sizes, 21 small fields
    CANONICAL_SMALL[:19] + [101_000, 380_000, 500_000] + CANONICAL_SMALL[19:]])
def test_hybrid_bwd_pallas_gradient_equals_flat_k3(dev, dtype, sizes):
    # ids in their blocks, no reserved id: every row of the K6b route is the
    # flat K3 route's, bit for bit (each row summed in order of b from 0.0)
    lo = [10]
    for size in sizes[:-1]:
        lo.append(lo[-1] + size)
    bounds = tuple((a, a + s) for a, s in zip(lo, sizes))
    r = bounds[-1][1]
    g = torch.Generator().manual_seed(2)
    ids = torch.stack([torch.randint(a, h, (4096,), generator=g, dtype=torch.int32)
                       for a, h in bounds], 1).to(dev)
    cot = torch.randn(4096, len(sizes), 16, generator=g).to(dev, dtype)
    before = (field_gather.scatter_launches, scatter.launches)
    flat = hybrid_gather.table_grad(ids, cot, r, bounds, 10, "fwd")
    blocked = hybrid_gather.table_grad(ids, cot, r, bounds, 10, "bwd_pallas")
    torch.cuda.synchronize()
    assert (field_gather.scatter_launches, scatter.launches) == (before[0] + 1,
                                                                 before[1] + 2)
    assert torch.equal(blocked, flat)


# ---- the multi-step dispatch: captured CUDA graphs ------------------------------------

GRAPH_SIZES = [7, 24, 60, 300, 20_000, 5, 150, 30_000]  # 6 small fields, 2 big


def _graph_trainer(dev, kind, dtype, resident, spc, seed=0, model="dcnv2", groups=1,
                   args_kw=None, **knobs):
    """A narrow Trainer on the card (DCNv2 unless `model` and `knobs` say
    otherwise) for `kind`: supervised, rfd (bwd_pallas), mfp (per-position,
    matmul) or pf_shared (per-field shared noise, k = 20, the sparse table
    update), on `groups` groups of 4 full batches, then a padded one."""
    import numpy as np

    from map_tpu_torch.config import TrainingArguments
    from map_tpu_torch.train.trainer import Trainer

    lo = [int(x) for x in np.cumsum([10] + GRAPH_SIZES[:-1])]
    hi = [a + s for a, s in zip(lo, GRAPH_SIZES)]
    vocab = hi[-1]
    rng = np.random.default_rng(seed)
    rows = groups * 4 * 512 + 100
    x = np.stack([rng.integers(a, b, rows) for a, b in zip(lo, hi)], 1).astype(np.int32)
    y = rng.integers(0, 2, rows).astype(np.float32)
    pretrain = kind != "supervised"
    mfp = kind in ("mfp", "pf_shared")
    cfg = Config(model_name=model, input_size=vocab, num_fields=8, embed_size=16,
                 hidden_size=64, num_hidden_layers=2, num_cross_layers=2,
                 compute_dtype=dtype, pretrain=pretrain, pt_type="MFP" if mfp else "RFD",
                 proj_size=16, pt_neg_num=20, idx_low=lo, idx_high=hi,
                 pt_per_field_noise=kind == "pf_shared",
                 hybrid_mode={"rfd": "bwd_pallas", "mfp": "matmul"}.get(kind, ""),
                 feat_count=(np.arange(vocab) % 89 + 1).astype(np.float32) if mfp else None)
    cfg = dataclasses.replace(cfg, **knobs)
    args = TrainingArguments(
        per_device_train_batch_size=512, learning_rate=1e-3, weight_decay=0.05,
        lr_sched="cosine", num_train_epochs=2, seed=seed, compute_dtype=dtype,
        pretrain=pretrain, pt_type=cfg.pt_type, RFD_replace="Unigram", mask_ratio=0.3,
        sampling_method="randint", data_dir="", pt_shared_noise=kind == "pf_shared",
        pt_per_field_noise=kind == "pf_shared", sparse_table_update=kind == "pf_shared",
        device_resident_data=resident, steps_per_call=spc, **(args_kw or {}))
    data = type("D", (), {"X": {"train": x}, "Y": {"train": y}})()
    return Trainer(models.from_config(cfg, torch.Generator().manual_seed(seed)), cfg, args,
                   data, device=dev)


def _graph_run(trainer):
    """Two epochs of 5 steps through the Trainer's pipeline -> each step's
    metrics, stacked."""
    batcher = trainer._prepare_training()
    out = []
    for epoch in range(2):
        for n, metrics, _ in trainer.train_epoch(batcher, epoch):
            out.append({k: v.reshape(n, -1) for k, v in metrics.items()})
    torch.cuda.synchronize()
    return {k: torch.cat([m[k] for m in out]) for k in out[0]}


@pytest.mark.parametrize("kind,dtype", [("supervised", "bfloat16"), ("supervised", "float32"),
                                        ("rfd", "bfloat16"), ("mfp", "bfloat16"),
                                        ("pf_shared", "bfloat16")])
def test_graph_steps_equal_eager_steps(dev, kind, dtype):
    """10 steps as captured graphs (the first call eager on a side stream,
    then a graph of 4 and one of 1, each replayed) against 10 eager steps on
    host batches, the port's own draws: the same bits."""
    from map_tpu_torch.train.graph import launch_counts

    eager = _graph_trainer(dev, kind, dtype, "off", 1)
    ref = _graph_run(eager)
    graphed = _graph_trainer(dev, kind, dtype, "on", 4)
    before = launch_counts()
    got = _graph_run(graphed)
    multi = graphed.multi
    assert multi.graphed and sorted(multi.graphs) == [1, 4]
    assert {n: g.replays for n, g in multi.graphs.items()} == {1: 2, 4: 1}
    assert graphed.optimizer.count == 10
    counts = {k: v - before[k] for k, v in launch_counts().items()}
    ran = multi.launches_run(counts)
    # K1 and K4 once a step, whichever way the step ran
    assert ran["fused_adamw"] == 10 and ran["embedding_gather"] >= 10, ran
    if kind == "pf_shared":
        assert ran["sparse_adamw"] == 10 and ran["block_cumsum"] >= 10, ran
    if kind == "rfd":
        assert ran["field_block_scatter"] == 10, ran
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
    for (name, a), b in zip(eager.model.named_parameters(), graphed.model.parameters()):
        assert torch.equal(a, b), name


def test_graph_replays_draw_anew_as_eager_steps_do(dev):
    """A registered generator's replays draw on from where it stands: the
    replayed draws are the eager sequence, and no two replays repeat."""
    from map_tpu_torch.train.graph import MultiStep
    from map_tpu_torch.train.optimizer import AdamW
    from map_tpu_torch.train.schedules import make_schedule

    w = torch.nn.Parameter(torch.zeros(8, device=dev))
    opt = AdamW([("w", w)], make_schedule("const", 1e-3, 0, 10), 0.9, 0.999, 1e-8, 0.0,
                slots=2)
    gen = torch.Generator(device=dev).manual_seed(3)

    def step(batch):
        r = torch.rand(8, generator=gen, device=dev) + batch["x"]
        opt.step([r.clone()])
        return {"r": r}

    multi = MultiStep(step, 2, opt, dev, [gen])
    x = {"x": torch.zeros(2, 8, device=dev)}
    calls = [multi(2, x)["r"] for _ in range(4)]  # warm-up, capture + replay, 2 replays
    assert multi.graphs[2].replays == 3
    got = torch.cat(calls)
    ref_gen = torch.Generator(device=dev).manual_seed(3)
    ref = torch.stack([torch.rand(8, generator=ref_gen, device=dev) for _ in range(8)])
    assert torch.equal(got, ref)
    assert len({tuple(r.tolist()) for r in got}) == 8
    assert opt.count == 8


def test_wrappers_launch_on_the_capture_stream(dev):
    """`build.current_stream`, the stream every wrapper launches on, is the
    capture stream while a graph is captured, and the launch lands in the
    graph: a K4 gather replayed gives the rows of the ids copied in."""
    from map_tpu_torch.kernels import build

    table = torch.randn(1000, 16, device=dev)
    ids = torch.zeros(64, 8, dtype=torch.int32, device=dev)
    graph = torch.cuda.CUDAGraph()
    embedding.embedding_lookup(table, ids)  # the warm-up: the library and the plan
    torch.cuda.synchronize()
    with torch.cuda.graph(graph):
        seen = build.current_stream(dev.index or 0)
        capture = torch.cuda.current_stream(dev).cuda_stream
        out = embedding.embedding_lookup(table, ids)
    assert seen == capture != torch.cuda.default_stream(dev).cuda_stream
    ids.copy_(torch.randint(0, 1000, (64, 8), dtype=torch.int32, device=dev))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, embedding.embedding_lookup_plain(table, ids))


def test_capture_failure_raises(dev):
    """A step that copies from the host inside the capture fails it; the
    dispatch raises and runs nothing eagerly in its place."""
    from map_tpu_torch.train.graph import MultiStep
    from map_tpu_torch.train.optimizer import AdamW
    from map_tpu_torch.train.schedules import make_schedule

    w = torch.nn.Parameter(torch.zeros(4, device=dev))
    opt = AdamW([("w", w)], make_schedule("const", 1e-3, 0, 10), 0.9, 0.999, 1e-8, 0.0,
                slots=2)

    def step(batch):
        g = torch.tensor([1.0, 2.0, 3.0, 4.0], device=dev)  # a synchronous host copy
        opt.step([g + batch["x"]])
        return {"g": g}

    multi = MultiStep(step, 2, opt, dev)
    x = {"x": torch.zeros(2, 4, device=dev)}
    multi(2, x)  # the warm-up runs eagerly
    with pytest.raises(RuntimeError):
        multi(2, x)
    assert opt.count == 2



# ---- the rest of the zoo through the kernels -------------------------------------------

ZOO_KNOBS = {
    "lr": {}, "fm": {}, "dnn": {}, "deepfm": {},
    "xdeepfm": dict(cin_layer_units="12,10"),
    "autoint": dict(attn_size=12, num_attn_heads=2, attn_probs_dropout_rate=0.1),
    "trans": dict(hidden_size=16, num_attn_heads=2, intermediate_size=64,
                  output_reduction="attn,fc"),
    "fignn": dict(num_hidden_layers=2),
    "fgcnn": dict(channels="6,8", kernel_heights="3,3", pooling_sizes="2,2",
                  recombined_channels="2,2", share_embedding=False),
}


def _plain_swaps(monkeypatch):
    """Every kernel of a supervised step swapped for its plain version, as
    chip_smoke.py's `plain_layers` does: the gathers (the table's and LR's),
    the table gradient's scatters."""
    from map_tpu_torch.nn import layers

    monkeypatch.setattr(layers, "embedding_lookup", embedding.embedding_lookup_plain)
    monkeypatch.setattr(hybrid_gather, "embedding_lookup", embedding.embedding_lookup_plain)
    monkeypatch.setattr(hybrid_gather, "scatter_add", scatter.scatter_add_plain)
    monkeypatch.setattr(hybrid_gather, "field_block_scatter_add",
                        field_gather.field_block_scatter_add_plain)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(ZOO_KNOBS))
def test_zoo_steps_match_the_plain_versions(dev, name, dtype, monkeypatch):
    """5 supervised steps of each model through the kernels (K4, K3 and K1;
    K4 and K3 at E = 1 for the LR table) against the same 5 through their
    plain versions on the card, from the same weights and dropout draws:
    losses within 1e-5 (f32) or 2e-2 (bf16) relative, every parameter within
    2 lr k (Adam's step is lr at most, and where a gradient is within
    rounding of 0 its sign may differ), the updates' L1 difference a small
    share of their own L1 norm (1e-2 f32, 0.25 bf16), as chip_smoke.py's
    `parity_check`; FGCNN's BatchNorm running statistics within 2 lr k plus
    1e-5 (f32) or 2e-2 (bf16) of their size (a running mean follows its
    convolution's bias, whose gradient is rounding only)."""
    from map_tpu_torch.nn.layers import set_dropout_generator
    from map_tpu_torch.train.optimizer import build_optimizer
    from map_tpu_torch.train.train_step import make_supervised_steps

    trainer = _graph_trainer(dev, "supervised", dtype, "off", 1, model=name,
                             **ZOO_KNOBS[name])
    cfg, args = trainer.config, trainer.args
    batches = list(trainer.get_batcher("train", True).epoch(0))[:5]
    p0 = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}

    def run(plain):
        m = models.from_config(cfg, torch.Generator().manual_seed(0)).to(dev)
        set_dropout_generator(m, torch.Generator(device=dev).manual_seed(5))
        opt, _ = build_optimizer(m, args, 10, 0, update=(
            fused_adamw.fused_adamw_leaves_plain if plain else fused_adamw.fused_adamw_leaves))
        step, _ = make_supervised_steps(m, opt, dev)
        before = (embedding.launches, scatter.launches, fused_adamw.launches)
        with monkeypatch.context() as mp:
            if plain:
                _plain_swaps(mp)
            losses = torch.stack([step(b)["loss"] for b in batches])
        torch.cuda.synchronize()
        launched = tuple(a - b for a, b in zip(
            (embedding.launches, scatter.launches, fused_adamw.launches), before))
        return (losses.cpu(), {n: p.detach() for n, p in m.named_parameters()}, launched,
                dict(m.named_buffers()))

    k_loss, k_params, k_launched, k_bufs = run(False)
    p_loss, p_params, p_launched, p_bufs = run(True)
    assert p_launched == (0, 0, 0)
    assert k_launched[0] >= 5 and k_launched[1] >= 5 and k_launched[2] == 5, k_launched
    rel = {"float32": 1e-5, "bfloat16": 2e-2}[dtype]
    assert float(((k_loss - p_loss).abs() / p_loss.abs()).max()) <= rel
    diff_l1 = update_l1 = 0.0
    for n, ref in p_params.items():
        d = (k_params[n] - ref).abs()
        assert float(d.max()) <= 2 * 1e-3 * 5 * 1.01, n
        diff_l1 += float(d.double().sum())
        update_l1 += float((ref - p0[n]).abs().double().sum())
    assert diff_l1 <= {"float32": 1e-2, "bfloat16": 0.25}[dtype] * update_l1
    assert len(p_bufs) == (4 if name == "fgcnn" else 0)
    for n, ref in p_bufs.items():
        assert ((k_bufs[n] - ref).abs() <= 2 * 1e-3 * 5 * 1.01 + rel * ref.abs()).all(), n


def test_autoint_dropout_graph_is_bit_equal_to_eager_steps(dev):
    """AutoInt with its attention dropout at 0.1: a captured graph of 8
    steps (after the eager warm-up call of 8) against 16 eager steps, the
    dropout drawing from the Trainer's generator: the same bits."""
    knobs = dict(model="autoint", groups=4, attn_size=12, num_attn_heads=2,
                 attn_probs_dropout_rate=0.1)
    eager = _graph_trainer(dev, "supervised", "float32", "off", 1, **knobs)
    ref = _graph_run(eager)
    graphed = _graph_trainer(dev, "supervised", "float32", "on", 8, **knobs)
    got = _graph_run(graphed)
    multi = graphed.multi
    assert sorted(multi.graphs) == [1, 8] and multi.graphs[8].replays >= 2
    assert graphed.model.self_attention[0].dropout.rate == 0.1
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
    for (name, a), b in zip(eager.model.named_parameters(), graphed.model.parameters()):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("name,kind", [("fignn", "supervised"), ("fgcnn", "supervised"),
                                       ("fgcnn", "rfd"), ("fgcnn", "mfp")])
def test_graph_models_graph_is_bit_equal_to_eager_steps(dev, name, kind):
    """FiGNN and FGCNN (bf16): a captured graph of 8 steps (after the eager
    warm-up call of 8) against 16 eager steps: the same bits in every
    parameter and buffer, FGCNN's running statistics moved on every
    replayed step as on every eager one."""
    knobs = dict(model=name, groups=4, **ZOO_KNOBS[name])
    eager = _graph_trainer(dev, kind, "bfloat16", "off", 1, **knobs)
    ref = _graph_run(eager)
    graphed = _graph_trainer(dev, kind, "bfloat16", "on", 8, **knobs)
    start = {n: b.clone() for n, b in graphed.model.named_buffers()}
    got = _graph_run(graphed)
    multi = graphed.multi
    assert sorted(multi.graphs) == [1, 8] and multi.graphs[8].replays >= 2
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
    state = graphed.model.state_dict()
    for name_, a in eager.model.state_dict().items():
        assert torch.equal(a, state[name_]), name_
    assert len(start) == (4 if name == "fgcnn" else 0)
    for n, b in start.items():
        assert not torch.equal(state[n], b), n


# ---- resume, the checkpoint writer's snapshot, the streaming eval ---------------------

class _EpochCap:
    """Drives a Trainer's train loop without its evals (the card tests'
    datasets hold a train split only): `epochs` epochs from where a resume
    puts it, the resume state written as calls cross `save_steps`."""

    @staticmethod
    def run(trainer, epochs=None):
        batcher = trainer._prepare_training()
        for i, (epoch, start) in enumerate(trainer._epochs_with_skip(batcher)):
            if epochs is not None and i == epochs:
                break
            for _ in trainer.train_epoch(batcher, epoch, start):
                pass
        trainer._end_run()
        torch.cuda.synchronize()
        return trainer


def _train_state(trainer):
    return {"model": {k: v.clone() for k, v in trainer.model.state_dict().items()},
            "mu": [m.clone() for m in trainer.optimizer.mu],
            "nu": [v.clone() for v in trainer.optimizer.nu],
            "count": trainer.optimizer.count,
            "gens": [g.get_state() for g in (trainer._dropout_generator,
                                             trainer._step_generator) if g is not None]}


@pytest.mark.parametrize("kind", ["supervised", "mfp", "rfd", "pf_shared"])
def test_resume_on_the_graph_path_is_bit_equal(dev, kind, tmp_path):
    """2 epochs of graphs of 4 against 1 epoch (the resume state written at
    step 8, where a call crossed 5) and a resumed run to 2 epochs, whose
    generators, moments and scalar rows restart at step 8 before any
    capture: parameters, buffers, moments, count and generator states
    bit-equal (async checkpoints, bf16). MFP's 'randint' positions repeat in
    a row here at most twice (2 masked of 8 fields), and two gradients
    added from zero by atomics give one sum in either order."""
    from map_tpu_torch.train import checkpoints

    def make(out, **a):
        return _graph_trainer(dev, kind, "bfloat16", "on", 4, groups=2, args_kw=dict(
            save_steps=5, output_dir=str(tmp_path / out), **a))

    straight = _EpochCap.run(make("a"))
    _EpochCap.run(make("b"), epochs=1)
    assert checkpoints.load_train_state(str(tmp_path / "b"))[1]["global_step"] == 8
    resumed = _EpochCap.run(make("b", resume=True))
    assert resumed.multi.graphed and 4 in resumed.multi.graphs
    assert resumed.global_step == straight.global_step == 18
    ref, got = _train_state(straight), _train_state(resumed)
    assert got["count"] == ref["count"] == 18
    for k in ref["model"]:
        assert torch.equal(got["model"][k], ref["model"][k]), k
    for part_ in ("mu", "nu", "gens"):
        for a, b in zip(got[part_], ref[part_]):
            assert torch.equal(a, b), part_


def test_async_snapshot_equals_a_sync_save_while_replays_go_on(dev, tmp_path, monkeypatch):
    """The fetch-mode writer copies on the card before the next replay and
    fetches later (held back 0.3 s here while the replays go on): the saved
    state is the sync save's, bit for bit, not the live one."""
    import time

    from map_tpu_torch.train import checkpoints
    from map_tpu_torch.train import trainer as trainer_mod

    fetch = trainer_mod.fetch_snapshot

    def slow_fetch(snap, done):
        time.sleep(0.3)
        return fetch(snap, done)

    runs = {}
    for name, extra in (("sync", dict(async_checkpoint=False)),
                        ("fetch", dict(async_checkpoint_fetch=True))):
        if name == "fetch":
            monkeypatch.setattr(trainer_mod, "fetch_snapshot", slow_fetch)
        t = _EpochCap.run(_graph_trainer(dev, "mfp", "bfloat16", "on", 4, groups=2,
                                         args_kw=dict(save_steps=7,
                                                      output_dir=str(tmp_path / name),
                                                      **extra)))
        runs[name] = (checkpoints.load_train_state(str(tmp_path / name)), _train_state(t))
    (ref, ref_meta), _ = runs["sync"]
    (got, meta), live = runs["fetch"]
    assert meta == ref_meta and meta["global_step"] == 17  # the last call, 17 -> 18, runs on
    for k, v in ref["model"].items():
        assert torch.equal(got["model"][k], v), k
    assert any(not torch.equal(got["model"][k], live["model"][k].cpu())
               for k in got["model"])
    for part in ("mu", "nu"):
        for a, b in zip(got["optimizer"][part], ref["optimizer"][part]):
            assert torch.equal(a, b), part


def test_streaming_histograms_on_the_card_equal_the_cpus(dev):
    """The streaming eval's reduction on the card: the histograms equal the
    CPU's bucketing of the card's own probabilities (float atomics add
    whole counts exactly), the sums within float32 rounding of the CPU's."""
    import numpy as np

    from map_tpu_torch.train.train_step import streaming_sums

    g = torch.Generator().manual_seed(4)
    n, bins = 50_000, 32768
    logits = torch.randn(n, generator=g) * 2 - 1.5
    labels = (torch.rand(n, generator=g) < torch.sigmoid(logits)).float()
    weight = (torch.arange(n) < n - 77).float()  # padding rows at weight 0
    got = streaming_sums(logits.to(dev), labels.to(dev), weight.to(dev), bins)
    torch.cuda.synchronize()
    probs = torch.sigmoid(logits.to(dev)).cpu().numpy()
    bucket = np.clip((probs * bins).astype(np.int32), 0, bins - 1)
    w, y = weight.numpy(), labels.numpy()
    np.testing.assert_array_equal(got["hist_pos"].cpu().numpy(),
                                  np.bincount(bucket, w * y, bins).astype(np.float32))
    np.testing.assert_array_equal(got["hist_neg"].cpu().numpy(),
                                  np.bincount(bucket, w * (1 - y), bins).astype(np.float32))
    ref = streaming_sums(logits, labels, weight, bins)
    assert float(got["count"]) == float(ref["count"]) == n - 77
    for key in ("ll_sum", "logit_sum", "prob_sum"):
        assert float(got[key]) == pytest.approx(float(ref[key]), rel=1e-5), key


# ---- MFP's masked-position selection, the eval dispatch, the pipelined Predictor -----

def test_select_masked_backward_is_the_slot_order_sum(dev):
    """The canonical per-position shape, (4096, 24, 32) encodings and 7
    'randint' positions a row (fields masked up to 7 times): the backward's
    bits equal the CPU's slot-by-slot sum, twice."""
    from map_tpu_torch.models.base import SelectMasked

    g = torch.Generator().manual_seed(5)
    enc = torch.randn(4096, 24, 32, generator=g)
    idx = torch.randint(0, 24, (4096, 7), generator=g)
    idx[:64] = 3
    up = torch.randn(4096, 7, 32, generator=g)

    def grad(e, i, u):
        e = e.clone().requires_grad_()
        return torch.autograd.grad(SelectMasked.apply(e, i), e, u)[0]

    ref = grad(enc, idx, up)
    got = [grad(enc.to(dev), idx.to(dev), up.to(dev)) for _ in range(2)]
    assert torch.equal(got[0].cpu(), ref) and torch.equal(got[1], got[0])


def _with_valid(trainer, rows):
    """The card tests' dataset with a valid and a test split (the train
    split's first `rows` rows)."""
    d = trainer.dataset
    for split in ("valid", "test"):
        d.X[split], d.Y[split] = d.X["train"][:rows], d.Y["train"][:rows]
    return trainer


def test_mfp_randint_graph_runs_are_bit_equal(dev, tmp_path):
    """Two graph-path MFP runs (per-position, bf16, graphs of 4) from one
    seed with 'randint' positions, 7 masked of 8 fields (a field masked
    three or more times in most rows): every parameter, moment and the
    eval's loss and accuracy bit-equal."""
    runs = []
    for i in range(2):
        t = _graph_trainer(dev, "mfp", "bfloat16", "on", 4, groups=2,
                           args_kw=dict(output_dir=str(tmp_path / str(i)),
                                        per_device_eval_batch_size=256))
        t.args = dataclasses.replace(t.args, mask_ratio=0.9)
        _with_valid(t, 1100)
        _EpochCap.run(t)
        ev = t.MFP_pretrain_eval()
        runs.append((_train_state(t), {k: v for k, v in ev.items() if k != "eval_time_cost"}))
        assert t.multi.graphed and 4 in t.multi.graphs
    (a, ev_a), (b, ev_b) = runs
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    for part_ in ("mu", "nu"):
        for x, y in zip(a[part_], b[part_]):
            assert torch.equal(x, y), part_
    assert ev_a == ev_b


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("kind", ["supervised", "streaming", "mfp", "rfd"])
def test_grouped_eval_graphs_equal_the_eager_pass(dev, kind, dtype, tmp_path):
    """Eval passes of 5 full batches and a padded one in graphs of 4 (the
    first group eager on a side stream, then a graph of 1 and one of 4)
    against the eager pass from the same weights: the same metrics, bit for
    bit, on two passes; the launches that ran (K4 a batch, twice in MFP, K2
    a batch) counted over the eval graphs."""
    from map_tpu_torch.train.graph import launch_counts

    base = "supervised" if kind == "streaming" else kind
    extra = dict(streaming_auc=True, auc_bins=1 << 15) if kind == "streaming" else {}
    out = {}
    for spc in (4, 1):
        before = launch_counts()
        t = _with_valid(_graph_trainer(dev, base, dtype, "on", spc, args_kw=dict(
            output_dir=str(tmp_path / str(spc)), per_device_eval_batch_size=100, **extra)),
            530)
        run = {"mfp": t.MFP_pretrain_eval, "rfd": t.RFD_pretrain_eval}.get(
            base, lambda: t.eval("valid", test_eval=True))
        passes = [{k: v for k, v in run().items() if k != "eval_time_cost"}
                  for _ in range(2)]
        torch.cuda.synchronize()
        ran = t.launches_run({k: v - before[k] for k, v in launch_counts().items()})
        out[spc] = (passes, t, ran)
    (got, grouped, ran), (ref, _, ran_eager) = out[4], out[1]
    assert got == ref and got[0] == got[1]
    d = grouped._evals[{"supervised": "eval"}.get(kind, kind)]
    assert d.graphed and sorted(d.graphs) == [1, 4]
    assert ran == ran_eager
    if kind != "streaming":  # the streaming pass may run again at more bins
        assert ran["embedding_gather"] == (2 if base == "mfp" else 1) * 2 * 6, ran
        assert ran["cross_net"] == 2 * 6, ran


_SERVE_SIZES = [7, 256, 300, 70_000, 24, 65_536, 5, 1_000]  # uint8, uint16, int32 offsets


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("compress,prefetch", [(True, 2), (False, 2), (True, 1)])
def test_pipelined_predictor_is_the_eager_forward(dev, tmp_path, compress, prefetch, dtype):
    """The Predictor's three stages (packed or int32 transfer, the captured
    forward, the logits drained by event) against an eager forward of the
    same padded chunks by a model of the same weights without the cast
    copies: the same bits; one replay a chunk; the launches counted; a bad
    id in a later chunk raised, and the next call whole."""
    import numpy as np

    from map_tpu_torch.serve import Predictor
    from map_tpu_torch.train import checkpoints
    from map_tpu_torch.train.graph import launch_counts

    lo = [int(x) for x in np.cumsum([10] + _SERVE_SIZES[:-1])]
    hi = [a + s for a, s in zip(lo, _SERVE_SIZES)]
    cfg = Config(model_name="dcnv2", input_size=hi[-1], num_fields=8, embed_size=16,
                 hidden_size=64, num_hidden_layers=2, num_cross_layers=2,
                 compute_dtype=dtype, idx_low=lo, idx_high=hi)
    model = models.from_config(cfg, torch.Generator().manual_seed(1))
    checkpoints.save_model(model.state_dict(), str(tmp_path), 1)
    cfg.save(str(tmp_path))
    before = launch_counts()
    pred = Predictor(str(tmp_path), 1, batch_size=1000, prefetch=prefetch,
                     compress_transfer=compress)
    rng = np.random.default_rng(3)
    ids = np.stack([rng.integers(a, b, 3500) for a, b in zip(lo, hi)], 1).astype(np.int32)
    got = pred.predict_logits(ids)
    ran = pred.launches_run({k: v - before[k] for k, v in launch_counts().items()})
    assert pred.replays == 4 and ran["embedding_gather"] == 5 and ran["cross_net"] == 5
    model = model.to(dev).eval()
    ref = []
    with torch.inference_mode():
        for s in range(0, 3500, 1000):
            chunk = pred._check_and_pad(ids[s:s + 1000], s)
            ref.append(model(torch.from_numpy(chunk).to(dev)).reshape(-1).float().cpu())
    ref = torch.cat(ref).numpy()[:3500]
    np.testing.assert_array_equal(got, ref)
    bad = ids.copy()
    bad[2500, 3] = hi[3] if compress else hi[-1]
    with pytest.raises(ValueError, match="leave"):
        pred.predict_logits(bad)
    np.testing.assert_array_equal(pred.predict_logits(ids), got)
