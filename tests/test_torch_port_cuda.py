"""map_tpu_torch CUDA kernels against their plain versions, on the card.

Marked `cuda`: each test skips without a CUDA device. On a machine with one
(and without JAX) run them as
    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py -q
Shapes here are the awkward ones (odd batch, ragged D, E not a multiple of
4); chip_smoke.py holds the same kernels at the serving shapes.
"""

import pytest
import torch

from map_tpu_torch.ops import cross, embedding

pytestmark = pytest.mark.cuda

TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2e-2, 2e-2)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("e", [16, 12, 1, 64])
@pytest.mark.parametrize("out_dtype", [None, torch.bfloat16])
def test_gather_is_exact(dev, e, out_dtype):
    g = torch.Generator().manual_seed(e)
    table = torch.randn(1001, e, generator=g).to(dev)
    ids = torch.randint(0, 1001, (37, 5), generator=g, dtype=torch.int32).to(dev)
    before = embedding.launches
    out = embedding.embedding_lookup(table, ids, out_dtype)
    assert embedding.launches == before + 1
    assert out.shape == (37, 5, e)
    ref = embedding.embedding_lookup_plain(table, ids, out_dtype)
    assert out.dtype == ref.dtype and torch.equal(out, ref)


def test_gather_rejects_what_it_does_not_take(dev):
    table = torch.randn(10, 16, device=dev)
    with pytest.raises(ValueError):
        embedding.embedding_lookup(table, torch.zeros(3, dtype=torch.int64, device=dev))
    with pytest.raises(ValueError):
        embedding.embedding_lookup(table.double(),
                                   torch.zeros(3, dtype=torch.int32, device=dev))
    with pytest.raises(NotImplementedError):
        embedding.embedding_lookup(table.requires_grad_(),
                                   torch.zeros(3, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch,d,layers", [(37, 40, 2), (130, 384, 3),
                                            (1, 624, 1), (200, 1000, 2),
                                            (19, 37, 3), (70, 100, 2)])
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
    torch.testing.assert_close(cross.cross_net(x0, w, b), y, atol=0, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cross_reads_unaligned_weights(dev, dtype):
    # w starts one element into its buffer: not 16-byte aligned, so the kernel
    # reads W element by element
    g = torch.Generator().manual_seed(3)
    d, layers = 128, 2
    x0 = (torch.randn(50, d, generator=g) * 0.3).to(dev, dtype)
    buf = (torch.randn(layers * d * d + 1, generator=g) / d ** 0.5).to(dev, dtype)
    w = buf[1:].view(layers, d, d)
    assert w.is_contiguous() and w.data_ptr() % 16 != 0
    b = (torch.randn(layers, d, generator=g) * 0.1).to(dev, dtype)
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(cross.cross_net(x0, w, b).float(),
                               cross.cross_net_plain(x0, w, b).float(),
                               atol=atol, rtol=rtol)


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
