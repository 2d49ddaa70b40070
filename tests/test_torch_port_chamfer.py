"""Port parity: the chamfer search and loss of soft_intro_vae_torch.ops.chamfer
against the JAX package's Pallas kernel, run interpreted on the CPU.

``nearest_plain`` is the CPU path of the port's CUDA kernel and its oracle on
the card; here it is held to ``_nearest(..., interpret=True)`` on the cases of
tests/test_chamfer_pallas.py: minima at rtol 1e-6 (both compute
(dx*dx + dy*dy) + dz*dz in f32; XLA may fuse a step into an FMA), argmins
equal. The loss and its gradients are held to ``chamfer_distance_pallas``:
loss rtol 1e-4/atol 1e-5 and gradients rtol 1e-3/atol 1e-4, the tolerances of
tests/test_chamfer_pallas.py (scatter-adds sum in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soft_intro_vae_tpu.ops.chamfer_pallas import _nearest, chamfer_distance_pallas
from soft_intro_vae_torch.ops import chamfer, chamfer_cuda, cuda_build
from tests.torch_port_fixtures import one_torch_thread  # noqa: F401

# (B, N_preds, M_gts, pallas tile) — the cases of tests/test_chamfer_pallas.py
CASES = [(2, 64, 64, 32), (3, 48, 96, 16), (1, 24, 24, 256), (2, 32, 40, 16), (4, 128, 128, 64)]


def _clouds(b, n, m, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, n, 3).astype(np.float32) * 0.3,
            rs.randn(b, m, 3).astype(np.float32) * 0.3)


@pytest.mark.parametrize("b,n,m,tile", CASES)
def test_nearest_plain_matches_pallas_interpret(b, n, m, tile):
    preds, gts = _clouds(b, n, m, seed=n + m)
    min_g, amin_g, min_p, amin_p = _nearest(jnp.asarray(gts), jnp.asarray(preds), tile, True)
    d_g, i_g = chamfer.nearest_plain(torch.tensor(gts), torch.tensor(preds))
    d_p, i_p = chamfer.nearest_plain(torch.tensor(preds), torch.tensor(gts))
    np.testing.assert_allclose(d_g.numpy(), np.asarray(min_g), rtol=1e-6)
    np.testing.assert_allclose(d_p.numpy(), np.asarray(min_p), rtol=1e-6)
    np.testing.assert_array_equal(i_g.numpy(), np.asarray(amin_g))
    np.testing.assert_array_equal(i_p.numpy(), np.asarray(amin_p))
    assert i_g.dtype == torch.int64  # torch.gather takes it as it is


@pytest.mark.parametrize("b,n,m,tile", CASES)
def test_nearest_pair_plain_matches_pallas_interpret(b, n, m, tile):
    # x = gts, y = preds, as _chamfer_fwd_impl calls _nearest
    preds, gts = _clouds(b, n, m, seed=3 * n + m)
    want = _nearest(jnp.asarray(gts), jnp.asarray(preds), tile, True)
    got = chamfer.nearest_pair_plain(torch.tensor(gts), torch.tensor(preds))
    for g, w in zip(got[0::2], want[0::2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    for g, w in zip(got[1::2], want[1::2]):
        assert g.dtype == torch.int64
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert [tuple(g.shape) for g in got] == [(b, m), (b, m), (b, n), (b, n)]


def _tie_clouds(kind, b, n, m, seed):
    rs = np.random.RandomState(seed)
    if kind == "random":
        return _clouds(b, n, m, seed)
    if kind == "grid":  # coordinates on a coarse grid: many equal distances
        return (np.round(rs.randn(b, n, 3) * 4) / 8).astype(np.float32), \
            (np.round(rs.randn(b, m, 3) * 4) / 8).astype(np.float32)
    # a few distinct points, each repeated at indices far apart (other tiles,
    # other cluster ranks of the kernel)
    base = (rs.randn(b, 5, 3) * 0.3).astype(np.float32)
    return (np.take_along_axis(base, rs.randint(0, 5, (b, n, 1)), axis=1),
            np.take_along_axis(base, rs.randint(0, 5, (b, m, 1)), axis=1))


@pytest.mark.parametrize("kind", ["random", "grid", "repeated"])
@pytest.mark.parametrize("b,n,m", [(2, 64, 40), (1, 300, 257), (3, 17, 1001)])
def test_nearest_pair_plain_halves_are_nearest_plain(kind, b, n, m):
    # the per-y half is bit-identical to nearest_plain(y, x), the per-x half
    # to nearest_plain(x, y): the kernel is held to both on the card
    x, y = (torch.tensor(c) for c in _tie_clouds(kind, b, n, m, seed=n * m))
    min_x, amin_x, min_y, amin_y = chamfer.nearest_pair_plain(x, y)
    d_y, i_y = chamfer.nearest_plain(y, x)
    d_x, i_x = chamfer.nearest_plain(x, y)
    assert torch.equal(min_y.view(torch.int32), d_y.view(torch.int32))
    assert torch.equal(amin_y, i_y)
    assert torch.equal(min_x.view(torch.int32), d_x.view(torch.int32))
    assert torch.equal(amin_x, i_x)
    if kind != "random":  # ties were there to break, and the first index won
        d = chamfer.pairwise_sqdist(x, y)
        assert int((d == min_y[:, None, :]).sum()) > min_y.numel()
        first = (d == min_y[:, None, :]).int().argmax(dim=1)
        assert torch.equal(amin_y, first)


def test_nearest_plain_first_index_on_ties():
    # b holds the same point twice and a point at the same distance: index 0 wins
    a = torch.tensor([[[0.0, 0.0, 0.0], [1.0, 0.0, 0.0]]])
    b = torch.tensor([[[0.5, 0.0, 0.0], [0.5, 0.0, 0.0], [-0.5, 0.0, 0.0]]])
    d, i = chamfer.nearest_plain(a, b)
    assert i.tolist() == [[0, 0]]
    assert d.tolist() == [[0.25, 0.25]]


@pytest.mark.parametrize("b,n,m,tile", CASES[1:4])  # rectangular, odd tile, the grads case
def test_chamfer_loss_and_grads_match_pallas(b, n, m, tile):
    preds, gts = _clouds(b, n, m, seed=7 * n + m)
    w = np.random.RandomState(1).rand(b).astype(np.float32)  # a non-uniform cotangent

    def f(p, g):
        return jnp.sum(chamfer_distance_pallas(p, g, tile) * w)

    ref = chamfer_distance_pallas(jnp.asarray(preds), jnp.asarray(gts), tile)
    rgp, rgg = jax.grad(f, argnums=(0, 1))(jnp.asarray(preds), jnp.asarray(gts))

    p = torch.tensor(preds, requires_grad=True)
    g = torch.tensor(gts, requires_grad=True)
    got = chamfer.chamfer_distance(p, g)
    gp, gg = torch.autograd.grad((got * torch.tensor(w)).sum(), (p, g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(gp.numpy(), np.asarray(rgp), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(gg.numpy(), np.asarray(rgg), rtol=1e-3, atol=1e-4)


def test_grads_match_dense_autograd():
    preds, gts = _clouds(2, 32, 40, 5)
    p = torch.tensor(preds, requires_grad=True)
    g = torch.tensor(gts, requires_grad=True)
    gp, gg = torch.autograd.grad(chamfer.chamfer_distance(p, g).sum(), (p, g))
    p2 = torch.tensor(preds, requires_grad=True)
    g2 = torch.tensor(gts, requires_grad=True)
    dist = chamfer.pairwise_sqdist(g2, p2)
    ref = dist.min(dim=1).values.sum(dim=1) + dist.min(dim=2).values.sum(dim=1)
    rp, rg = torch.autograd.grad(ref.sum(), (p2, g2))
    torch.testing.assert_close(gp, rp, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(gg, rg, rtol=1e-5, atol=1e-6)


def test_zero_for_identical():
    x = torch.tensor(_clouds(2, 32, 32, 4)[0])
    assert float(chamfer.chamfer_distance(x, x.clone()).abs().max()) == 0.0


def test_dispatch_on_cpu_never_reaches_the_kernel():
    preds, gts = (torch.tensor(c) for c in _clouds(2, 16, 16, 6))
    before = cuda_build.launches["chamfer_nearest"]
    auto = chamfer.chamfer_distance(preds, gts, "auto")
    plain = chamfer.chamfer_distance(preds, gts, "plain")
    torch.testing.assert_close(auto, plain, rtol=0, atol=0)
    assert cuda_build.launches["chamfer_nearest"] == before
    with pytest.raises(ValueError, match="CUDA"):
        chamfer.chamfer_distance(preds, gts, "cuda")
    with pytest.raises(NotImplementedError):
        chamfer.chamfer_distance(preds, gts, "xla")


def test_kernel_wrapper_validates_its_inputs():
    x = torch.zeros(1, 4, 3)
    with pytest.raises(ValueError, match="CUDA tensor"):
        chamfer_cuda.nearest_pair_cuda(x, x)


def test_library_path_is_keyed_by_source(tmp_path, monkeypatch):
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    monkeypatch.setattr(chamfer_cuda, "_SRC", str(src))
    first = chamfer_cuda.library_path()
    src.write_text("// two\n")
    assert chamfer_cuda.library_path() != first
    assert first.startswith(chamfer_cuda._BUILD_DIR)
