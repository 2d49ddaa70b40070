"""Port parity: the FID stack (soft_intro_vae_torch.metrics.fid) against the
JAX package's metrics/fid.py, block by block on the CPU.

* The pools: the count_include_pad=False 3x3 average pool and both max pools.
* Each Inception block (BasicConv2d, A, B, C, D, E with either pool) at a
  small spatial size (5x5 to 9x9) and narrow inputs, and the stem taps (0,)
  and (0, 1) at 75x75: the JAX block's variables (BN statistics and affine
  drawn at random, so eval mode is exercised) carried across by
  ``inception_state_dict_from_jax``; outputs within 1e-5 of the output's
  largest magnitude (measured: 4.5e-7 at most).
* The resize to 299x299 against ``jax.image.resize(..., "bilinear")``: at
  32 -> 299 within 1e-6 (upsampling, plain bilinear; measured 1.8e-7), at
  512 -> 299 within 5e-6 (antialiased, measured 2.3e-6; without it the two
  differ by ~0.5).
* The BN calibration of the random-init fallback on the stem taps against
  the JAX package's calibrate-mode pass and its recovery of the batch
  statistics from flax's running update: within rtol 2e-4 + atol 2e-5
  (measured: 2.8e-5 at most, on statistics up to 4.5; the recovery
  (new - 0.9 old) / 0.1 rounds in float32).
* ``frechet_distance`` (Newton-Schulz and scipy) within rel 1e-4 of the JAX
  one; ``compute_statistics_streaming`` equal for uint8 batches and the same
  batches as x / 255 floats, and within rel 1e-5 of the JAX one.
* A pt_inception ``.pth`` under pytorch-fid's names found on disk, loaded
  (fc and AuxLogits dropped), and read by the JAX package's converter.

The whole network at 299x299 against the JAX package, and the fallback's
calibration on the full network, are in test_torch_port_fid_slow.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soft_intro_vae_tpu.metrics import fid as jfid
from soft_intro_vae_torch.metrics import fid
from soft_intro_vae_torch.utils.from_jax import inception_state_dict_from_jax
from tests.torch_port_fixtures import one_torch_thread  # noqa: F401

BLOCK_RTOL = 1e-5


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _randomize_bn(variables, seed=0):
    """BN affine and statistics drawn at random (the init's are the identity)."""
    rs = np.random.RandomState(seed)

    def walk(params, stats):
        if "bn" in params:  # a BasicConv2d
            c = params["bn"]["scale"].shape[0]
            params["bn"] = {"scale": rs.rand(c).astype(np.float32) + 0.5,
                            "bias": 0.1 * rs.randn(c).astype(np.float32)}
            stats["bn"] = {"mean": 0.1 * rs.randn(c).astype(np.float32),
                           "var": rs.rand(c).astype(np.float32) + 0.5}
            return
        for name in params:
            walk(params[name], stats[name])

    params = jax.tree_util.tree_map(np.array, variables["params"])
    stats = jax.tree_util.tree_map(np.array, variables["batch_stats"])
    walk(params, stats)
    return {"params": params, "batch_stats": stats}


def _carry(variables, module):
    module.load_state_dict(inception_state_dict_from_jax(variables["params"],
                                                         variables["batch_stats"]), strict=False)
    missing = set(module.state_dict()) - set(inception_state_dict_from_jax(
        variables["params"], variables["batch_stats"]))
    assert all(k.endswith("num_batches_tracked") for k in missing), missing
    return module.eval()


def _rel_err(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("kind", ["avg_no_pad", "max_same", "max_stride2"])
def test_pools_match_jax(kind):
    x = np.random.RandomState(1).randn(2, 9, 7, 5).astype(np.float32)
    if kind == "avg_no_pad":
        got, want = fid.avg_pool_no_pad(_nchw(x)), jfid.avg_pool_no_pad(jnp.asarray(x))
    elif kind == "max_same":  # Mixed_7c's pool branch
        got = torch.nn.functional.max_pool2d(_nchw(x), 3, 1, 1)
        want = jfid.max_pool(jnp.asarray(x), 3, 1, same=True)
    else:
        got = torch.nn.functional.max_pool2d(_nchw(x), 3, 2)
        want = jfid.max_pool(jnp.asarray(x), 3, 2)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=1e-6, atol=1e-6)


# (name, JAX block, port block, input (B, H, W, C))
BLOCKS = {
    "BasicConv2d": (lambda: jfid.BasicConv2d(24, (3, 3), stride=2, padding=(1, 1)),
                    lambda: fid.BasicConv2d(5, 24, kernel_size=3, stride=2, padding=1), (2, 9, 9, 5)),
    "InceptionA": (lambda: jfid.InceptionA(32), lambda: fid.InceptionA(16, 32), (2, 7, 7, 16)),
    "InceptionB": (lambda: jfid.InceptionB(), lambda: fid.InceptionB(16), (2, 9, 9, 16)),
    "InceptionC": (lambda: jfid.InceptionC(24), lambda: fid.InceptionC(16, 24), (2, 7, 7, 16)),
    "InceptionD": (lambda: jfid.InceptionD(), lambda: fid.InceptionD(16), (2, 9, 9, 16)),
    "InceptionE_avg": (lambda: jfid.InceptionE("avg"), lambda: fid.InceptionE(16, "avg"),
                       (2, 5, 5, 16)),
    "InceptionE_max": (lambda: jfid.InceptionE("max"), lambda: fid.InceptionE(16, "max"),
                       (2, 5, 5, 16)),
}


@pytest.mark.parametrize("name", list(BLOCKS))
def test_each_block_matches_jax(name):
    make_jax, make_port, shape = BLOCKS[name]
    jblock = make_jax()
    x = np.random.RandomState(2).randn(*shape).astype(np.float32)
    variables = _randomize_bn(jax.jit(jblock.init)(jax.random.key(0), jnp.asarray(x)))
    want = np.asarray(jax.jit(jblock.apply)(variables, jnp.asarray(x)))
    torch.manual_seed(0)
    block = _carry(variables, make_port())
    with torch.no_grad():
        got = _nhwc(block(_nchw(x)))
    assert got.shape == want.shape
    assert _rel_err(got, want) <= BLOCK_RTOL, _rel_err(got, want)


@pytest.mark.parametrize("blocks", [(0,), (0, 1)], ids=["tap0", "taps01"])
def test_stem_taps_match_jax(blocks):
    jnet = jfid.InceptionV3FID(resize_input=False, output_blocks=blocks)
    x = np.random.RandomState(3).rand(2, 75, 75, 3).astype(np.float32)
    variables = _randomize_bn(jax.jit(jnet.init)(jax.random.key(0), jnp.asarray(x)))
    want = jax.jit(jnet.apply)(variables, jnp.asarray(x))
    net = _carry(variables, fid.InceptionV3FID(output_blocks=blocks, resize_input=False))
    assert ("Conv2d_3b_1x1.conv.weight" in net.state_dict()) == (1 in blocks)
    assert not any(k.startswith("Mixed_") for k in net.state_dict())
    with torch.no_grad():
        got = net(_nchw(x))
    assert len(got) == len(want) == len(blocks)
    for g, w in zip(got, want):
        assert _nhwc(g).shape == w.shape
        assert _rel_err(_nhwc(g), np.asarray(w)) <= BLOCK_RTOL


def test_output_blocks_and_tap_dims():
    assert fid.BLOCK_INDEX_BY_DIM == jfid.BLOCK_INDEX_BY_DIM
    with pytest.raises(ValueError, match="output_blocks"):
        fid.InceptionV3FID(output_blocks=(4,))
    net = fid.InceptionV3FID(output_blocks=(3, 0, 1, 2), resize_input=False)
    with torch.no_grad():
        taps = net.eval()(torch.rand(1, 3, 75, 75))
    assert [t.shape[1] for t in taps] == [64, 192, 768, 2048] and taps[3].shape == (1, 2048)


@pytest.mark.parametrize("size, atol", [(32, 1e-6), (512, 5e-6)])
def test_resize_matches_jax_image_resize(size, atol):
    x = np.random.RandomState(4).rand(2, size, size, 3).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 299, 299, 3), "bilinear"))
    got = _nhwc(fid.resize_to_inception(_nchw(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    if size > 299:  # pytorch-fid's plain bilinear would be another resize
        plain = torch.nn.functional.interpolate(_nchw(x), size=(299, 299), mode="bilinear",
                                                align_corners=False)
        assert np.abs(_nhwc(plain) - want).max() > 0.1


def test_calibration_matches_the_jax_recovery_on_the_stem():
    """The JAX package's calibrate-mode pass (batch statistics, then
    (new - 0.9 old) / 0.1 out of flax's running update) and the port's one
    pass that takes each BN's batch mean and biased variance, on the same
    variables and batch: the same statistics, layer after layer."""
    blocks = (0, 1)
    jnet = jfid.InceptionV3FID(resize_input=False, output_blocks=blocks)
    x = np.asarray(jax.random.uniform(jax.random.key(1), (8, 75, 75, 3)))
    variables = jax.jit(jnet.init)(jax.random.key(0), jnp.asarray(x))
    calib = jfid.InceptionV3FID(resize_input=False, calibrate=True, output_blocks=blocks)
    _, upd = jax.jit(lambda v, x: calib.apply(v, x, mutable=["batch_stats"]))(variables, x)
    want = jax.tree_util.tree_map(lambda new, old: np.asarray((new - 0.9 * old) / 0.1),
                                  upd["batch_stats"], variables["batch_stats"])
    net = _carry(jax.tree_util.tree_map(np.array, variables),
                 fid.InceptionV3FID(output_blocks=blocks, resize_input=False))
    fid.calibrate_random_init(net, _nchw(x))
    got = net.state_dict()
    for key, w in inception_state_dict_from_jax(jax.tree_util.tree_map(np.array, variables["params"]),
                                                want).items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[key].numpy(), w.numpy(), rtol=2e-4, atol=2e-5,
                                       err_msg=key)
    assert not net.training  # calibrated, then left in eval mode


def test_newton_schulz_sqrtm_matches_scipy():
    from scipy import linalg

    rs = np.random.RandomState(5)
    a = rs.randn(32, 16)
    s = a @ a.T + 0.1 * np.eye(32)
    got = fid.sqrtm_newton_schulz(torch.tensor(s), iters=40).numpy()
    np.testing.assert_allclose(got, linalg.sqrtm(s).real, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("method", ["newton", "scipy"])
def test_frechet_distance_matches_jax(method):
    rs = np.random.RandomState(6)
    mu1, mu2 = rs.randn(24), rs.randn(24)
    s1 = np.cov(rs.randn(300, 24), rowvar=False)
    s2 = np.cov(rs.randn(300, 24) * 1.5 + 0.3, rowvar=False)
    got = fid.frechet_distance(mu1, s1, mu2, s2, method=method, device="cpu")
    want = jfid.frechet_distance(mu1, s1, mu2, s2, method=method)
    assert got == pytest.approx(want, rel=1e-4)
    assert fid.frechet_distance(mu1, s1, mu1, s1, method=method, device="cpu") == pytest.approx(
        0.0, abs=1e-2)


def test_frechet_falls_back_to_scipy_when_newton_is_not_finite(monkeypatch):
    rs = np.random.RandomState(7)
    mu1, mu2 = rs.randn(8), rs.randn(8)
    s1, s2 = np.cov(rs.randn(50, 8), rowvar=False), np.cov(rs.randn(50, 8), rowvar=False)
    want = fid.frechet_distance(mu1, s1, mu2, s2, method="scipy")
    monkeypatch.setattr(fid, "sqrtm_newton_schulz", lambda a: torch.full_like(a, float("nan")))
    assert fid.frechet_distance(mu1, s1, mu2, s2, device="cpu") == want
    with pytest.raises(ValueError, match="method"):
        fid.frechet_distance(mu1, s1, mu2, s2, method="svd", device="cpu")


class _LinearFeatures:
    """A stand-in feature net on the CPU: tanh of a fixed projection of the
    first 48 pixel values."""

    device = torch.device("cpu")

    def __init__(self):
        self.w = np.random.RandomState(8).randn(48, 16).astype(np.float32) * 0.2

    def __call__(self, x):  # (B, C, H, W)
        flat = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)[:, :48]
        return torch.tanh(flat @ torch.from_numpy(self.w))

    def jax(self, x):  # (B, H, W, C)
        return jnp.tanh(x.reshape(x.shape[0], -1)[:, :48] @ jnp.asarray(self.w))


def test_statistics_of_uint8_and_float_batches_are_equal_and_match_jax():
    u8 = np.random.default_rng(0).integers(0, 256, (5, 8, 4, 4, 3), dtype=np.uint8)
    feats = _LinearFeatures()
    mu_u, cov_u = fid.compute_statistics_streaming(feats, iter(u8))
    mu_f, cov_f = fid.compute_statistics_streaming(
        feats, (b.astype(np.float32) / np.float32(255) for b in u8))
    np.testing.assert_array_equal(mu_u, mu_f)
    np.testing.assert_array_equal(cov_u, cov_f)
    mu_j, cov_j = jfid.compute_statistics_streaming(feats.jax, iter(u8))
    np.testing.assert_allclose(mu_u, mu_j, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(cov_u, cov_j, rtol=1e-5, atol=1e-7)
    assert mu_u.dtype == cov_u.dtype == np.float64 and cov_u.shape == (16, 16)
    with pytest.raises(ValueError, match="2 samples"):
        fid.compute_statistics_streaming(feats, iter(u8[:1, :1]))
    # a torch batch on the device goes as it is; the distance of a set to itself is ~0
    d = fid.fid_between_batches(feats, [torch.from_numpy(u8[0])], [torch.from_numpy(u8[0])])
    assert d == pytest.approx(0.0, abs=1e-3)


@pytest.mark.parametrize("kind", ["uint8", "float"])
def test_the_network_takes_nchw_contiguous_input(kind):
    """u8norm gives a channels-last batch (the image nets' layout); the FID
    network still gets NCHW-contiguous input, the layout its speed and pool3
    were measured in."""
    u8 = np.random.default_rng(1).integers(0, 256, (2, 4, 4, 4, 3), dtype=np.uint8)
    feats, seen = _LinearFeatures(), []

    def recording(x):
        seen.append(x.is_contiguous())
        return feats(x)

    recording.device = feats.device
    batches = u8 if kind == "uint8" else u8.astype(np.float32) / np.float32(255)
    fid.compute_statistics_streaming(recording, iter(batches))
    assert seen == [True, True]


def _fake_pt_inception(tmp_path):
    torch.manual_seed(1)
    net = fid.InceptionV3FID()
    sd = {k: torch.randn_like(v) if v.is_floating_point() else v
          for k, v in net.state_dict().items() if not k.endswith("num_batches_tracked")}
    sd["fc.weight"], sd["fc.bias"] = torch.zeros(1008, 2048), torch.zeros(1008)
    sd["AuxLogits.conv0.conv.weight"] = torch.zeros(128, 768, 1, 1)
    path = tmp_path / fid.FID_WEIGHTS_FILENAME
    torch.save(sd, path)
    return sd


def test_pt_inception_file_on_disk_loads_under_pytorch_fid_names(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(fid, "CACHE_DIR", str(tmp_path / "cache"))
    assert fid.fid_weights_path() is None
    sd = _fake_pt_inception(tmp_path)
    assert fid.fid_weights_path() == str(tmp_path / fid.FID_WEIGHTS_FILENAME)
    monkeypatch.setattr(fid, "_FID_NETWORK_CACHE", {})
    feats = fid.load_fid_network(device="cpu")  # no calibration pass, no warning
    got = feats.net.state_dict()
    for k, v in sd.items():
        if not k.startswith(("fc.", "AuxLogits.")):
            torch.testing.assert_close(got[k], v, rtol=0, atol=0, msg=k)
    assert fid.load_fid_network(device="cpu") is feats  # cached per process
    # the JAX package's converter reads every conv and BN tensor of the file
    template = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype),
        jax.eval_shape(jfid.InceptionV3FID().init, jax.random.key(0),
                       jax.ShapeDtypeStruct((1, 32, 32, 3), jnp.float32)))
    conv = jfid.params_from_torch_state_dict(sd, template)
    back = inception_state_dict_from_jax(conv["params"], conv["batch_stats"])
    assert set(back) == set(got)
    for k, v in sd.items():
        if not k.startswith(("fc.", "AuxLogits.")):
            torch.testing.assert_close(back[k], v, rtol=0, atol=0, msg=k)
    # a file that lacks a tensor of the network is refused
    del sd["Mixed_7c.branch_pool.bn.running_var"]
    with pytest.raises(KeyError, match="missing"):
        fid.load_pt_inception(fid.InceptionV3FID(), sd)


def test_the_fid_network_is_the_pt_inception_trunk():
    n_port = sum(p.numel() for p in fid.InceptionV3FID().parameters())
    shapes = jax.eval_shape(jfid.InceptionV3FID().init, jax.random.key(0),
                            jax.ShapeDtypeStruct((1, 32, 32, 3), jnp.float32))
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))
    assert n_port == n_jax == 21_785_568


def test_tf32_context_restores_the_flags():
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    with fid.tf32(False):
        assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
    assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == saved
