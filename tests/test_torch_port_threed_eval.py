"""Port parity: the rest of the 3D path against the JAX package.

  * ``data/transforms3d.py`` and ``data/rotation_conversions.py`` (numpy in
    both packages) equal the JAX package's within 1e-6 on the same inputs;
  * ``data/modelnet.py`` reads the same splits from HDF5 shards made here;
  * ``utils/mitsuba.py`` writes byte-identical XML scenes;
  * ``cli/eval_3d.py``: with the JAX package's 3D nets (moved off their init,
    BN statistics included) carried across by ``utils/from_jax.py``, the
    port's decode of injected latents and its eval-mode encoder mean are
    within 1e-5 of the JAX package's; the JSD of the same clouds is equal
    exactly; the test-split JSD of a port checkpoint on the JAX package's
    own draws equals the JAX ``_jsd_vs_samples`` value within 1e-6 (the
    decoded clouds differ by float rounding, which moves no point across a
    voxel here); the subcommands run on the CPU (``--device cpu``).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soft_intro_vae_tpu.cli import eval_3d as jeval
from soft_intro_vae_tpu.data import modelnet as jmodelnet
from soft_intro_vae_tpu.data import rotation_conversions as jrc
from soft_intro_vae_tpu.data import transforms3d as jt3d
from soft_intro_vae_tpu.metrics.jsd import jsd_between_point_cloud_sets as jax_jsd
from soft_intro_vae_tpu.train.threed import ThreeDConfig as JaxThreeDConfig
from soft_intro_vae_tpu.train.threed import build_3d_training as jax_build_3d_training
from soft_intro_vae_tpu.utils import mitsuba as jmitsuba
from soft_intro_vae_torch.cli import eval_3d
from soft_intro_vae_torch.data import modelnet, transforms3d as t3d
from soft_intro_vae_torch.data import rotation_conversions as rc
from soft_intro_vae_torch.metrics.jsd import jsd_between_point_cloud_sets
from soft_intro_vae_torch.train.threed import ThreeDConfig
from soft_intro_vae_torch.utils import mitsuba
from soft_intro_vae_torch.utils.checkpoint import Checkpointer
from soft_intro_vae_torch.utils.from_jax import pointnet_state_dict_from_jax
from tests.torch_port_fixtures import one_torch_thread  # noqa: F401

RS = np.random.RandomState(3)
PTS = RS.randn(2, 16, 3).astype(np.float32)
ANG = RS.uniform(-180, 180, 2).astype(np.float32)
QUAT = RS.randn(5, 4)
AA = RS.randn(5, 3)
MAT = jrc.random_rotations(5, np.random.default_rng(0))
D6 = RS.randn(5, 6)

# (name, f(module) -> array); each runs on the port's module and the JAX package's
TRANSFORMS = [
    ("axis_angle_matrix", lambda m: np.stack([m.axis_angle_matrix(a, ANG) for a in "XYZ"])),
    ("euler_matrix", lambda m: m.euler_matrix(np.stack([ANG, ANG / 2, -ANG], -1), "ZYX")),
    ("rotate_points", lambda m: m.rotate_points(PTS, m.axis_angle_matrix("Z", ANG))),
    ("RotateAxisAngle", lambda m: m.RotateAxisAngle(ANG[0], "Y").transform_points(PTS)),
    ("Compose", lambda m: m.Compose([m.unit_sphere_normalize,
                                     lambda p: p * 2.0])(PTS[0])),
    ("jitter", lambda m: m.jitter(PTS, np.random.default_rng(1), sigma=0.02, clip=0.05)),
    ("check_valid_rotation_matrix", lambda m: np.asarray(
        [m.check_valid_rotation_matrix(MAT), m.check_valid_rotation_matrix(MAT * 1.1)])),
    ("Transform3d", lambda m: m.Transform3d().translate(1.0, 2.0, -1.0).scale(0.5)
     .rotate_axis_angle(30.0, "X").transform_points(PTS)),
    ("Transform3d.inverse", lambda m: m.Translate(1.0, 0.5, 0.0).compose(
        m.Scale(2.0, 1.0, 3.0), m.RotateAxisAngleTransform(ANG[1], "Z")).inverse().get_matrix()),
    ("transform_normals", lambda m: m.Rotate(MAT[:1].astype(np.float32)).scale(2.0)
     .transform_normals(PTS[:1])),
]
ROTATIONS = [
    ("standardize_quaternion", lambda m: m.standardize_quaternion(QUAT)),
    ("quaternion_multiply", lambda m: m.quaternion_multiply(QUAT, QUAT[::-1])),
    ("quaternion_raw_multiply", lambda m: m.quaternion_raw_multiply(QUAT, QUAT[::-1])),
    ("quaternion_invert", lambda m: m.quaternion_invert(QUAT)),
    ("quaternion_apply", lambda m: m.quaternion_apply(QUAT / np.linalg.norm(
        QUAT, axis=-1, keepdims=True), AA)),
    ("quaternion_to_matrix", lambda m: m.quaternion_to_matrix(QUAT)),
    ("matrix_to_quaternion", lambda m: m.matrix_to_quaternion(MAT)),
    ("axis_angle_to_quaternion", lambda m: m.axis_angle_to_quaternion(AA)),
    ("quaternion_to_axis_angle", lambda m: m.quaternion_to_axis_angle(QUAT)),
    ("axis_angle_to_matrix", lambda m: m.axis_angle_to_matrix(AA)),
    ("matrix_to_axis_angle", lambda m: m.matrix_to_axis_angle(MAT)),
    ("euler_angles_to_matrix", lambda m: m.euler_angles_to_matrix(AA, "XYZ")),
    ("matrix_to_euler_angles", lambda m: np.stack(
        [m.matrix_to_euler_angles(MAT, c) for c in ("XYZ", "ZYX", "XZX")])),
    ("random_rotations", lambda m: m.random_rotations(4, np.random.default_rng(5))),
    ("random_rotation", lambda m: m.random_rotation(np.random.default_rng(6))),
    ("random_quaternions", lambda m: m.random_quaternions(4, np.random.default_rng(7))),
    ("rotation_6d_to_matrix", lambda m: m.rotation_6d_to_matrix(D6)),
    ("matrix_to_rotation_6d", lambda m: m.matrix_to_rotation_6d(MAT)),
]


@pytest.mark.parametrize("name,fn", TRANSFORMS, ids=[n for n, _ in TRANSFORMS])
def test_transforms3d_match_the_jax_package(name, fn):
    np.testing.assert_allclose(fn(t3d), fn(jt3d), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name,fn", ROTATIONS, ids=[n for n, _ in ROTATIONS])
def test_rotation_conversions_match_the_jax_package(name, fn):
    np.testing.assert_allclose(fn(rc), fn(jrc), rtol=1e-6, atol=1e-6)


def test_modelnet_splits_match_the_jax_package(tmp_path):
    h5py = pytest.importorskip("h5py")
    rs = np.random.RandomState(0)
    for name in ("ply_data_train0.h5", "ply_data_train1.h5", "ply_data_test0.h5"):
        with h5py.File(tmp_path / name, "w") as f:
            f["data"] = rs.randn(10, 32, 3).astype(np.float32)
            f["label"] = rs.randint(0, 40, (10, 1))
    for split in ("train", "valid", "test"):
        got = modelnet.ModelNet40(str(tmp_path), split, valid_percent=0.2, n_points=16, seed=2)
        ref = jmodelnet.ModelNet40(str(tmp_path), split, valid_percent=0.2, n_points=16, seed=2)
        np.testing.assert_array_equal(got.points, ref.points)
        np.testing.assert_array_equal(got.labels, ref.labels)
        assert len(got) == len(ref) and got[1][1] == ref[1][1]
    with pytest.raises(ValueError, match="Invalid split"):
        modelnet.ModelNet40(str(tmp_path), "dev")
    with pytest.raises(FileNotFoundError):
        modelnet.ModelNet40(str(tmp_path / "none"))


def test_mitsuba_scenes_are_the_jax_package_bytes(tmp_path):
    clouds = np.random.RandomState(1).rand(3, 40, 3).astype(np.float32)
    assert mitsuba.pointcloud_to_xml(clouds[0], 32, seed=4) == \
        jmitsuba.pointcloud_to_xml(clouds[0], 32, seed=4)
    np.save(tmp_path / "c.npy", clouds)
    np.savez(tmp_path / "d.npz", pred=clouds[:2])
    for name in ("c.npy", "d.npz"):
        got = mitsuba.render_pointclouds(str(tmp_path / name), str(tmp_path / "p"), 24)
        want = jmitsuba.render_pointclouds(str(tmp_path / name), str(tmp_path / "j"), 24)
        assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
        for a, b in zip(got, want):
            assert open(a).read() == open(b).read()
    with pytest.raises(ValueError, match="unsupported"):
        mitsuba.render_pointclouds(str(tmp_path / "c.txt"))


# -- eval_3d: the port's nets with the JAX package's weights -----------------

N_POINTS, Z = 64, 8


def _cfgs(tmp_path):
    kw = dict(n_points=N_POINTS, z_size=Z, batch_size=4, use_synthetic=True, synthetic_n=64,
              seed=0, verbose=False)
    return (JaxThreeDConfig(results_dir=str(tmp_path / "jax"), **kw),
            ThreeDConfig(results_dir=str(tmp_path / "port"), device="cpu", **kw))


@pytest.fixture(scope="module")
def nets(tmp_path_factory):
    """The JAX nets moved off their init (BN statistics too), and a port
    checkpoint holding the same weights."""
    tmp = tmp_path_factory.mktemp("eval3d")
    jcfg, cfg = _cfgs(tmp)
    enc, dec, state, *_ = jax_build_3d_training(jcfg)
    rs = np.random.RandomState(11)
    move = lambda t, s: jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a) + s * rs.randn(*a.shape).astype(np.float32)), t)
    stats = jax.tree_util.tree_map(lambda a: jnp.abs(a) + 0.5, move(state.stats_e, 0.3))
    state = state.replace(params_e=move(state.params_e, 0.05), params_d=move(state.params_d, 0.05),
                          stats_e=stats)
    port, _ = eval_3d.load_state(cfg)
    port.model.load_state_dict(pointnet_state_dict_from_jax(
        state.params_e, state.stats_e, state.params_d), strict=True)
    path = Checkpointer(str(tmp / "port" / "weights")).save(port, 5)
    return jcfg, cfg, enc, dec, state, path


def test_decode_and_encode_match_the_jax_package(nets):
    jcfg, cfg, enc, dec, jstate, path = nets
    state, epoch = eval_3d.load_state(cfg, path)
    assert epoch == 5
    z = np.random.RandomState(4).randn(6, Z).astype(np.float32) * cfg.prior_std
    want = np.asarray(dec.apply({"params": jstate.params_d}, jnp.asarray(z)))
    np.testing.assert_allclose(eval_3d.decode(state, z), want, rtol=0, atol=1e-5)
    x = eval_3d._points(cfg, "test")
    mu, _ = enc.apply({"params": jstate.params_e, "batch_stats": jstate.stats_e},
                      jnp.asarray(x), train=False)
    np.testing.assert_allclose(eval_3d.encode_mean(state, x).numpy(), np.asarray(mu),
                               rtol=0, atol=1e-5)
    assert state.model.training  # eval mode only for the encode


def test_jsd_matches_the_jax_package(nets):
    jcfg, cfg, enc, dec, jstate, path = nets
    ref = eval_3d._points(cfg, "test")
    np.testing.assert_array_equal(ref, jeval._points(jcfg, "test"))
    clouds = np.random.RandomState(9).rand(3 * len(ref), N_POINTS, 3).astype(np.float32) - 0.5
    assert jsd_between_point_cloud_sets(clouds, ref) == jax_jsd(clouds, ref)
    # the JAX package's own draws (fold_in(key(777), t)), injected into the port
    n = ref.shape[0]
    noises = [np.array(jcfg.prior_std * jax.random.normal(
        jax.random.fold_in(jax.random.key(777), t), (3 * n, Z), jnp.float32)) for t in range(3)]
    want = jeval._jsd_vs_samples(dec, jstate, ref, jcfg)
    assert eval_3d.test_jsd(cfg, path, noises=noises) == pytest.approx(want, rel=0, abs=1e-6)
    # the port's own draws: a torch generator seeded 777 + trial, reproducible
    own = eval_3d.test_jsd(cfg, path)
    assert own == eval_3d.test_jsd(cfg, path) and np.isfinite(own)


def test_subcommands_on_the_cpu(nets, tmp_path, capsys):
    jcfg, cfg, enc, dec, jstate, path = nets
    c = dict(n_points=N_POINTS, z_size=Z, use_synthetic=True, synthetic_n=64,
             results_root=str(tmp_path / "results"))
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(c))
    weights = tmp_path / "results" / "vae" / "soft_intro_vae" / "weights"
    weights.mkdir(parents=True)
    for e in (2, 4):
        (weights / f"model_epoch_{e}_iter_0.ckpt").write_bytes(open(path, "rb").read())
    common = ["-c", str(cfg_path), "--device", "cpu"]
    eval_3d.main(["test-jsd", *common, "-m", path])
    eval_3d.main(["find-best-epoch", *common])
    eval_3d.main(["dump-metrics-data", *common, "-m", path, "-o", str(tmp_path / "m")])
    eval_3d.main(["render-data", *common, "-m", path, "-o", str(tmp_path / "r")])
    out = capsys.readouterr().out
    assert "test jsd:" in out and "best:" in out and "model_epoch_2_iter_0.ckpt" in out
    x, xg, xrec = (np.load(tmp_path / "m" / f"{k}.npy") for k in ("X", "Xg", "Xrec"))
    assert x.shape == xg.shape == xrec.shape == (8, N_POINTS, 3)
    samples = np.load(tmp_path / "r" / "samples.npy")
    interp = np.load(tmp_path / "r" / "interpolation.npy")
    assert samples.shape == (10, N_POINTS, 3) and interp.shape == (5, N_POINTS, 3)
    eval_3d.main(["render-xml", "-i", str(tmp_path / "r" / "interpolation.npy"),
                  "-o", str(tmp_path / "xml"), "--points", "32"])
    assert len(os.listdir(tmp_path / "xml")) == 5
    # injected draws: the rendering's latents and its interpolation ends
    z = np.zeros((2, Z), np.float32)
    ends = np.stack([np.zeros(Z), np.ones(Z)]).astype(np.float32)
    eval_3d.generate_for_rendering(cfg, path, str(tmp_path / "z"), 2, 3, z=z, z_ends=ends)
    state, _ = eval_3d.load_state(cfg, path)
    line = np.repeat(np.asarray([[0.0], [0.5], [1.0]], np.float32), Z, axis=1)
    np.testing.assert_array_equal(np.load(tmp_path / "z" / "interpolation.npy"),
                                  eval_3d.decode(state, line))
    np.testing.assert_array_equal(np.load(tmp_path / "z" / "samples.npy"), eval_3d.decode(state, z))


def test_the_tools_default_to_cuda(nets):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; the check is for machines without one")
    path = nets[-1]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        eval_3d.main(["test-jsd", "-m", path])
