"""Port parity: soft_intro_vae_torch.parallel (data parallelism over
torch.distributed) against soft_intro_vae_tpu.parallel, on the CPU over gloo.

  * the per-rank arithmetic: ``host_local_batch_size``, ``shard_batch`` /
    ``shard_scan_batch`` rows, ``per_host_slice``, ``is_primary``, against
    the JAX functions (parallel/mesh.py:97-104, multihost.py:53-55);
  * the global BatchNorm (parallel/collectives.py) through the image
    encoder's BN layers against flax's BatchNorm on the global batch (the JAX
    image encoder, same weights through ``image_state_dict_from_jax``):
    forward and input gradient within rtol 1e-4 and 1e-5 of each tensor's
    scale (tests/test_torch_port_conv.py's tolerance: XLA and PyTorch sum
    the convolutions in another order), running statistics as there (the
    running variance with torch's n/(n-1)), in a world of 1 in this process and in a world of
    2 spawned ranks, whose halves concatenated equal the world of 1 within
    1e-6 of each tensor's scale;
  * without a process group no collective is issued; ``num_devices`` that is
    not the world size raises, in the trainers and the CLI.

Process groups here use a FileStore in ``tmp_path``, never a TCP port, and
every spawned rank has a join deadline of 60 s (parallel/launch.py), so a
deadlocked collective fails one test.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soft_intro_vae_tpu.models.conv import ConvEncoder as JaxEncoder
from soft_intro_vae_tpu.parallel import mesh as jmesh
from soft_intro_vae_tpu.parallel import multihost as jmultihost
from soft_intro_vae_torch.parallel import collectives, mesh, multihost
from soft_intro_vae_torch.parallel.launch import run_ranks, write_inputs
from soft_intro_vae_torch.parallel.verify import encoder_bn_probe
from soft_intro_vae_torch.utils.from_jax import image_state_dict_from_jax
from tests.torch_port_fixtures import one_torch_thread  # noqa: F401

CH, IMG, Z, B = (8, 16), 16, 16, 8


@pytest.fixture
def world_of_one(tmp_path):
    """A gloo process group of one rank in this process, destroyed after."""
    saved = os.environ.get("LOCAL_RANK")
    multihost.initialize_multihost(f"file://{tmp_path}/store", 1, 0, backend="gloo",
                                   device="cpu", timeout_s=60)
    try:
        yield mesh.current_world()
    finally:
        multihost.shutdown()
        if saved is None:
            os.environ.pop("LOCAL_RANK", None)
        else:
            os.environ["LOCAL_RANK"] = saved


@pytest.mark.parametrize("global_batch, n", [(32, 1), (32, 2), (32, 8), (6, 3)])
def test_host_local_batch_size_and_rows_match_jax(global_batch, n):
    jax_mesh = jmesh.make_data_mesh(n)
    per = jmesh.host_local_batch_size(global_batch, jax_mesh)
    x = np.arange(global_batch * 5).reshape(global_batch, 5)
    xs = np.stack([x, x + 1000])
    for r in range(n):
        world = mesh.World(rank=r, size=n, backend="gloo")
        assert mesh.host_local_batch_size(global_batch, world) == per
        # the JAX multi-process route's local slice (parallel/verify.py:70-72)
        want = x[r * per:(r + 1) * per]
        np.testing.assert_array_equal(mesh.shard_batch(x, world), want)
        np.testing.assert_array_equal(mesh.shard_scan_batch(xs, world), xs[:, r * per:(r + 1) * per])
        t = mesh.shard_batch(torch.from_numpy(x), world)
        np.testing.assert_array_equal(t.numpy(), want)


@pytest.mark.parametrize("global_batch, n", [(30, 8), (5, 2)])
def test_an_uneven_global_batch_raises_as_in_jax(global_batch, n):
    with pytest.raises(ValueError, match="not divisible"):
        jmesh.host_local_batch_size(global_batch, jmesh.make_data_mesh(n))
    with pytest.raises(ValueError, match="not divisible"):
        mesh.host_local_batch_size(global_batch, mesh.World(rank=0, size=n, backend="gloo"))


@pytest.mark.parametrize("n_items", [10, 7, 1])
def test_per_host_slice_and_is_primary_match_jax(n_items, monkeypatch):
    # one process: JAX's (process_index, process_count) is (0, 1)
    assert jmultihost.per_host_slice(n_items) == multihost.per_host_slice(n_items)
    assert jmultihost.is_primary() and multihost.is_primary()
    assert multihost.host_shard_info() == jmultihost.host_shard_info()
    for r, n in ((0, 2), (1, 2), (2, 3)):
        monkeypatch.setattr(multihost, "host_shard_info", lambda r=r, n=n: (r, n))
        per = n_items // n
        assert multihost.per_host_slice(n_items) == slice(r * per, (r + 1) * per)


def test_world_of_one_in_process(world_of_one):
    w = world_of_one
    assert w.active and w.size == 1 and w.rank == 0 and w.backend == "gloo"
    assert multihost.is_primary() and multihost.global_data_mesh() == w
    with mesh.unsharded():
        assert not mesh.current_world().active and mesh.group_world().active
    with pytest.raises(ValueError, match="num_devices=2"):
        mesh.make_data_mesh(2)


@pytest.fixture(scope="module")
def bn_setup():
    """JAX encoder variables with BN scales and biases away from 1 and 0, the
    port encoder's state_dict of them, a global batch, the loss weights and
    flax's forward, input gradient and updated statistics on that batch."""
    from soft_intro_vae_tpu.models.conv import ConvDecoder as JaxDecoder
    from soft_intro_vae_torch.models.conv import SoftIntroVAE

    enc = JaxEncoder(cdim=3, zdim=Z, channels=CH, image_size=IMG)
    dec = JaxDecoder(cdim=3, zdim=Z, channels=CH, image_size=IMG)
    ve = jax.jit(lambda k: enc.init(k, jnp.zeros((1, IMG, IMG, 3)), train=False))(jax.random.key(0))
    vd = jax.jit(lambda k: dec.init(k, jnp.zeros((1, Z)), train=False))(jax.random.key(1))
    rs = np.random.RandomState(2)
    ve = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), ve)
    for path, leaf in jax.tree_util.tree_flatten_with_path(ve["params"])[0]:
        if "bn" in jax.tree_util.keystr(path):
            leaf += 0.3 * rs.randn(*leaf.shape).astype(np.float32)
    x = rs.rand(B, IMG, IMG, 3).astype(np.float32)
    wm, wl = rs.randn(B, Z).astype(np.float32), rs.randn(B, Z).astype(np.float32)

    def loss(x):
        (mu, lv), upd = enc.apply(ve, x, train=True, mutable=["batch_stats"])
        return jnp.sum(mu * wm) + jnp.sum(lv * wl), (mu, lv, upd["batch_stats"])

    (_, (mu, lv, stats)), dx = jax.value_and_grad(loss, has_aux=True)(jnp.asarray(x))
    model = SoftIntroVAE(cdim=3, zdim=Z, channels=CH, image_size=IMG)
    model.load_state_dict(image_state_dict_from_jax(ve["params"], ve["batch_stats"], vd["params"],
                                                    vd["batch_stats"], CH, IMG), strict=True)
    after = image_state_dict_from_jax(ve["params"], stats, vd["params"], vd["batch_stats"], CH, IMG)
    before = {k: v.clone() for k, v in model.encoder.state_dict().items()}
    want = dict(mu=np.asarray(mu), logvar=np.asarray(lv), dx=np.asarray(dx),
                stats={k[len("encoder."):]: v.numpy() for k, v in after.items()
                       if k.startswith("encoder.")})
    return before, (x, wm, wl), want


def _bn_sites(weights):
    """(name, n) of every BN of the encoder: n = B*H*W of its input."""
    sizes, sz = [("main.1", B * (IMG * IMG))], IMG // 2
    for _ in range(len(CH)):
        sizes += [(f"main.res_in_{sz}.bn{j}", B * sz * sz) for j in (1, 2)]
        sz //= 2
    assert {f"{n}.running_mean" for n, _ in sizes} == {k for k in weights if k.endswith("mean")}
    return sizes


def _check_against_flax(got, before, want):
    """Forward, input gradient, running mean and (torch's n/(n-1) applied)
    running variance against flax on the global batch."""
    for k in ("mu", "logvar", "dx"):
        scale = float(np.abs(want[k]).max())
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5 * scale, err_msg=k)
    for name, n in _bn_sites(before):
        np.testing.assert_allclose(got[f"buf/{name}.running_mean"],
                                   want["stats"][f"{name}.running_mean"], rtol=0, atol=1e-6)
        old = before[f"{name}.running_var"].numpy()
        got_delta = got[f"buf/{name}.running_var"] - 0.9 * old
        want_delta = (want["stats"][f"{name}.running_var"] - 0.9 * old) * n / (n - 1)
        np.testing.assert_allclose(got_delta, want_delta, rtol=1e-5, atol=1e-7, err_msg=name)
        assert int(got[f"buf/{name}.num_batches_tracked"]) == 1


def test_global_batch_norm_matches_flax_in_a_world_of_one(world_of_one, bn_setup):
    before, (x, wm, wl), want = bn_setup
    calls = dict(collectives.calls)
    got = encoder_bn_probe(x, {k: v.clone() for k, v in before.items()}, wm, wl, z_dim=Z,
                           channels=CH, image_size=IMG)
    n_bn = len(_bn_sites(before))
    # one all-reduce a BN forward and one a BN backward
    for kind in ("bn_fwd", "bn_bwd"):
        assert collectives.calls[kind] - calls.get(kind, 0) == n_bn
    _check_against_flax(got, before, want)


def test_global_batch_norm_two_ranks_equal_one(tmp_path, bn_setup):
    before, (x, wm, wl), want = bn_setup
    inputs = write_inputs(str(tmp_path / "in.npz"), {"bn": dict(
        x=x, w_mu=wm, w_logvar=wl, weights={k: v.numpy() for k, v in before.items()})})
    job = [dict(name="bn", probe="encoder_bn_probe", kwargs=dict(z_dim=Z, channels=CH,
                                                                 image_size=IMG))]
    two = run_ranks(2, job, str(tmp_path), inputs=inputs)
    (one,) = run_ranks(1, job, str(tmp_path), inputs=inputs)
    for k in ("mu", "logvar", "dx"):
        halves = np.concatenate([two[0][f"bn/{k}"], two[1][f"bn/{k}"]])
        scale = float(np.abs(one[f"bn/{k}"]).max())
        np.testing.assert_allclose(halves, one[f"bn/{k}"], rtol=0, atol=1e-6 * scale, err_msg=k)
    for k in one:
        if k.startswith("bn/buf/"):
            np.testing.assert_array_equal(two[0][k], two[1][k], err_msg=k)  # replicated
            scale = float(np.abs(one[k]).max()) or 1.0
            np.testing.assert_allclose(two[0][k], one[k], rtol=0, atol=1e-6 * scale, err_msg=k)
    _check_against_flax({k[3:]: v for k, v in one.items()}, before, want)


def test_no_collective_without_a_process_group(bn_setup):
    """Off the distributed route the step is PyTorch's own: every BN takes
    torch.nn.BatchNorm's forward and no collective is issued."""
    from soft_intro_vae_torch.models.conv import SoftIntroVAE
    from soft_intro_vae_torch.train.state import TrainState
    from soft_intro_vae_torch.train.step import StepConfig, build_train_steps

    assert not torch.distributed.is_initialized() and not mesh.current_world().active
    before = dict(collectives.calls)
    torch.manual_seed(0)
    model = SoftIntroVAE(cdim=3, zdim=Z, channels=CH, image_size=IMG)
    state = TrainState.create(model, device=torch.device("cpu"), seed=0)
    vanilla, intro = build_train_steps(cfg=StepConfig(z_dim=Z, scale=1.0 / (3 * IMG * IMG)),
                                       nhwc=True)
    x = torch.from_numpy(bn_setup[1][0])
    for step in (vanilla, intro):
        step(state, x)
    assert dict(collectives.calls) == before
    seen = []
    hook = torch.nn.BatchNorm2d.forward
    try:
        torch.nn.BatchNorm2d.forward = lambda self, x: seen.append(1) or hook(self, x)
        intro(state, x)
    finally:
        torch.nn.BatchNorm2d.forward = hook
    # every BN call took torch's forward: 5 encoder forwards of 5 BNs, 8 decoder forwards of 6
    assert len(seen) == 5 * 5 + 8 * 6
    assert dict(collectives.calls) == before


def test_num_devices_other_than_the_world_raises(tmp_path):
    from soft_intro_vae_torch.cli import main as cli
    from soft_intro_vae_torch.data.images import ArrayDataset, ImageSpec
    from soft_intro_vae_torch.train.image import ImageConfig, train_soft_intro_vae
    from soft_intro_vae_torch.train.style import StyleConfig, build_style_training
    from soft_intro_vae_torch.train.threed import ThreeDConfig, build_3d_training

    spec = ImageSpec("cifar10", IMG, CH, 3)
    data = ArrayDataset(np.zeros((4, IMG, IMG, 3), np.uint8))
    img = ImageConfig(dataset="cifar10", z_dim=Z, batch_size=4, num_epochs=1, num_devices=2,
                      result_dir=str(tmp_path / "img"), device="cpu")
    with pytest.raises(ValueError, match="num_devices=2 but the world has 1"):
        train_soft_intro_vae(img, data, spec)
    with pytest.raises(ValueError, match="num_devices=2 but the world has 1"):
        build_3d_training(ThreeDConfig(n_points=32, batch_size=4, z_size=8, num_devices=2,
                                       results_dir=str(tmp_path / "3d"), device="cpu"))
    with pytest.raises(ValueError, match="num_devices=2 but the world has 1"):
        build_style_training(StyleConfig(layer_count=2, start_channel_count=8,
                                         max_channel_count=16, latent_space_size=8,
                                         num_devices=2, device="cpu"))
    with pytest.raises(ValueError, match="num_devices=2 but the world has 1"):
        cli.main(["image", "-d", "cifar10", "-n", "1", "-z", "8", "-b", "4", "--synthetic-n", "8",
                  "--num_devices", "2", "--result_dir", str(tmp_path / "cli"), "-c", "cpu"])
    assert not (tmp_path / "cli").exists()


def test_launcher_variables_without_a_group_raise(tmp_path, monkeypatch):
    from soft_intro_vae_torch.train.threed import ThreeDConfig, build_3d_training

    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="no process group"):
        build_3d_training(ThreeDConfig(n_points=32, batch_size=4, z_size=8,
                                       results_dir=str(tmp_path), device="cpu"))
    with pytest.raises(ValueError, match="RANK"):
        multihost.initialize_multihost(device="cpu")
    with pytest.raises(ValueError, match="num_processes"):
        multihost.initialize_multihost(f"file://{tmp_path}/s", device="cpu")
    assert not torch.distributed.is_initialized()


def test_a_world_of_one_takes_any_batch_and_rows_follow_the_rank(world_of_one):
    assert mesh.host_local_batch_size(5) == 5
    assert dataclasses.replace(world_of_one, rank=1).rows(3) == slice(3, 6)
