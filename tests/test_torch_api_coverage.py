"""The port's coverage of the JAX package's public API, name by name.

Every module of ``soft_intro_vae_tpu/`` is parsed with ``ast`` (nothing of
the JAX package or of JAX is imported). Each public top-level ``def`` and
``class`` must be

  (a) defined (``def``, ``class`` or an assignment) at the top level of the
      port module at the same relative path under ``soft_intro_vae_torch/``,
  (b) in ``COVERED_ELSEWHERE``, whose port targets must exist, or
  (c) in ``NOT_PORTED``, with the reason the name is JAX-only.

Each name in a JAX ``__init__``'s ``__all__`` must be importable from the
port's subpackage of the same name and listed in its ``__all__``, unless its
JAX module's entry is in ``COVERED_ELSEWHERE``. Both tables are checked for
stale entries, and one case runs the checker on a JAX-like tree that gained
a name with no counterpart, which must fail.
"""

import ast
import importlib
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX_ROOT = ROOT / "soft_intro_vae_tpu"
PORT_ROOT = ROOT / "soft_intro_vae_torch"

# (JAX module, name) -> the port's (module, name) pairs that do its work
COVERED_ELSEWHERE = {
    ("ops/chamfer_pallas.py", "chamfer_distance_pallas"):
        (("ops/chamfer.py", "chamfer_distance"), ("ops/chamfer_cuda.py", "nearest_pair_cuda")),
    ("ops/adain_pallas.py", "fused_bias_act_norm"):
        (("ops/adain.py", "bias_act_norm"), ("ops/adain_cuda.py", "forward")),
    ("ops/adain_pallas.py", "reference_bias_act_norm"):
        (("ops/adain.py", "bias_act_norm_plain"),),
    ("ops/u8norm.py", "u8_to_unit_f32"):
        (("ops/u8norm.py", "u8_to_unit_nchw"), ("ops/u8norm.py", "u8_to_unit_nchw_plain")),
    # the nets' blur lives beside its kernel; models/style.py imports it
    ("models/style.py", "blur3x3"): (("ops/blur.py", "blur3x3"),),
    ("train/toy.py", "make_eval_fns"): (("train/toy.py", "det_fwd"), ("train/toy.py", "sample")),
    ("train/lreq_adam.py", "LreqAdamState"): (("train/lreq_adam.py", "LreqAdam"),),
    ("train/lreq_adam.py", "scale_by_lreq_adam"): (("train/lreq_adam.py", "LreqAdam"),),
    # the port's Adam applies the LR inside its step
    ("train/optim.py", "apply_updates_with_lr"): (("train/optim.py", "adam"),),
    # F.max_pool2d in the port's Inception
    ("metrics/fid.py", "max_pool"): (("metrics/fid.py", "InceptionV3FID"),),
    # the port's Inception loads pytorch-fid's state_dict as it is
    ("metrics/fid.py", "params_from_torch_state_dict"): (("metrics/fid.py", "load_pt_inception"),),
    ("data/prefetch.py", "normalizing_put_fn"):
        (("data/prefetch.py", "device_put_fn"), ("ops/u8norm.py", "u8_to_unit_nchw")),
    ("data/prefetch.py", "sharding_put_fn"):
        (("data/prefetch.py", "device_put_fn"), ("parallel/mesh.py", "shard_batch")),
    ("parallel/mesh.py", "replicated"): (("parallel/mesh.py", "shard_state"),),
    ("parallel/mesh.py", "batch_sharding"): (("parallel/mesh.py", "shard_batch"),),
    # a reference .pth loads into the port's train state, whose nets keep
    # the reference's state_dict names
    ("utils/torch_compat.py", "load_reference_image_checkpoint"):
        (("utils/checkpoint.py", "load_pretrained"),),
    ("utils/torch_compat.py", "load_reference_3d_checkpoint"):
        (("utils/checkpoint.py", "load_pretrained"),),
    ("utils/torch_compat.py", "load_reference_style_checkpoint"):
        (("utils/checkpoint.py", "load_pretrained"),
         ("utils/checkpoint.py", "style_state_dict_from_reference")),
}

_TO_FLAX = ("turns a reference state_dict into flax parameter trees; the port's nets keep "
            "the reference's state_dict names and take a state_dict as it is")
NOT_PORTED = {
    ("models/initializers.py", "torch_bias_uniform"):
        "a flax initializer imitating torch's default bias init; the port's layers are torch's",
    ("utils/checkpoint.py", "jnp_asarray_u32"):
        "a jnp dtype helper for typed PRNG key data; torch.Generator states are byte tensors",
    ("train/image.py", "make_model_fns"):
        "flax's functional init/apply closures; the port's nets are nn.Modules called directly",
    **{("utils/torch_compat.py", name): _TO_FLAX for name in (
        "convert_image_encoder", "convert_image_decoder", "convert_pointnet_encoder",
        "convert_pointnet_decoder", "convert_mlp", "convert_style_encoder",
        "convert_style_generator", "convert_mapping")},
}


def _tree(path: Path) -> ast.Module:
    return ast.parse(path.read_text(), filename=str(path))


def public_names(path: Path) -> list:
    """The public top-level ``def``s and ``class``es of a module."""
    return [n.name for n in _tree(path).body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
            and not n.name.startswith("_")]


def defined_names(path: Path) -> set:
    """Every name a module defines at its top level (imports excluded)."""
    names = set()
    for n in _tree(path).body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(n.name)
        elif isinstance(n, (ast.Assign, ast.AnnAssign)):
            for t in (n.targets if isinstance(n, ast.Assign) else [n.target]):
                names.update(x.id for x in ast.walk(t) if isinstance(x, ast.Name))
    return names


def init_exports(path: Path) -> dict:
    """``__all__`` of an ``__init__`` -> the relative module each name comes from."""
    tree = _tree(path)
    source = {}
    exported = []
    for n in tree.body:
        if isinstance(n, ast.ImportFrom) and n.module:
            rel = "/".join(n.module.split(".")[1:]) + ".py"
            source.update({a.asname or a.name: rel for a in n.names})
        elif isinstance(n, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__" for t in n.targets):
            exported = [ast.literal_eval(e) for e in n.value.elts]
    return {name: source.get(name) for name in exported}


def _port_has(port_root: Path, rel: str, name: str) -> bool:
    path = port_root / rel
    return path.exists() and name in defined_names(path)


def missing_names(jax_root: Path, port_root: Path, rel: str) -> list:
    """The public names of JAX module ``rel`` that none of (a), (b), (c) covers."""
    return [name for name in public_names(jax_root / rel)
            if not _port_has(port_root, rel, name)
            and (rel, name) not in COVERED_ELSEWHERE and (rel, name) not in NOT_PORTED]


def check_module(jax_root: Path, port_root: Path, rel: str) -> None:
    missing = missing_names(jax_root, port_root, rel)
    assert not missing, f"soft_intro_vae_tpu/{rel}: no counterpart in the port for {missing}"


def check_init(jax_root: Path, package: str, rel: str) -> None:
    port = importlib.import_module(f"{package}.{rel.split('/')[0]}")
    lacking = []
    for name, source in init_exports(jax_root / rel).items():
        if (source, name) in COVERED_ELSEWHERE:
            continue
        if not hasattr(port, name) or name not in getattr(port, "__all__", ()):
            lacking.append(name)
    assert not lacking, f"{port.__name__} does not export {lacking}"


def _modules(root: Path) -> list:
    return sorted(str(p.relative_to(root)) for p in root.rglob("*.py"))


JAX_MODULES = _modules(JAX_ROOT)
JAX_INITS = [rel for rel in JAX_MODULES if rel.endswith("/__init__.py")
             and init_exports(JAX_ROOT / rel)]


def test_the_walk_sees_the_packages():
    assert len(JAX_MODULES) > 50 and len(JAX_INITS) == 5
    assert sum(len(public_names(JAX_ROOT / rel)) for rel in JAX_MODULES) > 200


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_every_public_name_has_a_counterpart(rel):
    check_module(JAX_ROOT, PORT_ROOT, rel)


@pytest.mark.parametrize("rel", JAX_INITS)
def test_every_exported_name_is_exported_by_the_port(rel):
    check_init(JAX_ROOT, "soft_intro_vae_torch", rel)


def test_the_tables_hold_no_stale_entry():
    for table in (COVERED_ELSEWHERE, NOT_PORTED):
        for rel, name in table:
            assert name in public_names(JAX_ROOT / rel), (rel, name)
            assert not _port_has(PORT_ROOT, rel, name), f"{rel} {name} is ported: drop the entry"
    assert not set(COVERED_ELSEWHERE) & set(NOT_PORTED)
    for targets in COVERED_ELSEWHERE.values():
        for rel, name in targets:
            assert _port_has(PORT_ROOT, rel, name), (rel, name)
    for reason in NOT_PORTED.values():
        assert len(reason) > 40


def test_a_new_jax_name_without_a_counterpart_fails(tmp_path):
    """A copy of the JAX tree gains a function in ops/chamfer.py, a module
    with no port counterpart, and an exported name: the checker fails on each."""
    fake = tmp_path / "soft_intro_vae_tpu"
    for rel in ("ops/chamfer.py", "ops/__init__.py"):
        (fake / rel).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(JAX_ROOT / rel, fake / rel)
    check_module(fake, PORT_ROOT, "ops/chamfer.py")
    check_init(fake, "soft_intro_vae_torch", "ops/__init__.py")

    with open(fake / "ops/chamfer.py", "a") as f:
        f.write("\n\ndef chamfer_distance_sparse(preds, gts):\n    return preds\n")
    (fake / "ops/emd.py").write_text("def earth_movers_distance(a, b):\n    return a\n")
    with pytest.raises(AssertionError, match="chamfer_distance_sparse"):
        check_module(fake, PORT_ROOT, "ops/chamfer.py")
    with pytest.raises(AssertionError, match="earth_movers_distance"):
        check_module(fake, PORT_ROOT, "ops/emd.py")
    (fake / "ops/__init__.py").write_text(
        "from soft_intro_vae_tpu.ops.emd import earth_movers_distance\n"
        + (JAX_ROOT / "ops/__init__.py").read_text().replace(
            '"exp_elbo",', '"exp_elbo",\n    "earth_movers_distance",'))
    with pytest.raises(AssertionError, match="earth_movers_distance"):
        check_init(fake, "soft_intro_vae_torch", "ops/__init__.py")


# the port's tools that stand beside a JAX tool, and the modules they import
# when they run (inside their functions)
PORT_TOOLS = {
    "tools/torch_ab_2d_multiseed.py": ("train.toy",),
    "tools/torch_verify_artifacts.py": ("metrics.fid", "metrics.jsd", "data.images",
                                        "data.shapenet", "train.image", "utils.checkpoint",
                                        "utils.plotting"),
}


def _imported_modules(path: Path):
    """Every module an ``import`` or ``from ... import`` anywhere in ``path`` names."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_importing_the_subpackages_builds_and_loads_nothing():
    """In a fresh interpreter: the five subpackages, the port's tools and the
    modules those tools import when they run import without JAX, the JAX
    package or triton, and no kernel library is loaded. No import statement
    of those tools names JAX, the JAX package or the JAX tools they stand
    beside."""
    for tool in PORT_TOOLS:
        bad = [m for m in _imported_modules(ROOT / tool)
               if m.split(".")[0] in ("jax", "soft_intro_vae_tpu")
               or m in ("tools.ab_2d_multiseed", "tools.verify_artifacts")]
        assert not bad, (tool, bad)
    modules = sorted({f"soft_intro_vae_torch.{m}" for ms in PORT_TOOLS.values() for m in ms}
                     | {t[:-3].replace("/", ".") for t in PORT_TOOLS})
    code = (
        "import sys\n"
        "for m in ('ops', 'models', 'metrics', 'train', 'parallel'):\n"
        "    __import__('soft_intro_vae_torch.' + m)\n"
        f"for m in {modules!r}:\n"
        "    __import__(m)\n"
        "from soft_intro_vae_torch.ops import adain_cuda, chamfer_cuda, u8norm_cuda\n"
        "assert all(m._library._lib is None for m in (adain_cuda, chamfer_cuda, u8norm_cuda))\n"
        "bad = [m for m in ('jax', 'soft_intro_vae_tpu', 'triton') if m in sys.modules]\n"
        "assert not bad, bad\n"
        "maps = open('/proc/self/maps').read() if sys.platform == 'linux' else ''\n"
        "assert '_build/' not in maps\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
