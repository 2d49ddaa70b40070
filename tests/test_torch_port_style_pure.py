"""The port's pure-Python parts of the style slice, and its import boundary.

* ``train/lod.py`` (the port's own copy) against the JAX package's
  ``LODDriver`` over a sequence of epochs and iterations.
* ``utils/yaml_config.py`` (the port's YAML reader: the GPU machine has no
  PyYAML) against ``yaml.safe_load`` on configs/*.yaml and on override values.
* Nothing in soft_intro_vae_torch/ or chip_smoke.py imports jax, flax,
  optax, yaml, triton or soft_intro_vae_tpu (found with ``ast``).
"""

import ast
import glob
import math
import os

import pytest
import yaml

from soft_intro_vae_tpu.train.lod import LODDriver as JaxLODDriver
from soft_intro_vae_tpu.train.lod import pick_batch_table as jax_pick_batch_table
from soft_intro_vae_torch.train.lod import LODDriver, pick_batch_table
from soft_intro_vae_torch.utils import yaml_config
from tests.torch_port_fixtures import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "flax", "optax", "yaml", "triton", "soft_intro_vae_tpu"}


@pytest.mark.parametrize("epochs_per_lod", [0, 1, 2, 3, 16])
def test_lod_driver_matches_jax(epochs_per_lod):
    kw = dict(lod_2_batch=[128, 128, 128, 32, 16, 8, 4], epochs_per_lod=epochs_per_lod,
              layer_count=7, dataset_size=600, report_freq=(1, 1, 1, 1, 1, 1, 1),
              snapshot_freq=(2, 2, 2, 2, 2, 2, 2))
    port, ref = LODDriver(**kw), JaxLODDriver(**kw)
    for epoch in range(0, 40, 1 if epochs_per_lod < 16 else 3):
        assert port.set_epoch(epoch) == ref.set_epoch(epoch), epoch
        assert (port.lod, port.in_transition, port.get_batch_size()) == \
            (ref.lod, ref.in_transition, ref.get_batch_size()), epoch
        for _ in range(600 // ref.get_batch_size() + 1):
            assert port.get_blend_factor() == ref.get_blend_factor()
            assert port.is_time_to_report() == ref.is_time_to_report()
            assert port.is_time_to_save() == ref.is_time_to_save()
            port.step()
            ref.step()


def test_pick_batch_table_matches_jax():
    tables = {"1GPU": [1], "2GPU": [2], "8GPU": [8]}
    for world in (1, 2, 3, 4, 8, 16):
        assert pick_batch_table(tables, world) == jax_pick_batch_table(tables, world)
    assert pick_batch_table({}, 1) == jax_pick_batch_table({}, 1)


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(ROOT, "configs", "*.yaml"))),
                         ids=os.path.basename)
def test_yaml_reader_matches_pyyaml_on_the_configs(path):
    with open(path) as f:
        assert yaml_config.load_file(path) == yaml.safe_load(f)


OVERRIDE_VALUES = [
    "true", "False", "YES", "off", "On", "16", "0", "-3", "+7", "0x1F", "017", "08", "1_000",
    "0b101", "12:30", "0.002", "0.000005", "1e-5", "1.0e-5", "1.5e5", "1.5E+5", "3.", ".5",
    "-.inf", ".inf", ".nan", "1:20.5", "~", "null", "NULL", "", "bfloat16", "float32",
    "'quoted'", '"dq \\" x"', "'it''s'", "[1, 2, 3]", "[]", "[0.1, abc, true]",
    "[2048, 2048,]", "[ 'a,b', c ]", "x # comment", "./data/ffhq-r%02d.tfrecords.%03d",
]


@pytest.mark.parametrize("value", OVERRIDE_VALUES)
def test_yaml_reader_matches_pyyaml_on_values(value):
    ref = yaml.safe_load(value)
    got = yaml_config.parse_scalar(value)
    assert type(got) is type(ref)
    if isinstance(ref, float) and math.isnan(ref):
        assert math.isnan(got)
    else:
        assert got == ref


def test_yaml_reader_nesting_and_refusals():
    text = "A:\n  B:\n    C: 1\n  D: [x]\n  E:\nF: 2 # c\n"
    assert yaml_config.loads(text) == yaml.safe_load(text)
    for bad in ("A:\n  - 1\n", "A: 1\n A2: 2\n", "A: 1\nA: 2\n", "A: {b: 1}\n", "A: &x 1\n",
                "A: b: c\n"):
        with pytest.raises(ValueError):
            yaml_config.loads(bad)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_nothing_of_jax():
    files = glob.glob(os.path.join(ROOT, "soft_intro_vae_torch", "**", "*.py"), recursive=True)
    files.append(os.path.join(ROOT, "chip_smoke.py"))
    assert len(files) > 20
    found = {(os.path.relpath(p, ROOT), m) for p in files for m in _imports(p) if m in FORBIDDEN}
    assert not found, sorted(found)
