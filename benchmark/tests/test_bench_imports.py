"""Nothing the benchmark runs loads JAX or the JAX package, compared by whole
top-level module names; the references load nothing of the program."""

import ast
import os
import subprocess
import sys

import pytest

from benchmark.core import harness

REF_DIR = os.path.join(harness.HERE, "reference")


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "soft_intro_vae_tpu_like", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_free", object())
    names = harness.forbidden_modules()
    assert "soft_intro_vae_tpu_like" not in names and "jaxtyping_free" not in names
    monkeypatch.setitem(sys.modules, "optax.schedules", object())
    assert "optax" in harness.forbidden_modules()


def test_a_run_loads_no_jax():
    """Every module a run imports, the program's entries included, in a fresh
    interpreter: no top-level name of JAX or the JAX package."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import benchmark.core.harness as h, benchmark.calibrate\n"
        "import benchmark.families.style, benchmark.families.image\n"
        "import soft_intro_vae_torch.train.style, soft_intro_vae_torch.train.image\n"
        "import soft_intro_vae_torch.data.prefetch, soft_intro_vae_torch.data.streaming\n"
        "for m in h.manifest()['end_to_end'] + h.manifest()['per_layer']:\n"
        "    h.load_reader(m['name'])\n"
        "print('loaded:' + ','.join(h.forbidden_modules()))\n" % harness.ROOT)
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=env, check=True)
    assert out.stdout.strip().splitlines()[-1] == "loaded:"


@pytest.mark.parametrize("name", sorted(f for f in os.listdir(REF_DIR) if f.endswith(".py")))
def test_reference_imports_nothing_of_the_program(name):
    tree = ast.parse(open(os.path.join(REF_DIR, name)).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            tops = [(node.module or "").split(".")[0]]
        else:
            continue
        for top in tops:
            assert top not in ("soft_intro_vae_torch", *harness.FORBIDDEN), (name, top)


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.reference.style_ref, benchmark.reference.image_ref\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'soft_intro_vae_torch', 'soft_intro_vae_tpu', 'jax', 'flax', 'optax'}))\n"
            % harness.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True)
    assert out.stdout.strip() == "[]"
