"""The PyTorch tutorials (examples/torch_tutorial_*.py) run end to end on the
CPU at tiny knobs, each in a process of its own as a reader runs it, and
their notebook twins are what tools/py2nb.py makes of them.

Knobs: TUTORIAL_DEVICE=cpu (they default to the card), a few iterations or
images, and TUTORIAL_OUT under the test's temporary directory. The 2D
tutorial runs its from-scratch trainer (its framework section is the toy
trainer, which tests/test_torch_port_toy.py and test_torch_port_toy_cli.py
drive with the paper's metrics), the image tutorial its from-scratch step and
a two-epoch framework run, the bootstrap tutorial its target-decoder checks.
"""

import json
import os
import subprocess
import sys

import pytest

from tests.torch_port_fixtures import one_torch_thread  # noqa: F401
from tools.py2nb import parse_cells, to_notebook

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TUTORIALS = {
    "torch_tutorial_2d_toy": (dict(TUTORIAL_ITERS="20", TUTORIAL_RUN_FRAMEWORK="0"),
                              ("[intro", "decoder samples:")),
    "torch_tutorial_image": (dict(TUTORIAL_EPOCHS="2", TUTORIAL_IMAGES="32"),
                             ("encoder+decoder parameters:", "kl_fake", "summary:")),
    "torch_tutorial_bootstrap": (dict(TUTORIAL_EPOCHS="2", TUTORIAL_IMAGES="32"),
                                 ("target == online after a refresh: True",
                                  "online decoder == target after the last refresh: True; "
                                  "shared storage: False")),
}


@pytest.mark.parametrize("name", sorted(TUTORIALS))
def test_tutorial_runs_on_the_cpu_at_tiny_knobs(name, tmp_path):
    knobs, expected = TUTORIALS[name]
    env = {**os.environ, **knobs, "TUTORIAL_DEVICE": "cpu", "TUTORIAL_OUT": str(tmp_path),
           "OMP_NUM_THREADS": "2", "MPLBACKEND": "Agg"}
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "examples", f"{name}.py")],
                          cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    for line in expected:
        assert line in proc.stdout, (line, proc.stdout[-2000:])


@pytest.mark.parametrize("name", sorted(TUTORIALS))
def test_tutorial_notebook_is_the_generated_twin(name):
    with open(os.path.join(ROOT, "examples", f"{name}.py")) as f:
        want = to_notebook(parse_cells(f.read()))
    with open(os.path.join(ROOT, "examples", f"{name}.ipynb")) as f:
        assert json.load(f) == want, f"regenerate with: python tools/py2nb.py examples/{name}.py"


@pytest.mark.parametrize("name", sorted(TUTORIALS))
def test_tutorial_imports_no_jax(name):
    with open(os.path.join(ROOT, "examples", f"{name}.py")) as f:
        src = f.read()
    imports = [ln for ln in src.splitlines() if ln.lstrip().startswith(("import ", "from "))]
    assert not any("jax" in ln or "soft_intro_vae_tpu" in ln for ln in imports), imports
