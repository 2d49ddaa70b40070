"""Fixtures shared by the port's tests (tests/test_torch_port_*.py)."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while a module's tests run.

    The tests work on tiny tensors, where more threads buy nothing; with
    several pytest workers on one machine, each worker's thread pool only
    contends with the others' (a 3D resume test took 216 s instead of 6 s).
    """
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def cuda_device():
    """The first CUDA device, for tests marked ``cuda``; they skip without one
    (decided here, when the test runs, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs these paths on the card")
    return torch.device("cuda", 0)
