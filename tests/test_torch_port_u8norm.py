"""Port parity: ops/u8norm.py, the uint8 NHWC -> float32 normalize, returned
as (B, C, H, W) with channels-last strides.

On the CPU the plain version runs (the CUDA kernel is held to it on the card
by chip_smoke.py); the kernel's launch plan is plain Python and is held here
to covering every element once. Everything here is exact: bit-equality, no
tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soft_intro_vae_tpu.ops.u8norm import u8_to_unit_f32
from soft_intro_vae_torch.ops import u8norm, u8norm_cuda
from soft_intro_vae_torch.train.step import UNIT_LUT
from tests.torch_port_fixtures import one_torch_thread  # noqa: F401

HOST = np.arange(256, dtype=np.uint8).astype(np.float32) / np.float32(255)


def test_all_256_values_equal_numpy_and_the_jax_function():
    x = torch.arange(256, dtype=torch.uint8).reshape(1, 16, 16, 1)
    got = u8norm.u8_to_unit_nchw(x).numpy().ravel()
    jax_values = np.asarray(jax.jit(u8_to_unit_f32)(jnp.arange(256, dtype=jnp.uint8)))
    np.testing.assert_array_equal(got.view(np.uint32), HOST.view(np.uint32))
    np.testing.assert_array_equal(got.view(np.uint32), jax_values.view(np.uint32))
    np.testing.assert_array_equal(UNIT_LUT, HOST)
    assert got[0] == 0.0 and got[255] == 1.0


def test_a_reciprocal_multiply_is_not_exact():
    """Why the port has a kernel: ``x * (1/255)`` in float32 misses many bytes."""
    naive = (torch.arange(256, dtype=torch.uint8).float() * (1 / 255.0)).numpy()
    assert int((naive != HOST).sum()) > 100


@pytest.mark.parametrize("shape", [(32, 32, 32, 3), (5, 28, 28, 1), (3, 7, 5, 1), (1, 1, 1, 1),
                                   (2, 3, 9, 4)])
def test_layout_is_nchw_of_the_nhwc_input(shape):
    """Logical (B, C, H, W); in memory the input's NHWC order, channels-last."""
    x = np.random.default_rng(sum(shape)).integers(0, 256, shape, dtype=np.uint8)
    got = u8norm.u8_to_unit_nchw(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.is_contiguous(memory_format=torch.channels_last)
    assert tuple(got.shape) == (shape[0], shape[3], shape[1], shape[2])
    want = x.astype(np.float32) / np.float32(255)
    np.testing.assert_array_equal(got.numpy(), want.transpose(0, 3, 1, 2))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy().view(np.uint32),
                                  want.view(np.uint32))
    jax_values = np.asarray(jax.jit(u8_to_unit_f32)(jnp.asarray(x)))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy().view(np.uint32),
                                  jax_values.view(np.uint32))


def test_impl_cuda_on_a_cpu_tensor_raises():
    x = torch.zeros((1, 2, 2, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        u8norm.u8_to_unit_nchw(x, "cuda")
    with pytest.raises(ValueError, match="CUDA"):
        u8norm_cuda.u8_to_unit_nchw_cuda(x)
    with pytest.raises(NotImplementedError):
        u8norm.u8_to_unit_nchw(x, "triton")


@pytest.mark.parametrize("bad, err", [
    (torch.zeros((1, 2, 2, 3), dtype=torch.float32), TypeError),
    (torch.zeros((2, 2, 3), dtype=torch.uint8), ValueError),
    (torch.zeros((1, 3, 2, 2), dtype=torch.uint8).permute(0, 2, 3, 1), ValueError),
])
def test_the_kernel_refuses_a_wrong_dtype_or_layout(bad, err):
    with pytest.raises(err):
        u8norm_cuda.check_input(bad)
    with pytest.raises(err):
        u8norm.u8_to_unit_nchw_plain(bad)


@pytest.mark.parametrize("n, sms", [(1, 132), (255, 132), (256, 132), (257, 132),
                                    (32 * 32 * 32 * 3, 132), (32 * 256 * 256 * 3, 132),
                                    (10**9, 114), (5 * 28 * 28, 1)])
def test_launch_plan_covers_every_element(n, sms):
    p = u8norm_cuda.plan(n, 0, sms)
    _check_plan(p, n, 0, sms)
    assert p.head == 0 and p.vectors == n // 16 and p.tail == n % 16


def _check_plan(p, n, offset, sms):
    """The kernel's split (csrc/u8norm.cu): head elements, 16-byte vectors,
    tail elements, each a thread; the C entry point's checks too."""
    vec = u8norm_cuda.VEC
    assert p.threads % 32 == 0 and 0 < p.threads <= 1024
    assert 0 < p.grid <= u8norm_cuda.BLOCKS_PER_SM * sms
    assert 0 <= p.head < vec and 0 <= p.tail < vec and p.vectors >= 0
    assert p.head + vec * p.vectors + p.tail == n
    if p.vectors:  # the vectors start on a 16-byte boundary of the input
        assert (offset + p.head) % vec == 0
    assert p.head == min(-offset % vec, n)  # no longer a head than the boundary needs
    threads = p.grid * p.threads
    assert threads >= max(p.head, p.tail)
    # one vector a thread until the cap; past it the grid-stride loop covers the rest
    assert threads >= p.vectors or p.grid == u8norm_cuda.BLOCKS_PER_SM * sms
    assert (p.grid - 1) * p.threads < max(p.vectors, p.head, p.tail)


@pytest.mark.parametrize("offset", range(16))
@pytest.mark.parametrize("n", [1, 5, 15, 16, 17, 31, 105, 2 * 105, 5 * 28 * 28, 32 * 32 * 32 * 3])
def test_launch_plan_at_any_offset_covers_every_element_once(n, offset):
    """Aligned, misaligned (a slice of an odd-sized K-batch: (3, 7, 5, 1) is
    105 bytes) and odd ``numel``: the head, the grid-stride loop over 16-byte
    runs (four 4-byte words a grid stride apart) and the tail, walked as the
    kernel walks them, write each element once."""
    p = u8norm_cuda.plan(n, offset)
    _check_plan(p, n, offset, u8norm_cuda.H100_SMS)
    seen = np.zeros(n, np.int64)
    stride = p.grid * p.threads
    words = 4 * p.vectors
    for t in range(stride):
        for base in range(t, words, 4 * stride):  # four 4-byte words a grid stride apart
            for i in range(base, min(base + 4 * stride, words), stride):
                seen[p.head + 4 * i:p.head + 4 * i + 4] += 1
        if t < p.head:
            seen[t] += 1
        if t < p.tail:
            seen[p.head + 16 * p.vectors + t] += 1
    np.testing.assert_array_equal(seen, np.ones(n, np.int64))


def test_launch_plan_refuses_empty_work():
    with pytest.raises(ValueError):
        u8norm_cuda.plan(0)
    with pytest.raises(ValueError):
        u8norm_cuda.plan(16, 16)
