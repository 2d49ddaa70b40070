"""Binding of the hand-written CUDA chamfer kernel (csrc/chamfer_nearest.cu).

Replaces the TPU kernel of soft_intro_vae_tpu/ops/chamfer_pallas.py
(``_nearest`` -> ``_min_kernel``): one launch returns both directions' minima
and argmins, as the TPU kernel does. The source's header says what bounds it
and how it is laid out.

Build: ``ops/cuda_build.py`` compiles the source with ``nvcc`` into a shared
library with a plain C interface under ``soft_intro_vae_torch/_build/``,
keyed by a hash of the source and the flags, and ``ctypes`` loads it. That
happens on the first call with a CUDA tensor, never at import. A build or
launch failure raises; there is no fallback to the plain version.

``plan`` picks the launch's shape from (B, N, M) and the card's SM count
alone, in plain Python so that the CPU tests can hold it to its invariants;
the C entry point checks the plan it is given and refuses one that does not
fit.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import os
from typing import Tuple

import torch

from soft_intro_vae_torch.ops import cuda_build

Tensor = torch.Tensor

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "chamfer_nearest.cu")
_BUILD_DIR = cuda_build.BUILD_DIR

# Launch-plan limits; csrc/chamfer_nearest.cu keeps the same numbers and checks them.
ROWS = 8                     # R: points of x a thread holds
TILE = 8                     # points of y per row-argmin tile
MAX_WARPS = 8
MAX_CHUNK = 4096             # points of y staged at once
MIN_SLICE = 64               # points of y a work item takes at least
BLOCK_SMEM = 232448          # shared memory one CTA may use on sm_90 (227 KB)
STATIC_SMEM = 4096           # bound on the kernel's static shared memory
MAX_DYNAMIC_SMEM = BLOCK_SMEM - STATIC_SMEM
CTAS_PER_SM = 2              # resident CTAs an SM: 256 threads of at most 128 registers
SMEM_PER_CTA = BLOCK_SMEM // CTAS_PER_SM - STATIC_SMEM  # dynamic shared bytes that keep them
H100_SMS = 132

# kernel launches made by ``nearest_pair_cuda``; a run sets it to 0 and reads
# it back to show which path went through the kernel
launches = 0


def spec() -> cuda_build.Spec:
    """The build of this kernel: (source, library stem, extra nvcc flags)."""
    return (_SRC, "chamfer_nearest", ())


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.chamfer_nearest_pair.argtypes = [p] * 7 + [i] * 3 + [i] * 7 + [p]
    lib.chamfer_nearest_pair.restype = ctypes.c_int
    lib.chamfer_max_active_clusters.argtypes = [i, i, i, ctypes.POINTER(ctypes.c_int)]
    lib.chamfer_max_active_clusters.restype = ctypes.c_int
    lib.chamfer_error_string.argtypes = [ctypes.c_int]
    lib.chamfer_error_string.restype = ctypes.c_char_p


_library = cuda_build.Library(spec, _declare)


def library_path() -> str:
    """Where the built library for the current source and flags lives."""
    return cuda_build.library_path(*spec())


def load() -> ctypes.CDLL:
    """Build (if needed) and load the library once per process."""
    return _library.load()


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch's shape (the source's header explains it).

    rows R, points of x a thread holds; warps and threads per CTA; tile_x,
    points of x a CTA takes per pass (its warps' 32*R-row blocks); slices S
    of y a batch element, slice s holding points [s*slice, (s+1)*slice), a
    work item being (b, s); chunk, points of y staged in shared memory at
    once; bulk, whether they are staged with 1-D bulk copies (16-byte aligned
    bytes) or scalar loads; smem, dynamic shared bytes (the chunk and each
    warp's column keys of it); grid, CTAs, all resident at once (a
    cooperative launch), each taking items grid apart.
    """

    rows: int
    warps: int
    threads: int
    tile_x: int
    slices: int
    slice: int
    chunk: int
    bulk: bool
    smem: int
    grid: int

    def args(self) -> Tuple[int, ...]:
        """The plan in the C entry point's order (warps, slices, slice, chunk,
        bulk, smem, grid)."""
        return (self.warps, self.slices, self.slice, self.chunk, int(self.bulk), self.smem,
                self.grid)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def plan(bsz: int, n: int, m: int, sms: int = H100_SMS) -> Plan:
    """The launch plan of one search over x (bsz, n, 3) and y (bsz, m, 3) on a
    card of ``sms`` SMs: as many equal work items as resident CTAs where y
    allows (slices of at least MIN_SLICE points), one CTA an item."""
    if min(bsz, n, m, sms) <= 0:
        raise ValueError(f"empty shape: B {bsz}, N {n}, M {m}, SMs {sms}")
    warps = min(MAX_WARPS, -(-n // (32 * ROWS)))
    resident = sms * CTAS_PER_SM
    slices = max(1, min(resident // bsz, -(-m // MIN_SLICE)))
    slc = _round_up(-(-m // slices), 4)
    slices = -(-m // slc)  # every slice holds some of y
    # points of y a CTA stages: 12 bytes each, and 8 a warp for its column keys
    room = (SMEM_PER_CTA - 16) // (12 + 8 * warps)
    chunk = min(slc, MAX_CHUNK, room // 4 * 4)
    smem = _round_up(12 * chunk, 16) + 8 * warps * chunk
    return Plan(ROWS, warps, 32 * warps, 32 * ROWS * warps, slices, slc, chunk, m % 4 == 0, smem,
                min(bsz * slices, resident))


def max_active_clusters(pl: Plan, cluster: int) -> int:
    """Thread-block clusters of ``cluster`` CTAs of this plan's shape that the
    current card holds at once: what a design with one cluster per batch
    element would get."""
    lib = load()
    count = ctypes.c_int(0)
    err = lib.chamfer_max_active_clusters(pl.warps, pl.smem, cluster, ctypes.byref(count))
    if err != 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed: "
                           f"{lib.chamfer_error_string(err).decode()} ({pl})")
    return count.value


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check_cloud(name: str, t: Tensor) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got device {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if t.dim() != 3 or t.shape[2] != 3:
        raise ValueError(f"{name} must have shape (B, N, 3), got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def nearest_pair_cuda(x: Tensor, y: Tensor) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """(min_x, amin_x, min_y, amin_y): for every point of x its nearest point
    of y, (B, N) f32 and int64, and for every point of y its nearest of x,
    (B, M). One kernel launch on the current stream, shaped by ``plan(B, N,
    M)``; does not synchronise.
    """
    global launches
    _check_cloud("x", x)
    _check_cloud("y", y)
    if x.device != y.device or x.shape[0] != y.shape[0]:
        raise ValueError(f"clouds disagree: {tuple(x.shape)} on {x.device} vs "
                         f"{tuple(y.shape)} on {y.device}")
    bsz, n, _ = x.shape
    m = y.shape[1]
    pl = plan(bsz, n, m, _sms(x.device))
    if pl.bulk and y.data_ptr() % 16 != 0:
        y = y.clone()  # bulk copies need a 16-byte aligned base
    lib = load()
    f32 = dict(dtype=torch.float32, device=x.device)
    i64 = dict(dtype=torch.int64, device=x.device)
    min_x, amin_x = torch.empty((bsz, n), **f32), torch.empty((bsz, n), **i64)
    min_y, amin_y = torch.empty((bsz, m), **f32), torch.empty((bsz, m), **i64)
    row_keys = torch.empty((bsz, pl.slices, n), **i64)  # every key is written before it is read
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.chamfer_nearest_pair(x.data_ptr(), y.data_ptr(), min_x.data_ptr(),
                                       amin_x.data_ptr(), min_y.data_ptr(), amin_y.data_ptr(),
                                       row_keys.data_ptr(), bsz, n, m, *pl.args(), stream)
    if err != 0:
        raise RuntimeError(f"chamfer_nearest launch failed: "
                           f"{lib.chamfer_error_string(err).decode()} ({pl})")
    launches += 1
    return min_x, amin_x, min_y, amin_y
