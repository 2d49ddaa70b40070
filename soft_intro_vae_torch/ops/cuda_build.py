"""Build, load, launch and route to the port's hand-written CUDA kernels
(``ops/csrc/*.cu``): the one binding protocol of ``ops/*_cuda.py``.

Each source becomes a shared library with a plain C interface: ``nvcc
-shared`` compiles it for sm_90a into ``soft_intro_vae_torch/_build/``, under
a name keyed by a hash of the source and the flags, and ``ctypes`` loads it.
The compiler's output (``-Xptxas -v``: registers, shared memory, spills) is
kept beside the library as ``<library>.log``. A finished build is renamed
into place atomically, so a process that builds at the same time never loads
half a file.

Nothing is built at import: a wrapper builds on its first call with a CUDA
tensor. ``build_many`` starts one ``nvcc`` per source at once and waits for
all of them, which is how a run that needs every kernel builds them. A build
or load failure raises; there is no fallback to a plain version.

``build_host_library`` builds a C++ source for the host the same way, with
``g++`` (the native TFRecord reader, ``native/tfrecord_reader.cpp``).

A compile is a ``kernels.build`` span (utils/profiling.py), so the time a
first call spends building can be told from the call's own.

``Library.launch`` is every kernel launch: it enters the tensors' device,
appends the current stream's handle to the C entry point's arguments, raises
``RuntimeError`` with the library's own ``<prefix>_error_string`` on a
non-zero return, and counts the launch in ``launches`` under the kernel's
name. A launch recorded into a CUDA graph's capture counts once; the graph's
replays launch it again without a call (train/graph.py counts those).

``use_kernel`` is the route policy of every dispatcher between a kernel and
its plain version (``IMPLS``); ``channels_last`` the layout policy of the
style nets' dispatchers (the fused norm and the blur): both routes take a
channels-last tensor, and a tensor in another layout is copied once and
counted. ``sm_count``, ``H100_SMS`` and ``SM90_SMEM``
are the card's facts the launch plans take.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from soft_intro_vae_torch.utils.profiling import span

BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

HOST_COMPILER = "g++"
HOST_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

# (source path, library stem, extra nvcc flags)
Spec = Tuple[str, str, Tuple[str, ...]]

H100_SMS = 132               # the SM count a plan assumes where it is given none
SM90_SMEM = 232448           # shared memory one CTA may use on sm_90 (227 KB)

# Launches of the hand-written kernels by kernel name, one a wrapper call
# (eager, or recorded into a CUDA graph's capture); a run clears it and reads
# it back to show which path went through the kernels
launches: collections.Counter = collections.Counter()

# The routes of a dispatcher between a kernel and its plain version
IMPLS = ("auto", "plain", "cuda")

# Libraries the same callers need (the style nets' fused norm and blur): the
# first build of any of them compiles all of them at once
BUILT_TOGETHER = ("bias_act_norm", "blur3x3")
_libraries: Dict[str, "Library"] = {}  # every Library, by stem


def use_kernel(impl: str, x: torch.Tensor, what: str) -> bool:
    """Whether a call on ``x`` takes the kernel: ``"auto"`` takes it for a
    CUDA tensor and the plain version for a CPU tensor, ``"plain"`` the plain
    version (to compare the two routes on the card), ``"cuda"`` the kernel,
    which needs a CUDA tensor. A CUDA tensor on the kernel's route launches
    it or raises, and never falls back."""
    if impl not in IMPLS:
        raise NotImplementedError(f"unknown {what} impl: {impl!r}")
    if impl == "cuda" and not x.is_cuda:
        raise ValueError(f"impl='cuda' needs a CUDA tensor, got device {x.device}")
    return impl != "plain" and x.is_cuda


def channels_last(t: torch.Tensor, counter: collections.Counter, what: str) -> torch.Tensor:
    """``t`` in the channels-last layout the style kernels take: ``t`` itself
    where it is, else a copy, counted in ``counter[what]`` (a relayout)."""
    if t.is_contiguous(memory_format=torch.channels_last):
        return t
    counter[what] += 1
    return t.contiguous(memory_format=torch.channels_last)


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The SMs of the card ``device`` names."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; it is needed to build "
                       "the CUDA kernels of soft_intro_vae_torch/ops/csrc")


def library_path(src: str, stem: str, extra_flags: Sequence[str] = (),
                 base_flags: Sequence[str] = NVCC_FLAGS) -> str:
    """Where the built library for this source and these flags lives."""
    flags = " ".join((*base_flags, *extra_flags))
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + flags.encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{stem}_{digest}.so")


def _command(spec: Spec, out: str) -> list:
    src, _, extra = spec
    return [nvcc(), *NVCC_FLAGS, *extra, "-Xptxas", "-v", "-o", out, src]


def _build_all(builds: Sequence[Tuple[Callable[[str], list], str]]) -> None:
    """Run ``command(tmp)`` for every ``(command, out)`` whose ``out`` is not
    built yet, all at once; rename each finished library into place."""
    todo = [(command, out) for command, out in builds if not os.path.exists(out)]
    if todo:
        with span("kernels.build"):
            _compile(todo)


def _compile(builds: Sequence[Tuple[Callable[[str], list], str]]) -> None:
    """Start every build at once, wait for all, move each into place."""
    jobs = []
    for command, out in builds:
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = command(tmp)
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        jobs.append((proc, cmd, tmp, out))
    failures = []
    for proc, cmd, tmp, out in jobs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{os.path.basename(cmd[0])} failed ({proc.returncode}): "
                            f"{' '.join(cmd)}\n{stdout}\n{stderr}")
            continue
        os.replace(tmp, out)
        with open(out + ".log", "w") as f:
            f.write(stdout + stderr)
    if failures:
        raise RuntimeError("\n".join(failures))


def build_many(specs: Sequence[Spec]) -> list:
    """Compile every library that is not built yet, all at once; return the paths."""
    outs = [library_path(*spec) for spec in specs]
    _build_all([(lambda tmp, spec=spec: _command(spec, tmp), out)
                for spec, out in zip(specs, outs)])
    return outs


def build_host_library(src: str, stem: str) -> str:
    """Compile a host C++ source with ``HOST_FLAGS`` unless it is built; return the path."""
    out = library_path(src, stem, base_flags=(HOST_COMPILER, *HOST_FLAGS))
    _build_all([(lambda tmp: [HOST_COMPILER, *HOST_FLAGS, src, "-o", tmp], out)])
    return out


def ptxas_summary(path: str) -> str:
    """The register and shared-memory lines of a library's build log, joined."""
    log = path + ".log"
    if not os.path.exists(log):
        return ""
    with open(log) as f:
        return " | ".join(line.strip() for line in f
                          if "registers" in line or "smem" in line or "spill" in line)


class Library:
    """One kernel library, built and loaded once per process on first use.

    ``spec`` returns the (source, stem, extra flags) triple when called, so a
    test can point a wrapper at another source; ``declare`` sets the
    ``argtypes``/``restype`` of the library's kernel entry points; ``prefix``
    names its ``<prefix>_error_string``, declared here. The first build
    compiles the libraries ``BUILT_TOGETHER`` with this one beside it.
    """

    def __init__(self, spec: Callable[[], Spec], declare: Callable[[ctypes.CDLL], None],
                 prefix: str):
        self.spec = spec
        self.declare = declare
        self.prefix = prefix
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()
        _libraries[spec()[1]] = self

    def build(self) -> str:
        own = self.spec()
        together = [lib.spec() for stem, lib in _libraries.items()
                    if own[1] in BUILT_TOGETHER and stem in BUILT_TOGETHER and stem != own[1]]
        return build_many([own, *together])[0]

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(self.build())
                self.declare(lib)
                errors = getattr(lib, f"{self.prefix}_error_string")
                errors.argtypes = [ctypes.c_int]
                errors.restype = ctypes.c_char_p
                self._lib = lib
            return self._lib

    def check(self, err: int, what: str, context: object) -> None:
        """Raise where a C entry point returned ``err`` != 0: ``what``
        failed, with the library's error string and ``context`` (the plan,
        the shape)."""
        if err != 0:
            text = getattr(self.load(), f"{self.prefix}_error_string")(err).decode()
            raise RuntimeError(f"{what} failed: {text} ({context})")

    def launch(self, kernel: str, entry: str, device: torch.device, *args,
               context: object) -> None:
        """One launch of ``kernel`` through the C entry point ``entry`` on
        ``device``'s current stream, whose handle follows ``args``; does not
        synchronise. Raises with ``context`` (the plan, the shape) on a
        failed launch; counts a launch that succeeded."""
        fn = getattr(self.load(), entry)
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
        self.check(err, f"{kernel} launch", context)
        launches[kernel] += 1
