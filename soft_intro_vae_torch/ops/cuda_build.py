"""Build and load the port's hand-written CUDA kernels (``ops/csrc/*.cu``).

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
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Callable, Optional, Sequence, Tuple

from soft_intro_vae_torch.utils.profiling import span

BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

HOST_COMPILER = "g++"
HOST_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

# (source path, library stem, extra nvcc flags)
Spec = Tuple[str, str, Tuple[str, ...]]


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
    ``argtypes``/``restype`` of the library's C functions; ``companions``
    returns the specs of the libraries that the same callers need, which the
    first build compiles beside this one (the style nets' fused norm and
    blur).
    """

    def __init__(self, spec: Callable[[], Spec], declare: Callable[[ctypes.CDLL], None],
                 companions: Callable[[], Sequence[Spec]] = tuple):
        self.spec = spec
        self.declare = declare
        self.companions = companions
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()

    def build(self) -> str:
        return build_many([self.spec(), *self.companions()])[0]

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(self.build())
                self.declare(lib)
                self._lib = lib
            return self._lib
