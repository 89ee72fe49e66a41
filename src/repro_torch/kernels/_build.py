"""Build the CUDA sources in ``csrc/`` into shared libraries at first use.

Each ``csrc/<name>.cu`` becomes one library with a plain C interface,
compiled by ``nvcc`` for ``sm_90a`` and loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds).  Libraries land in ``_build/`` under a
name that carries a hash of the sources, so an edited source is rebuilt
and a stale library is never loaded.  ``build`` starts one ``nvcc`` per
missing library, all at once, and waits for all of them.

A ``CudaKernel`` binds one C entry point and counts its launches: the count
goes up by one where the kernel was launched and nowhere else, so a run
can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build"
# -split-compile=0 lets one source's optimizer use the cores the other,
# shorter builds leave idle (flash_attention_pipelined.cu has 90 kernels)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
              "-split-compile=0")
#: Dynamic shared memory one block may use on sm_90 (bytes).
MAX_SMEM = 232_448

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the PATH, else the
    toolkit's default install location."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    if shutil.which("nvcc"):
        cands.append(shutil.which("nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise KernelBuildError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "the PATH); the CUDA kernels build only where the "
                           "CUDA toolkit is installed")


def library_names() -> list[str]:
    """One library per ``csrc/*.cu`` source."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _lib_path(name: str) -> pathlib.Path:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names=None) -> dict[str, pathlib.Path]:
    """Compile every named library that is not built yet, all in parallel.

    Returns the library paths; raises ``KernelBuildError`` with nvcc's
    output if any source fails to compile.  Each ``<lib>.log`` keeps nvcc's
    ``-Xptxas -v`` report (registers, shared memory, spills).
    """
    names = library_names() if names is None else list(names)
    paths = {n: _lib_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n, p in todo.items():
        tmp = p.with_name(f"{p.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, p)
    failed = []
    for n, (proc, tmp, p) in procs.items():
        out, _ = proc.communicate()
        p.with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"--- {n} (nvcc exit {proc.returncode}) ---\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, p)
    if failed:
        raise KernelBuildError("\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


class CudaKernel:
    """One hand-written kernel: its C entry point and its launch count.

    ``replaces`` names the TPU kernel it ports (file:line of its ``def``);
    ``source`` is its CUDA file in the repo.
    """

    def __init__(self, name: str, *, lib: str, symbol: str, argtypes,
                 replaces: str):
        self.name = name
        self.lib = lib
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.replaces = replaces
        self.source = f"src/repro_torch/kernels/csrc/{lib}.cu"
        self.launches = 0
        self._fn = None
        KERNELS[name] = self

    def _entry(self):
        if self._fn is None:
            lib = load(self.lib)
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = (lib, fn)
        return self._fn

    def launch(self, *args) -> None:
        """Call the C entry point (which launches on the given stream and
        returns ``cudaGetLastError()``); raise on a non-zero code."""
        lib, fn = self._entry()
        err = fn(*args)
        if err:
            msg = lib.repro_cuda_error_string(err).decode()
            raise RuntimeError(f"{self.name}: CUDA error {err} ({msg})")
        self.launches += 1


#: Every kernel of the port by name (filled as the wrapper modules import).
KERNELS: dict[str, CudaKernel] = {}


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> dict[str, int]:
    """Launch count of every kernel by name."""
    return {n: k.launches for n, k in KERNELS.items()}


def ptr(t) -> ctypes.c_void_p:
    """Device address of a tensor's first element."""
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    """The current PyTorch stream on the tensor's device."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
