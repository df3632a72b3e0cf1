"""Build the port's native sources (pegasus_tpu_torch/csrc/<name>.cu or
<name>.cpp) at first use.

A `.cu` source compiles with nvcc, for sm_90a, and a `.cpp` source (the
host loops, csrc/hostops.cpp) with g++, each into a shared library with
a plain C interface under <repo>/.torch_ext/, loaded with ctypes. A
library is named by the hash of its source, so an edited source
rebuilds and an unchanged one loads as built. Host code gets no
`-march=native`: a library may be loaded on another host than the one
that built it.

A plain C interface (pointers and the stream passed as integers) keeps
PyTorch's headers out of the compile: nvcc then takes seconds per source
instead of minutes. A build failure raises with the compiler's output;
nothing falls back.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), ".torch_ext")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_LOADED = {}
# one build or load of a library at a time in this process (the first
# merges of a cold service arrive on concurrent RPC threads); different
# sources build side by side
_LOCKS_LOCK = threading.Lock()
_LOCKS = {}


def _lock(name: str) -> threading.Lock:
    with _LOCKS_LOCK:
        return _LOCKS.setdefault(name, threading.Lock())


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    if cand and os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is required to "
                           "build pegasus_tpu_torch/csrc")
    return found


def _source(name: str) -> str:
    """csrc/<name>.cu, else csrc/<name>.cpp."""
    cu = os.path.join(CSRC, name + ".cu")
    return cu if os.path.exists(cu) else os.path.join(CSRC, name + ".cpp")


def _lib_path(name: str) -> str:
    with open(_source(name), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def _command(name: str, out: str) -> list:
    src = _source(name)
    if src.endswith(".cpp"):
        return ["g++", "-std=c++17", "-O3", "-shared", "-fPIC", "-o", out,
                src]
    return [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", out, src]


def build(name: str) -> str:
    """Compile csrc/<name>.cu or .cpp unless it is built already. -> the
    compiler's report (nvcc's ptxas report of registers, shared memory
    and spills; g++'s warnings, mostly empty), kept beside the library.
    Raises with the compiler output when the build fails."""
    with _lock(name):
        return _build_locked(name)


def _build_locked(name: str) -> str:
    out = _lib_path(name)
    report = out + ".ptxas.txt"
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        # another process may build the same library beside this one
        tmp = out + f".{os.getpid()}.{threading.get_ident()}.tmp"
        cmd = _command(name, tmp)
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"{os.path.basename(cmd[0])} failed for "
                f"{os.path.basename(_source(name))} (rc {proc.returncode}):"
                f"\n{proc.stdout}")
        with open(report, "w") as f:
            f.write(proc.stdout)
        os.replace(tmp, out)
    with open(report) as f:
        return f.read()


def load(name: str) -> ctypes.CDLL:
    """The built library for csrc/<name>, building it if needed."""
    with _lock(name):
        lib = _LOADED.get(name)
        if lib is None:
            _build_locked(name)
            lib = _LOADED[name] = ctypes.CDLL(_lib_path(name))
        return lib
