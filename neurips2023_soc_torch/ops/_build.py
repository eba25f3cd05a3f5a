"""Builds the port's CUDA kernels with nvcc, and its host C++ code with the
host C++ compiler, and loads them with ctypes.

Each `csrc/<name>.cu` (or host `csrc/<name>.cpp`) has a plain C entry point
and includes no PyTorch header, so it compiles in seconds. The shared library goes to
`build/torch_kernels/` at the root of the checkout (git-ignored), named by a
hash of its source and of the csrc/ headers it includes, so an edited source or
header is rebuilt and an unchanged one is reused. Nothing is built when a module
is imported: the first kernel launch, or `build_all`, builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
KERNELS = ("ms_deform_attn_fwd", "ms_deform_attn_bwd", "window_attention_fwd",
           "layer_norm_fwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
CXX_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC")  # csrc/*.cpp: host code

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the port's CUDA kernels cannot be built")


def _cxx() -> str:
    found = shutil.which(os.environ.get("CXX", "c++"))
    if found:
        return found
    raise RuntimeError("no host C++ compiler ($CXX or c++ on PATH): the port's host "
                       "libraries cannot be built")


def _source(name: str) -> Path:
    """csrc/<name>.cu (a CUDA kernel) or csrc/<name>.cpp (host code)."""
    cu = CSRC / f"{name}.cu"
    return cu if cu.exists() else CSRC / f"{name}.cpp"


def _command(name: str) -> List[str]:
    """The compiler and its flags for one source, by its suffix."""
    if _source(name).suffix == ".cu":
        return [_nvcc(), *NVCC_FLAGS]
    return [_cxx(), *CXX_FLAGS]


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def sources(name: str) -> List[Path]:
    """The kernel's source and every file of csrc/ it includes, directly or not."""
    found, todo = [], [_source(name)]
    while todo:
        path = todo.pop()
        if path in found:
            continue
        found.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            todo.append(path.parent / inc.decode())
    return found


def library_path(name: str) -> Path:
    """Named by a hash of the flags and of every source file the kernel includes, so
    that an edited header rebuilds each kernel that includes it."""
    flags = NVCC_FLAGS if _source(name).suffix == ".cu" else CXX_FLAGS
    h = hashlib.sha256(" ".join(flags).encode())
    for path in sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Starts nvcc for one source; returns (target, process) or (target, None)
    when the library is already built."""
    target = library_path(name)
    if target.exists():
        return target, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [*_command(name), "-o", str(tmp), str(_source(name))]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return target, (proc, tmp)


def build_all(names: Iterable[str] = KERNELS) -> Dict[str, Path]:
    """Builds every named kernel, one nvcc per source, all started together.
    Raises RuntimeError with the compiler's output if any build fails."""
    started = {name: _start(name) for name in names}
    failures = []
    for name, (target, job) in started.items():
        if job is None:
            continue
        proc, tmp = job
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}: {Path(proc.args[0]).name} exited "
                            f"{proc.returncode}\n{log}")
            continue
        os.replace(tmp, target)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return {name: target for name, (target, _) in started.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded shared library of one kernel, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all([name])[name]))
        _loaded[name] = lib
    return lib
