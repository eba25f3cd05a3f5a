"""Builds the port's CUDA kernels with nvcc and loads them with ctypes.

Each `csrc/<name>.cu` has a plain C entry point and includes no PyTorch
header, so nvcc compiles it in seconds. The shared library goes to
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
KERNELS = ("ms_deform_attn_fwd", "ms_deform_attn_bwd", "window_attention_fwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

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


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def sources(name: str) -> List[Path]:
    """The kernel's source and every file of csrc/ it includes, directly or not."""
    found, todo = [], [CSRC / f"{name}.cu"]
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
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
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
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
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
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
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
