"""Build and bind the port's CUDA kernels: one shared library per source
in `csrc/`, compiled with `nvcc` for `sm_90a` at first use into `build/`
beside the package, and loaded with ctypes.

A library is keyed by its source and `NVCC_FLAGS`: `build/lib<stem>_<hash>.so`
is rebuilt only when either changes, and the compiler's `-Xptxas -v`
report goes to the `.log` beside it.  Each source exports a plain C
interface whose functions launch on the given stream and return
`cudaGetLastError()` (0 = success), so every bound function returns
`int`.  `build_libraries` starts one `nvcc` process per source that needs
building, all at once, and waits for them.  `launch` calls a bound entry
point on PyTorch's current stream.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Sequence

import torch
import torch.autograd.forward_ad as fwAD

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[Path, ctypes.CDLL] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the port's kernels are built with "
                       "the CUDA toolkit on the machine with the card")


def _digest(source: Path) -> str:
    return hashlib.sha256(source.read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]


def build_libraries(sources: Sequence[Path]) -> List[Path]:
    """Compile each source whose library is not built yet, one `nvcc`
    process each, all started together; returns the library paths."""
    sources = [Path(s) for s in sources]
    libs = [BUILD_DIR / f"lib{s.stem}_{_digest(s)}.so" for s in sources]
    jobs = []
    for source, so in zip(sources, libs):
        if so.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen([nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                                 str(source)], stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        jobs.append((source, so, tmp, proc))
    failed = []
    for source, so, tmp, proc in jobs:
        out, err = proc.communicate()
        so.with_suffix(".log").write_text(out + err)
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {source}:\n{err}")
        else:
            os.replace(tmp, so)    # atomic: another process sees all or none
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


def load_library(source: Path, functions: Dict[str, Sequence]) -> ctypes.CDLL:
    """The library of `source`, built unless it is already and loaded once
    per process, with each entry of `functions` (name -> ctypes argtypes)
    bound to return int."""
    source = Path(source)
    lib = _loaded.get(source)
    if lib is None:
        lib = ctypes.CDLL(str(build_libraries([source])[0]))
        for name, argtypes in functions.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _loaded[source] = lib
    return lib


def check_operand(kernel: str, name: str, t: torch.Tensor,
                  ref: torch.Tensor, ref_name: str):
    """Refuse a tensor a kernel does not take: `t` must lie on `ref`'s CUDA
    device, have `ref`'s dtype (float32 or float64) and be contiguous."""
    if t.device.type != "cuda" or t.device != ref.device:
        raise ValueError(f"{kernel}: {name} must lie on {ref.device} (cuda), "
                         f"got {t.device}")
    if t.dtype not in (torch.float32, torch.float64) or t.dtype != ref.dtype:
        raise TypeError(f"{kernel}: {name} must be float32 or float64 and "
                        f"match {ref_name} ({ref.dtype}), got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")


_is_wrapped = torch._C._functorch.is_functorch_wrapped_tensor
_func_level = torch._C._functorch.maybe_current_level


def autodiff_active() -> bool:
    """Whether a `torch.func` transform or a forward-mode dual level is
    active: only then can a tensor that does not require grad carry a
    derivative.  One cheap query per product; `carries_derivative` then
    decides per tensor."""
    return _func_level() is not None or fwAD._current_level >= 0


def carries_derivative(t: torch.Tensor) -> bool:
    """Whether `t` takes part in automatic differentiation: it requires
    grad, it is wrapped by a `torch.func` transform (a jvp, vjp or vmap in
    progress), or it carries a forward-mode tangent of the active dual
    level.  A kernel reads raw memory and would drop the derivative."""
    if t.requires_grad or _is_wrapped(t):
        return True
    return (fwAD._current_level >= 0
            and fwAD.unpack_dual(t).tangent is not None)


def check_no_derivative(kernel: str, name: str, t: torch.Tensor):
    """Refuse a tensor that carries a derivative (`carries_derivative`):
    the kernel computes values only, so the derivative would be lost
    silently.  Differentiate the plain version (a CPU tensor) or F."""
    if carries_derivative(t):
        raise ValueError(
            f"{kernel}: {name} carries a derivative (requires grad, a "
            f"torch.func transform, or a forward-mode tangent); the CUDA "
            f"kernel computes values only and would drop it")


def launch(fn, index: int, *args) -> int:
    """`fn(*args, stream)` with PyTorch's current raw stream of CUDA device
    `index`; returns fn's error code.  A call on the current device builds
    neither a `torch.cuda.device` context nor a `torch.cuda.Stream` object;
    another device is entered for the call."""
    C = torch._C
    if C._cuda_getDevice() == index:
        return fn(*args, C._cuda_getCurrentRawStream(index))
    with torch.cuda.device(index):
        return fn(*args, C._cuda_getCurrentRawStream(index))
