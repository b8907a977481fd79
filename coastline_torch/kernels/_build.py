"""Build and load the hand-written CUDA kernels under `coastline_torch/csrc/`.

Each `csrc/<name>.cu` has a plain C interface and is compiled by `nvcc` on
first use into its own shared library under `build/coastline_torch/`,
loaded with ctypes. All sources are compiled in parallel, one `nvcc` each.
Library names carry a hash of the source, the shared headers
(`csrc/*.cuh`) and the flags, so an edited source or header is never served
from a stale build. Nothing here runs at import
time: the CPU tests import every module and have no `nvcc`.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "coastline_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return found


def _target(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    return BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:16]}.so"


def build_all() -> Dict[str, str]:
    """Compile every stale source in parallel; returns {name: ptxas log}.

    Raises with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in sorted(CSRC.glob("*.cu")):
        out = _target(src)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[src.stem] = (out, tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (out, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
        out.with_suffix(".log").write_text(log)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, building it on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            target = _target(CSRC / f"{name}.cu")
            if not target.exists():
                build_all()
            lib = _libs[name] = ctypes.CDLL(str(target))
        return lib


def refuse_grad(name: str, *tensors):
    """Raise if autograd would record a call of kernel `name` on `tensors`:
    the CUDA kernels have no backward, and a result written through ctypes
    carries no graph, so the gradients above it would be lost without a
    word. Call the kernels under `torch.no_grad()`/`torch.inference_mode()`;
    training takes the plain versions."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"the CUDA kernel {name} has no backward: call it under torch.no_grad() or "
            "torch.inference_mode() (train mode takes its plain version)")


def tracing(*tensors) -> bool:
    """Whether a kernel wrapper's call is being traced (`torch.export`,
    `torch.compile`, `make_fx`, or any dispatch mode) rather than run: then
    it calls its custom op, which the trace records as one node. Run
    eagerly, a wrapper calls the op's registered body for the tensor's
    device itself, since the dispatcher's Python path costs tens of
    microseconds a call."""
    return (torch.compiler.is_compiling() or torch._C._len_torch_dispatch_stack() > 0
            or any(type(t) is not torch.Tensor for t in tensors))


def check_card_inputs(*tensors):
    """Raise unless `tensors` are contiguous and on one device: a kernel
    reads them as raw NHWC pointers, so a strided view would give a wrong
    result without an error. Each op's CUDA registration calls it, so an
    exported program's call is checked as an eager one is."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError("all tensors must be on one device")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(
                "CUDA inputs must be contiguous: pass the NHWC view of a channels_last "
                f"activation (got shape {tuple(t.shape)}, strides {t.stride()})")


def check(status: int, what: str):
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status}")
