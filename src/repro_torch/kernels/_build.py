"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Every ``csrc/*.cu`` compiles on its own into ``lib<stem>.so`` with a plain C
interface (no PyTorch headers, so a build takes seconds, not minutes). The
libraries land in ``build/kernels-<hash>/`` at the repository root, where
``<hash>`` covers the sources and the flags, so an edited kernel never loads
a stale binary. The build runs at first use — all sources at once, one
``nvcc`` each — and nothing here runs at import: the CPU tests import every
module of the port on machines without a toolkit.

The helpers at the end are shared by the kernel wrappers: each C entry
bound once with its signature, operand checks (a wrapper raises on what its
kernel does not take), the current-device guard, the stream, and the
launch-error check (each C entry returns ``cudaGetLastError()``). They keep
a launch's host path short: no signature set, no device switch and no
stream object made per call beyond what the launch needs.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

__all__ = ["NVCC_FLAGS", "build", "load", "bind", "check_no_grad",
           "check_operands", "on_device", "stream_of", "check_launch"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
_BOUND: dict[tuple[str, str], object] = {}
_SAME_DEVICE = contextlib.nullcontext()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _build_dir() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_ROOT / f"kernels-{digest.hexdigest()[:16]}"


def build() -> dict[str, str]:
    """Compile every source not yet built, all ``nvcc`` processes started
    together. Returns ``{stem: compiler output}`` of the ones it built
    (``-Xptxas -v`` reports registers and shared memory per kernel)."""
    out = _build_dir()
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        lib = out / f"lib{src.stem}.so"
        if lib.exists():
            continue
        tmp = out / f"lib{src.stem}.{os.getpid()}.tmp"
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((src.stem, lib, tmp, proc))
    logs, failed = {}, []
    for stem, lib, tmp, proc in jobs:
        logs[stem], _ = proc.communicate()
        if proc.returncode:
            failed.append(f"{stem}.cu:\n{logs[stem]}")
        else:
            os.replace(tmp, lib)     # atomic: a concurrent loader never
            #                          sees a half-written library
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded ``lib<name>.so``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build()
        lib = ctypes.CDLL(str(_build_dir() / f"lib{name}.so"))
        _LIBS[name] = lib
    return lib


def bind(name: str, entry: str, argtypes: list, restype=ctypes.c_int):
    """The C function ``entry`` of ``lib<name>.so`` with its ``argtypes``
    and ``restype`` set, resolved on the first call for this (library,
    entry) and returned from a cache after that."""
    fn = _BOUND.get((name, entry))
    if fn is None:
        fn = getattr(load(name), entry)
        fn.argtypes, fn.restype = argtypes, restype
        _BOUND[(name, entry)] = fn
    return fn


def check_no_grad(kernel: str, **operands: torch.Tensor | None) -> None:
    """Raise ``RuntimeError`` when autograd is recording and an operand
    requires grad. A kernel fills its output through ``ctypes``, which
    autograd cannot see: the output would come back detached and the
    gradient would stop there without a word. Every wrapper calls this on
    every device, so a CPU run catches what the card would drop; a kernel
    with a backward is reached through its ``torch.autograd.Function``
    (``rglru_scan.ops.RGLRUScan``), which hands the wrapper detached
    tensors."""
    if not torch.is_grad_enabled():
        return
    for name, t in operands.items():
        if t is not None and t.requires_grad:
            raise RuntimeError(
                f"{kernel}: {name} requires grad, and the kernel's output "
                f"would be detached from autograd; call it under "
                f"torch.no_grad() or through an autograd.Function")


def check_operands(kernel: str, dtypes: dict[str, torch.dtype] | None = None,
                   **operands: torch.Tensor) -> torch.device:
    """Raise unless every operand is a contiguous tensor on one CUDA device,
    of the dtype ``dtypes`` names for it (fp32 where it names none);
    returns that device."""
    devices = {t.device for t in operands.values()}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"{kernel}: operands must share one CUDA device, "
                         f"got {sorted(map(str, devices))}")
    for name, t in operands.items():
        want = (dtypes or {}).get(name, torch.float32)
        if t.dtype != want:
            raise TypeError(f"{kernel}: {name} is {t.dtype}, kernel takes "
                            f"{str(want).removeprefix('torch.')}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} is not contiguous")
    return devices.pop()


@functools.cache
def _one_device() -> bool:
    return torch.cuda.device_count() == 1


def on_device(device: torch.device):
    """A context in which ``device`` is the current CUDA device. The C
    entries launch on the current device (and raise shared-memory limits
    there), so operands on another card need the switch. With one visible
    card, or when ``device`` is already current, it is a no-op that costs
    no device query."""
    if _one_device() or device.index == torch.cuda.current_device():
        return _SAME_DEVICE
    return torch.cuda.device(device)


def stream_of(device: torch.device) -> int:
    """PyTorch's current stream on ``device`` as a raw handle, as the C
    entries take it (a ``c_void_p`` argument). It reads the handle without
    building a ``torch.cuda.Stream`` object, which
    ``torch.cuda.current_stream(device).cuda_stream`` would do on every
    launch."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def check_launch(kernel: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{kernel}: launch failed with CUDA error {err}")
