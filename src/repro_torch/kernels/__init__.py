"""Hand-written CUDA kernels for Hopper (``sm_90a``) and their loader.

Each kernel is one ``csrc/<name>.cu`` with a plain C entry point.  At
first use the sources are compiled with ``nvcc`` — one process per
source, all started together — into ``build/repro_torch/`` at the root
of the checkout, each library named by a hash of its source and flags,
and loaded with ``ctypes``.  Nothing is compiled when this package is
imported: the CPU tests import every module and never build.

Each kernel module (``confidence_gate.py``, ``ragged_attention.py``,
``paged_attention.py``, ``mixed_attention.py``, ``router_gate.py``,
``flash_attention.py``, ``rwkv6_scan.py``, ``mamba_scan.py``) holds
the launcher of one of the eight kernels and its plain PyTorch version;
``prefill_attention.py`` delegates to ``mixed_attention.py``; ``ops.py``
holds the dispatching wrappers the model calls, with their launch
counters.  Device code shared between kernels lives in ``csrc/*.cuh``.
Every launcher calls its entry point under :func:`device_guard` for its
tensors' device, on that device's current stream (:func:`stream_handle`).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

import torch

KERNELS = ("confidence_gate", "ragged_attention", "paged_attention",
           "mixed_attention", "router_gate", "flash_attention", "rwkv6_scan",
           "mamba_scan")

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# name -> loaded library (one per process; the .so on disk is the cache)
_LIBS: Dict[str, ctypes.CDLL] = {}
# (device index, stream) -> the int32 counters of the last-block merges
# (confidence_gate's rows, moe_route's groups).  Every launch leaves the
# counters it uses at zero and launches on one stream run in order, so
# one buffer serves every kernel on a stream.
_COUNTERS: Dict[Tuple[int, int], torch.Tensor] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH): the "
            "repro_torch CUDA kernels are compiled at first use")
    return found


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: keyed by a hash of the source,
    every shared header in ``csrc/`` and the compiler flags, so an edited
    source or header rebuilds."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, float]:
    """Compile every named kernel whose library is missing, one ``nvcc``
    per source, all running at once.  Returns seconds spent per kernel
    built (0.0 for one already on disk); the compiler's ``-Xptxas -v``
    report goes to ``<library>.log`` beside each library.  Raises with
    the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    out: Dict[str, float] = {}
    t0 = time.perf_counter()
    for name in names:
        lib = library_path(name)
        if lib.is_file():
            out[name] = 0.0
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        log = open(lib.with_suffix(".log"), "w")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=log,
                                        stderr=subprocess.STDOUT),
                       tmp, lib, log)
    failed = []
    for name, (proc, tmp, lib, log) in procs.items():
        rc = proc.wait()
        log.close()
        out[name] = time.perf_counter() - t0
        if rc != 0:
            failed.append(f"{name} (nvcc exit {rc}):\n"
                          + lib.with_suffix(".log").read_text())
            continue
        os.replace(tmp, lib)        # atomic: concurrent builders agree
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The kernel library for ``csrc/<name>.cu``, built if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib


def stream_handle(device: torch.device) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on `device`, for a kernel launch."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def device_guard(device: torch.device):
    """The current CUDA device set to `device` (its tensors' device) for
    the length of a C entry point's call: the entry points configure
    their kernels (``cudaFuncSetAttribute``) and launch on the current
    device, so a tensor on ``cuda:1`` while ``cuda:0`` is current
    launches where it lives."""
    return torch.cuda.device(device)


def check_launch(err: int, name: str) -> None:
    """Raise if the C entry point reported a CUDA error (a refused launch
    never runs, and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def require_cuda(name: str, *tensors: Optional[torch.Tensor]) -> None:
    """Every given tensor must be a contiguous CUDA tensor on one device."""
    dev = None
    for t in tensors:
        if t is None:
            continue
        if t.device.type != "cuda":
            raise ValueError(f"{name}: expected CUDA tensors, got {t.device}")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def zeroed_counters(device: torch.device, stream: int,
                    n: int) -> torch.Tensor:
    """At least ``n`` int32 counters, all zero, for launches on
    ``stream`` of ``device``."""
    key = (device.index, stream)
    cnt = _COUNTERS.get(key)
    if cnt is None or cnt.numel() < n:
        cnt = torch.zeros(max(n, 64), dtype=torch.int32, device=device)
        _COUNTERS[key] = cnt
    return cnt


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The SMs of CUDA device ``index``, which the split plans fill."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())
