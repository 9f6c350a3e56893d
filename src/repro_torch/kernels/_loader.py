"""Builds the CUDA sources in csrc/ into one shared library and loads it.

The build happens at first use, never at import, and once in every process
that launches a kernel (a few seconds): ``nvcc`` compiles each source for
sm_90a in its own process, all started together, and one link step joins the
objects into a library in a directory of its own under ``_build/``, which is
removed again once the library is loaded.  Nothing built earlier is ever
loaded, so the kernels that run are always those of the sources on disk.
The library has a plain C interface and is bound with ``ctypes`` once, when
it is loaded: pointers come from ``Tensor.data_ptr()``, the stream is the
device's current one.  A failed build raises; there is nothing
to fall back to.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

_HERE = Path(__file__).resolve().parent
CSRC_DIR = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: The library's entry points by name, bound once when it is loaded.
_entry: Dict[str, Callable[..., int]] = {}
#: Seconds this process's build took (0.0 before it).
last_build_seconds: float = 0.0

_c_ptr = ctypes.c_void_p
_SIGNATURES = {
    "dyskew_topk_gating": (
        _c_ptr, _c_ptr, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, _c_ptr,
    ),
    "dyskew_load_histogram": (
        _c_ptr, _c_ptr, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, _c_ptr,
    ),
    "dyskew_dispatch_gather": (
        _c_ptr, _c_ptr, _c_ptr, _c_ptr, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_int, _c_ptr,
    ),
    "dyskew_moe_combine": (
        _c_ptr, _c_ptr, _c_ptr, _c_ptr, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, _c_ptr,
    ),
    "dyskew_moe_combine_bwd": (
        _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, _c_ptr,
    ),
    "dyskew_ssd_state_scan": (
        _c_ptr, _c_ptr, _c_ptr, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_int, _c_ptr,
    ),
    "dyskew_ssd_state_scan_bwd": (
        _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, _c_ptr,
    ),
}


def sources() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and under CUDA_HOME): the CUDA "
        "kernels cannot be built on this machine"
    )


def build(out_dir: Path, verbose: bool = False) -> Path:
    """Compile every source in parallel into ``out_dir`` and link; returns
    the library path.  With ``verbose`` the per-kernel register and
    shared-memory use that ``ptxas`` reports is printed."""
    global last_build_seconds
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    extra = ("-Xptxas", "-v") if verbose else ()
    jobs = []
    for s in srcs:
        obj = out_dir / f"{s.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-c", str(s), "-o", str(obj)]
        jobs.append((s, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    failed = []
    for s, obj, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{s.name}:\n{log}")
        elif verbose and log:
            print(log, flush=True)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    out = out_dir / "libdyskew_kernels.so"
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(out), *[str(obj) for _, obj, _ in jobs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"linking {out.name} failed:\n{link.stdout}")
    last_build_seconds = time.perf_counter() - t0
    return out


def lib(verbose: bool = False) -> ctypes.CDLL:
    """The loaded library, built by the first call in this process."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            # The mapped library outlives its file, so the directory can go
            # as soon as it is loaded.
            with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
                loaded = ctypes.CDLL(str(build(Path(tmp), verbose=verbose)))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(loaded, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
                _entry[name] = fn
            _lib = loaded
        return _lib


def launch(name: str, device, *args) -> None:
    """Call the library's launch function ``name`` with ``args`` followed by
    ``device``'s current stream, and raise if it returns a CUDA error.  The
    launch is asynchronous: a fault during the run shows at the next
    synchronisation."""
    import torch

    fn = _entry.get(name)
    if fn is None:
        lib()
        fn = _entry[name]
    # The raw handle of the device's current stream, as
    # ``torch.cuda.current_stream().cuda_stream`` gives it but without
    # building a Stream object on every call, which was the largest piece
    # of a small launch's host time.
    current = torch.cuda.current_device()
    if device.index is None or device.index == current:
        code = fn(*args, torch._C._cuda_getCurrentRawStream(current))
    else:
        with torch.cuda.device(device):
            code = fn(*args, torch._C._cuda_getCurrentRawStream(device.index))
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")
