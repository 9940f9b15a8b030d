"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` is compiled on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/dist_svgd_torch/lib<name>-<hash>.so

The hash covers the flags, the source and every ``csrc/*.cuh`` header, so a
library is built once per source version and reused after that.  All
requested sources compile in parallel (one ``nvcc`` each, started together).
Nothing here runs at import time: the first call that needs a kernel builds
it, and a missing ``nvcc`` or a failed compile raises — there is no fallback.
While the telemetry tracer is enabled, each compile records a
``kernel_build`` instant (tagged with the library and its ``nvcc`` seconds)
inside whatever span was active on the building thread.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, Optional

from dist_svgd_torch.telemetry import trace as _trace

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "dist_svgd_torch"

#: The kernels, by library name: each is ``csrc/<name>.cu``.
SOURCES = ("phi_small_d", "phi_big_d", "phi_big_d_bf16x3", "phi_wide_d",
           "phi_wide_d_bf16x3", "ot_ctransform", "ot_kexp", "ot_kmat_vec", "ot_plan_grad")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


@dataclass
class BuildResult:
    """One compiled library: where it is, how long ``nvcc`` took (0 when it
    was already built for this source hash), and the compiler's output
    (``-Xptxas -v``: registers, shared memory and spills per kernel)."""

    name: str
    path: Path
    seconds: float
    cached: bool
    log: str


def find_nvcc() -> str:
    """Path of ``nvcc`` (``PATH``, then ``$CUDA_HOME/bin``, then
    ``/usr/local/cuda/bin``); raises ``RuntimeError`` when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").is_file():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels are compiled from "
        f"{CSRC} on first use and need the CUDA toolkit"
    )


def source_digest(name: str, csrc: Path = CSRC) -> str:
    """Hash of what a library is built from: flags, source, headers."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [csrc / f"{name}.cu", *sorted(csrc.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str, csrc: Path = CSRC) -> Path:
    return BUILD_DIR / f"lib{name}-{source_digest(name, csrc)}.so"


#: Libraries this process compiled (``kernel_build`` events), monotonic.
_builds = 0
_builds_lock = threading.Lock()


def _note_build() -> None:
    global _builds
    with _builds_lock:
        _builds += 1


def builds_total() -> int:
    """Kernel libraries compiled by this process so far (each also a
    ``kernel_build`` instant while the tracer is on)."""
    with _builds_lock:
        return _builds


def build(names: Optional[Iterable[str]] = None, csrc: Path = CSRC) -> Dict[str, BuildResult]:
    """Compile every named source whose library is missing, all in
    parallel; return a :class:`BuildResult` per name.  Raises
    ``RuntimeError`` with the compiler output when any compile fails.
    ``csrc`` is the directory of the sources (another version of them, for
    an old-against-new timing: ``tools/ot_ab.py``)."""
    names = list(SOURCES if names is None else names)
    unknown = set(names) - set(SOURCES)
    if unknown:
        raise ValueError(f"unknown kernel sources {sorted(unknown)}; have {SOURCES}")
    results: Dict[str, BuildResult] = {}
    todo = []
    for name in names:
        target = library_path(name, csrc)
        if target.is_file():
            results[name] = BuildResult(name, target, 0.0, True, "")
        else:
            todo.append((name, target))
    if not todo:
        return results
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    for name, target in todo:
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(csrc / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, target, time.perf_counter())
    failures = []
    for name, (proc, tmp, target, t0) in running.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"--- nvcc {name} (exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, target)
        results[name] = BuildResult(name, target, seconds, False, log)
        _note_build()
        _trace.instant("kernel_build", {"kernel": name, "seconds": round(seconds, 3)}
                       if _trace.enabled() else None)
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return results


_LIBRARIES: Dict[str, ctypes.CDLL] = {}


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _LIBRARIES.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name].path))
        _LIBRARIES[name] = lib
    return lib
