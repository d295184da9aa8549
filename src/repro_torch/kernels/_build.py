"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``.  The
build runs at first use, from the sources in the checkout only, into
``build/repro_torch/`` at the checkout's root, so the package runs from
the checkout's ``src/`` (``PYTHONPATH=src`` or an editable install).
Each library's file name carries a hash of the flags, its source and
every ``csrc`` header the source includes (``#include "x.cuh"``, followed
through the headers), so an edited source or header is rebuilt, with
every library that includes it, and an unchanged one is loaded as it is.
``ptxas`` reports each kernel's registers, shared memory and spills;
the report is kept beside the library (:func:`ptxas_report`).  A missing
``nvcc`` or a failed build raises: there is no fallback to the plain
versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "kernels" / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)

_loaded: dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    """``build/repro_torch`` at the root of the checkout the package runs
    from.  Raises where the package does not sit in a checkout's ``src/``
    (a non-editable install) rather than build beside the installed
    package, where other checkouts would meet its libraries."""
    if PKG.parent.name != "src":
        raise RuntimeError(
            f"repro_torch builds its CUDA kernels into the checkout it runs "
            f"from, but {PKG} is not in a checkout's src/; run with "
            f"PYTHONPATH=src or an editable install")
    return PKG.parent.parent / "build" / "repro_torch"


def nvcc_path() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the CUDA kernels are built from source")
    return found


def sources(name: str) -> list[Path]:
    """``csrc/<name>.cu`` and every ``csrc`` header it includes, directly
    or through another header, in the order first met."""
    found = [CSRC / f"{name}.cu"]
    for path in found:
        for inc in _INCLUDE.findall(path.read_text()):
            dep = CSRC / inc
            if dep.is_file() and dep not in found:
                found.append(dep)
    return found


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources(name):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return build_dir() / f"lib{name}-{_digest(name)}.so"


def build(name: str) -> float:
    """Compile ``csrc/<name>.cu`` unless its library is already there.
    Returns the seconds the build took (0.0 where nothing was built)."""
    out = library_path(name)
    if out.exists():
        return 0.0
    out.parent.mkdir(parents=True, exist_ok=True)
    # written aside and renamed, so no process loads a half-written library
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    r = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                        str(CSRC / f"{name}.cu")],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"CUDA kernel build of {name} failed (nvcc "
                           f"exited {r.returncode}):\n{r.stdout}{r.stderr}")
    out.with_suffix(".ptxas.txt").write_text(r.stdout + r.stderr)
    os.replace(tmp, out)
    return time.perf_counter() - t0


def ptxas_report(name: str) -> list[tuple[str, int, int]]:
    """(kernel symbol, registers, spill bytes stored + loaded) for each
    kernel of ``csrc/<name>.cu``, from the ``-Xptxas -v`` report of its
    build; empty where the library was built without one."""
    path = library_path(name).with_suffix(".ptxas.txt")
    if not path.exists():
        return []
    out, kernel, spill = [], None, 0
    for line in path.read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            kernel, spill = m.group(1), 0
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel is not None:
            out.append((kernel, int(m.group(1)), spill))
            kernel = None
    return out


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build(name)
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
