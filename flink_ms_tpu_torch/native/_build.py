"""Build the port's native library: the persistent store (``store.cpp``),
the epoll lookup server (``lookup_server.cpp``) and the shared-memory arena
reader and batch writer (``arena.cpp``), bound through ``ctypes`` by
``serve/native_store.py`` and ``serve/arena.py``.

The three sources in this directory are compiled by the host's ``g++``
with the flags the JAX package's ``native/Makefile`` uses into one shared
library, ``build/native/libtpums-<hash>.so`` at the repository root (the
sanitizer variants ``libtpums-tsan-<hash>.so`` and ``libtpums-asan-<hash>.so``
beside it), where the hash covers the sources, the headers, the flags and
the compiler's version: an edited source, or another machine's compiler,
builds anew, an unchanged one is reused.  A build links to
a temporary name and renames it into place under a cross-process
``flock``, so concurrent first users build once and a loader never maps a
half-written file.  Building happens at first use, never on import; a
failed build raises with the compiler's output.
"""

from __future__ import annotations

import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Tuple

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
SOURCES = ("store.cpp", "lookup_server.cpp", "arena.cpp")
HEADERS = ("tpums.h", "tpums_internal.h")
CXXFLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra")
LDFLAGS = ("-shared", "-pthread")
# the sanitizer builds differ from the shipped one only by the sanitizer
# and the optimisation level, as in the Makefile's SANFLAGS
VARIANTS = ("", "tsan", "asan")


def flags(variant: str = "") -> Tuple[str, ...]:
    """Compiler flags of one variant ("" is the production build)."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}")
    if not variant:
        return CXXFLAGS
    san = "thread" if variant == "tsan" else "address"
    return (*(f for f in CXXFLAGS if f != "-O2"), "-O1", "-g",
            f"-fsanitize={san}")


def library_path(variant: str = "") -> Path:
    """Where the library of ``variant`` lives once built."""
    h = hashlib.sha256()
    for name in (*SOURCES, *HEADERS):
        h.update(name.encode())
        h.update((SRC_DIR / name).read_bytes())
    h.update(" ".join((*flags(variant), *LDFLAGS)).encode())
    h.update(_cxx_version().encode())
    stem = f"libtpums-{variant}" if variant else "libtpums"
    return BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}.so"


def _cxx() -> str:
    path = os.environ.get("CXX") or shutil.which("g++")
    if not path:
        raise RuntimeError(
            "g++ not found on PATH; the port's native store is built from "
            "flink_ms_tpu_torch/native/ at first use")
    return path


@functools.lru_cache(maxsize=None)
def _cxx_version() -> str:
    """The compiler's first ``--version`` line ("" without a compiler, so
    that a library built elsewhere is never picked up by its name)."""
    try:
        out = subprocess.run([_cxx(), "--version"], capture_output=True,
                             text=True, timeout=60).stdout
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return ""
    return out.splitlines()[0] if out else ""


def build(variant: str = "") -> Path:
    """The library of ``variant``, compiled first if it is not built yet."""
    path = library_path(variant)
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if path.exists():  # another process built it while we waited
            return path
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [_cxx(), *flags(variant),
               *(str(SRC_DIR / s) for s in SOURCES),
               "-o", str(tmp), *LDFLAGS]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"building the native store failed (exit "
                f"{proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, path)
    return path
