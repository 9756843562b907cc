"""Build and load the port's CUDA kernels.

Counterpart of ``paddle_tpu/ops/_common.py`` only in role (that file
switches Pallas between the TPU and interpret mode; there is no Hopper
analogue of interpret mode). Each ``csrc/<name>.cu`` is compiled on first
use by ``nvcc`` into its own shared library with a plain C interface,
``csrc/build/<name>-<hash>.so``, where the hash covers the source, the
shared headers and the flags, so an edit rebuilds it and an unchanged
tree reuses it. The library is loaded with ``ctypes``; callers declare
``argtypes`` (``c_void_p`` for pointers and the stream, ``c_int`` for
ints) through :func:`kernel`.

Several sources build at once: :func:`build_all` starts one ``nvcc`` per
source, or for a source of :data:`PARTS` one a part and then the link,
and waits for all of them (:data:`BUILD_SECONDS` holds each one's wall
seconds). Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable, List, Sequence, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = CSRC / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-shared", "-Xcompiler",
                           "-fPIC", "-Xptxas=-v"]

# sources compiled as several translation units at once, one nvcc each
# given -DBUILD_PART=<index> (the source keeps only that part's entries),
# then linked into the one library: the parts' names in index order
PARTS: Dict[str, Tuple[str, ...]] = {
    "paged_attention": ("update", "read", "verify", "quant_decode",
                        "quant_verify", "commit")}

_LIBS: Dict[str, ctypes.CDLL] = {}
# ptxas register/spill report of each build, by source name (a source of
# PARTS: its parts' reports in part order)
BUILD_LOGS: Dict[str, str] = {}
# wall seconds of each nvcc of a build: a whole source by its name, a part
# as "<name>.<part>", the link as "<name>.link" and a source of PARTS
# also by its name, from its first part's start to its link's end
BUILD_SECONDS: Dict[str, float] = {}


class KernelBuildError(RuntimeError):
    """nvcc refused a source; the message carries its stderr."""


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise KernelBuildError("nvcc not found (PATH, $CUDA_HOME/bin)")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for p in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    if name in PARTS:
        h.update(" ".join(list(PARTS[name]) + _compile_flags(0)
                          + _link_flags()).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _compile_flags(part: int) -> List[str]:
    """A part's flags: an object file, not a library, of BUILD_PART."""
    return [f for f in NVCC_FLAGS if f != "-shared"] + [
        "-c", f"-DBUILD_PART={part}"]


def _link_flags() -> List[str]:
    return ARCH_FLAGS + ["-shared"]


def _nvcc(label: str, args: List[str], name: str) -> str:
    """Run one nvcc to its end; its wall seconds go to BUILD_SECONDS
    under ``label``. Returns its output (ptxas's report)."""
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc_path()] + args, capture_output=True,
                          text=True)
    BUILD_SECONDS[label] = time.perf_counter() - t0
    if proc.returncode != 0:
        raise KernelBuildError(
            f"nvcc failed on csrc/{name}.cu ({label}, exit "
            f"{proc.returncode}):\n{proc.stderr}")
    return proc.stdout + proc.stderr


def _build_one(name: str, out: Path) -> None:
    """Build ``csrc/<name>.cu`` into ``out``: one nvcc, or for a source of
    PARTS one nvcc a part, all at once, then one that links them. The
    library is built under a private temp name and renamed, so a
    concurrent build never loads a half-written one."""
    t0 = time.perf_counter()
    src = str(CSRC / f"{name}.cu")
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    parts = PARTS.get(name, ())
    objs = [f"{tmp[:-3]}.{part}.o" for part in parts]
    try:
        if not parts:
            log = _nvcc(name, NVCC_FLAGS + ["-o", tmp, src], name)
        else:
            with ThreadPoolExecutor(len(parts)) as ex:
                futs = [ex.submit(_nvcc, f"{name}.{part}",
                                  _compile_flags(i) + ["-o", obj, src], name)
                        for i, (part, obj) in enumerate(zip(parts, objs))]
                log = "".join(f.result() for f in futs)
            _nvcc(f"{name}.link", _link_flags() + ["-o", tmp] + objs, name)
        BUILD_LOGS[name] = log
        os.replace(tmp, out)
    finally:
        for f in [tmp] + objs:
            Path(f).unlink(missing_ok=True)
        if parts:
            BUILD_SECONDS[name] = time.perf_counter() - t0


def build_all(names: Iterable[str]) -> List[Path]:
    """Build every named source that has no current library, every nvcc
    started together; returns the library paths."""
    names = list(names)
    paths = [_lib_path(n) for n in names]
    todo = [(n, p) for n, p in zip(names, paths) if not p.exists()]
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    errors = []
    with ThreadPoolExecutor(len(todo)) as ex:
        for fut in [ex.submit(_build_one, n, p) for n, p in todo]:
            try:
                fut.result()
            except KernelBuildError as e:
                errors.append(str(e))
    if errors:
        raise KernelBuildError("\n".join(errors))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        (path,) = build_all([name])
        lib = _LIBS[name] = ctypes.CDLL(str(path))
    return lib


def kernel(name: str, symbol: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """C entry ``symbol`` of ``csrc/<name>.cu`` with its argument types
    set; it returns the launch's ``cudaError_t`` as an int."""
    fn = getattr(load(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return fn


def check(name: str, err: int, what: str) -> None:
    """Raise if a launch from ``csrc/<name>.cu`` reported a CUDA error (a
    refused launch never runs, and a later synchronize would not say
    so). Every source exports ``<name>_error_string``."""
    if err != 0:
        fn = getattr(load(name), f"{name}_error_string")
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(f"{what}: CUDA launch failed: error {err} "
                           f"({fn(err).decode()})")
