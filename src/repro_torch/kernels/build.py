"""Build-at-first-use for the port's CUDA kernels, and their launch counts.

Each ``kernels/csrc/<name>.cu`` exposes a plain C interface and is compiled
by ``nvcc`` into its own shared library, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o _build/lib<name>-<hash>.so csrc/<name>.cu

No PyTorch headers are included (a build takes seconds, not minutes) and
``--use_fast_math`` is deliberately absent: the codec's codes must match
the reference bit for bit, and the attention softmax uses IEEE ``expf``.
Libraries are keyed by a hash of their source and the shared headers
(``csrc/*.cuh``), so an edited kernel is rebuilt and a stale one is never
loaded. The build directory
(``kernels/_build``) is listed in ``.gitignore``.

Every C entry point returns ``cudaGetLastError()`` after its launch;
``check`` raises on a non-zero code, so a refused launch (too much shared
memory, a bad configuration) never passes silently.

``SOURCES`` names every source of ``csrc/`` (``chip_smoke.py`` builds
them all at once, one ``nvcc`` each); ``LAUNCHES`` counts kernel launches
per kernel name: each wrapper adds one where it launches its kernel and
nowhere else, so a run can show that the main path went through the
kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-shared", "-Xcompiler",
                           "-fPIC")

# every csrc/<name>.cu, in the order chip_smoke.py reports their builds
SOURCES = ("pow2_rows", "paged_attention", "pow2_fq", "ttm_pe", "ttm_pe1",
           "ttm_pe2", "ttm_pe3", "blockwise", "pow2_packed", "pow2_scalar",
           "kv_append", "kv_read", "kv_prefill")

# kernel name -> launches since the last reset_launches()
LAUNCHES: dict[str, int] = {}

_LIBS: dict[str, ctypes.CDLL] = {}


def note_launch(name: str) -> None:
    LAUNCHES[name] = LAUNCHES.get(name, 0) + 1


def reset_launches() -> None:
    LAUNCHES.clear()


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    cands = ([str(Path(home) / "bin" / "nvcc")] if home else []) + \
        [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and Path(c).is_file():
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, keyed by its source, the shared
    headers (``csrc/*.cuh``) and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _command(name: str, out: Path, verbose: bool) -> list[str]:
    cmd = [nvcc(), *NVCC_FLAGS]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    return cmd + ["-o", str(out), str(CSRC / f"{name}.cu")]


def build(names: list[str], verbose: bool = False) -> dict[str, str]:
    """Compile every named source that has no up-to-date library, one
    ``nvcc`` process per source, all started together. Returns each
    compiler's combined output (``-Xptxas -v`` register/spill report when
    ``verbose``). Raises ``RuntimeError`` naming every source that failed."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists() and not verbose:
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            _command(name, tmp, verbose), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = _LIBS[name] = ctypes.CDLL(str(path))
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point of
    ``lib`` (every source exports ``error_string`` for the message)."""
    if code != 0:
        lib.error_string.restype = ctypes.c_char_p
        lib.error_string.argtypes = [ctypes.c_int]
        msg = lib.error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} at launch ({msg})")
