"""Build ``csrc/*.cu`` into one shared library with ``nvcc`` and load it
with ``ctypes``.

The library has a plain C interface (no PyTorch headers), so a cold build
is one ``nvcc -c`` per source, all started together, and one link.  The
result goes to ``<repo>/build/torch_kernels/libglu_kernels.so`` (or
``$REPRO_TORCH_BUILD_DIR``) and is keyed by a hash of the sources and flags:
an unchanged tree reuses it, an edited source rebuilds it.  Nothing is
built at import time; the first kernel launch builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

from .. import tracing

__all__ = ["load_library", "build_dir", "nvcc_path", "check", "count_launch"]

CSRC = Path(__file__).resolve().parent / "csrc"
LIB_NAME = "libglu_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points and their argument types; every entry returns the
# cudaError_t of its launches as an int (0 = success)
_K1 = [_P, _P, _P, _P, _P, _P, _I, _I]            # vals, layout, n_levels, max_items
_K1_ROBUST = [_P] * 10 + [_I, _I]                   # + diag_ptr, diag, tau, count
_TILE = [_P, _P, _P, _I]                            # a, out, carry, N
_SIGNATURES = {
    **{f"glu_level_run_{t}": _K1 + [_P] for t in ("f32", "f64", "c64", "c128")},
    **{f"glu_level_run_batched_{t}": _K1 + [_I, _I, _P]        # batch, stride
       for t in ("f32", "f64", "c64", "c128")},
    **{f"glu_level_run_robust_{t}": _K1_ROBUST + [_P]
       for t in ("f32", "f64", "c64", "c128")},
    **{f"glu_level_run_robust_batched_{t}": _K1_ROBUST + [_I, _I, _P]
       for t in ("f32", "f64", "c64", "c128")},
    **{f"glu_dense_lu{k}_{t}": _TILE + [_P]
       for k in ("", "_planar") for t in ("f32", "f64")},
    **{f"glu_dense_lu{k}_batched_{t}": _TILE + [_I, _P]         # batch
       for k in ("", "_planar") for t in ("f32", "f64")},
}

_lock = threading.Lock()
_lib = None
# what the last build did, for reports: seconds and the compiler's output
# (``-Xptxas -v`` prints registers, shared memory and spills per kernel)
build_info: dict = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "torch_kernels"


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from csrc/ at first use")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(sources) -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.name.encode())
        h.update(hdr.read_bytes())
    return h.hexdigest()


def _build(out_dir: Path, digest: str) -> Path:
    """Compile and link in a private directory, then move the library and
    its hash stamp into place: processes that build at once never share an
    object file, and a reader sees either the old library or the new one."""
    nvcc = nvcc_path()
    out_dir.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=out_dir, prefix="build."))
    try:
        procs = []
        for src in _sources():
            obj = work / (src.stem + ".o")
            procs.append((src, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for src, _, p in procs:
            out, _ = p.communicate()
            logs.append(f"== {src.name}\n{out}")
            if p.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(logs))
        tmp = work / LIB_NAME
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        stamp = work / (LIB_NAME + ".hash")
        stamp.write_text(digest)
        lib_path = out_dir / LIB_NAME
        os.replace(tmp, lib_path)
        os.replace(stamp, out_dir / stamp.name)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    build_info.update(cached=False, log="\n".join(logs), path=str(lib_path))
    return lib_path


def load_library():
    """The loaded kernel library, building it first if the sources changed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        with tracing.span("kernels.load"):
            out_dir = build_dir()
            digest = _digest(_sources())
            lib_path = out_dir / LIB_NAME
            stamp = out_dir / (LIB_NAME + ".hash")
            if (lib_path.exists() and stamp.exists()
                    and stamp.read_text().strip() == digest):
                build_info.update(seconds=0.0, cached=True, log="",
                                  path=str(lib_path))
            else:
                with tracing.timed("kernels.build") as built:
                    lib_path = _build(out_dir, digest)
                build_info["seconds"] = built.seconds
            lib = ctypes.CDLL(str(lib_path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def count_launch(kernel) -> None:
    """Count one launch of ``kernel``'s CUDA kernel, where its wrapper
    launches it: in ``kernel.launches`` when it runs now, in
    ``kernel.captured`` when the launch is being recorded into a CUDA graph
    (each replay of that graph then adds it to ``launches``, see
    ``core.executor.CapturedSchedule``)."""
    if torch.cuda.is_current_stream_capturing():
        kernel.captured += 1
    else:
        kernel.launches += 1
