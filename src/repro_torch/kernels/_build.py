"""Build-at-first-use loader for the port's CUDA kernels.

The sources under ``csrc/`` are compiled with ``nvcc`` into one shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds, not minutes) and bound with :mod:`ctypes`.  Each source compiles
in its own ``nvcc`` process, all started together, and one more call links
the objects.  The library
lands in ``build/torch_ext/<hash of sources and flags>/`` at the root of
the checkout (listed in ``.gitignore``); a file lock keeps concurrent
processes from racing on one build.  Nothing is built when a module is
imported, and a failed build raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "torch_ext"
SOURCES = ("stencil2d.cu", "multistep.cu", "window_bf16.cu",
           "swa_attention.cu", "swa_wgmma.cu", "decode_attention.cu")
HEADERS = ("elementals.cuh", "fold.cuh", "dispatch.cuh", "window.cuh")
# --fmad=false: no multiply-add contraction, so the functors round exactly
# like the plain PyTorch bodies; no --use_fast_math (IEEE div and sqrtf).
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "--fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC")
LIB_NAME = "libkernels.so"


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the one on PATH,
    else ``/usr/local/cuda/bin/nvcc``."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(Path(on_path))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found; the CUDA kernels cannot be built")


def build_dir() -> Path:
    """``build/torch_ext/<hash>``: the hash covers every source and flag."""
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16]


def _run(cmds, log) -> None:
    """Run the commands in parallel; append each one's output to ``log``
    and raise if any failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    failed = []
    for cmd, proc in zip(cmds, procs):
        text = proc.communicate()[0]
        with open(log, "a") as fh:
            fh.write(" ".join(cmd) + "\n" + text)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)} ({proc.returncode}):\n"
                          f"{text[-4000:]}")
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))


def build() -> Path:
    """Compile the library if it is not there yet; return its path.  The
    compiler's output (``-Xptxas -v``: registers, spills) is kept in
    ``build.log`` beside it."""
    out_dir = build_dir()
    lib = out_dir / LIB_NAME
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if lib.is_file():
                return lib
            nvcc, pid = nvcc_path(), os.getpid()
            log = out_dir / "build.log"
            log.write_text("")
            objs = [out_dir / f"{Path(s).stem}.{pid}.o" for s in SOURCES]
            tmp = out_dir / f"{LIB_NAME}.{pid}.tmp"
            try:
                _run([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(CSRC / s)]
                      for s, o in zip(SOURCES, objs)], log)
                _run([[nvcc, "-shared", "-gencode",
                       "arch=compute_90a,code=sm_90a", "-o", str(tmp),
                       *map(str, objs)]], log)
                os.replace(tmp, lib)
            finally:
                tmp.unlink(missing_ok=True)
                for o in objs:
                    o.unlink(missing_ok=True)
            return lib
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build (once per checkout) and load the kernel library, with the
    argument types of its C entry points declared."""
    lib = ctypes.CDLL(str(build()))
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.stencil_sweep.argtypes = [
        i, i, i, vp, i,              # functor, radius, dtype, params, n
        vp, vp, vp, vp,              # in, out, env0, env1
        ll, i,                       # ld, lanes
        i, i, i, i, i,               # pad, mi, ni, m, n
        i, i, i,                     # tm, tn, ring
        i, i, i,                     # monoid, measure, do_reduce
        vp, vp, i,                   # live, partials, slots
        vp, vp, vp]                  # ticket, result, stream
    lib.stencil_sweep.restype = i
    lib.multistep_sweep.argtypes = [
        i, i, i, vp, i,              # functor, radius, dtype, params, n
        vp, vp, vp, vp,              # in, out, env0, env1
        ll, i,                       # ld, lanes
        i, i, i, i, i, i,            # k, T, mi, ni, m, n
        i, i, i,                     # tm, tn, ring
        i, i, i, i, i,               # row_lo, row_hi, col_lo, col_hi, bnd
        i, i,                        # monoid, measure
        vp, vp, i,                   # live, partials, slots
        vp, vp, vp]                  # ticket, result, stream
    lib.multistep_sweep.restype = i
    lib.swa_attention_fwd.argtypes = [
        i, i, vp, vp, vp, vp,        # dtype, head_dim, q, k, v, out
        i, i, i, i, i,               # bh, bkh, S, window, causal
        ctypes.c_float, ctypes.c_float, vp]   # scale, softcap, stream
    lib.swa_attention_fwd.restype = i
    lib.swa_attention_wgmma.argtypes = [
        i, vp, vp, vp, vp,           # head_dim, q, k, v, out
        i, i, i, i, i,               # bh, bkh, S, window, causal
        ctypes.c_float, ctypes.c_float, vp]   # scale, softcap, stream
    lib.swa_attention_wgmma.restype = i
    lib.decode_attention_bf16.argtypes = [
        vp, vp, vp, vp, vp,          # q, k, v, pos, out
        vp, vp,                      # part_o, part_ml
        i, i, i, i, i, i, i,         # B, H, KH, hd, T, splits, split_keys
        ll, ll, ll, ll,              # k_sb, k_st, v_sb, v_st
        i, ctypes.c_float, ctypes.c_float, vp]   # window, scale, softcap, stream
    lib.decode_attention_bf16.restype = i
    lib.swa_launch_info.argtypes = [vp]
    lib.swa_launch_info.restype = None
    lib.stencil_launch_info.argtypes = [vp]
    lib.stencil_launch_info.restype = None
    lib.stencil_error_string.argtypes = [i]
    lib.stencil_error_string.restype = ctypes.c_char_p
    return lib
