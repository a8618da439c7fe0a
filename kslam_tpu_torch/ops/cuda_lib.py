"""The port's hand-written CUDA kernels as one shared library.

Every kslam_tpu_torch/csrc/*.cu (sw_forward.cu: the SW kernels; join.cu:
the join's three lookups; sam.cu: the SAM path's sam_cigar,
sam_cigar_long and sam_diff; both SW files include sw_group.cuh's group
wavefront) is compiled for sm_90a by its own nvcc process, all started
together, and the objects are linked into one shared
library with a plain C interface, loaded with ctypes.  The build runs at
first use, once per hash of the flags and the sources (the *.cuh
headers included), into csrc/build/<hash>/, which .gitignore lists.  A
failed build raises; without nvcc nothing here runs.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import subprocess

_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-lineinfo", "-Xptxas", "-v", "-Xcompiler", "-fPIC")
_LIB = None
BUILD_LOG = ""        # nvcc/ptxas output of the build this process made

_VP, _CI, _CLL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# argument types of the library's C entry points
_ENTRY_POINTS = {
    "kslam_sw_forward": [_VP] * 4 + [_CI] * 14 + [_VP],
    "kslam_sw_align": [_VP] * 4 + [_CI] * 14 + [_VP],
    "kslam_bucket_join": [_VP] * 3 + [_CLL] + [_VP] * 4 + [_CLL]
    + [_CI] * 4 + [_VP],
    "kslam_sector_join": [_VP] * 3 + [_CLL] + [_VP] * 4 + [_CLL]
    + [_CI] * 4 + [_VP],
    "kslam_window_join": [_VP, _CLL] + [_VP] * 6 + [_CLL] + [_CI] * 5
    + [_VP],
    "kslam_sam_cigar": [_VP, _VP, _CLL] + [_VP] * 3 + [_CLL, _CLL]
    + [_VP] * 3 + [_CLL] + [_CI] * 6 + [_VP] * 7 + [_CI] * 8 + [_VP],
    "kslam_sam_band": [_VP, _VP, _CLL] + [_VP] * 3 + [_CLL, _CLL]
    + [_VP] * 3 + [_CLL] + [_CI] * 6 + [_VP] * 7 + [_CI, _VP, _CI, _CI, _VP,
                                                     _VP, _CI, _VP, _CI, _VP],
    "kslam_sam_cigar_long": [_VP, _VP, _CLL] + [_VP] * 3 + [_CLL]
    + [_VP] * 3 + [_CLL] + [_CI] * 6 + [_VP] * 7 + [_CI] + [_VP] * 2
    + [_CI] * 4 + [_VP],
    "kslam_sam_diff": [_VP] * 4 + [_CLL] + [_VP] * 6 + [_CLL] + [_VP] * 2
    + [_CLL] + [_VP] * 3 + [_CLL, _VP, _CI, _VP, _VP, _CI] + [_VP] * 4
    + [_CI, _VP],
}


def _sources():
    """The kernel sources (*.cu) and the headers they include (*.cuh)."""
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")) +
                  glob.glob(os.path.join(_CSRC, "*.cuh")))


def _build_library() -> str:
    """Compiles and links the library unless this hash was built; returns
    its path."""
    global BUILD_LOG
    from torch.utils.cpp_extension import CUDA_HOME
    digest = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for path in _sources():
        digest.update(os.path.basename(path).encode())
        with open(path, "rb") as fh:
            digest.update(fh.read())
    out_dir = os.path.join(_CSRC, "build", digest.hexdigest()[:16])
    lib_path = os.path.join(out_dir, "libkslam_cuda.so")
    if os.path.exists(lib_path):
        return lib_path
    if not CUDA_HOME:
        raise RuntimeError("CUDA toolkit not found: the port's kernels "
                           "need nvcc to build")
    os.makedirs(out_dir, exist_ok=True)
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    tag = f"{os.getpid()}.tmp"
    cus = [p for p in _sources() if p.endswith(".cu")]
    objs = [os.path.join(out_dir, os.path.basename(p) + f".{tag}.o")
            for p in cus]
    procs = [subprocess.Popen([nvcc, *_NVCC_FLAGS, "-c", src, "-o", obj],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(cus, objs)]
    logs, failed = [], []
    for src, proc in zip(cus, procs):
        out, _ = proc.communicate()
        logs.append(f"nvcc {os.path.basename(src)}:\n{out}")
        if proc.returncode != 0:
            failed.append(f"{os.path.basename(src)} ({proc.returncode})")
    tmp = f"{lib_path}.{tag}"
    if not failed:
        res = subprocess.run([nvcc, *_NVCC_FLAGS[:2], "-shared", "-o", tmp,
                              *objs], capture_output=True, text=True)
        logs.append(f"nvcc -shared:\n{res.stdout}{res.stderr}")
        if res.returncode != 0:
            failed.append(f"the link ({res.returncode})")
    BUILD_LOG = "".join(logs)
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    if failed:
        raise RuntimeError(f"nvcc failed: {', '.join(failed)}:\n{BUILD_LOG}")
    os.replace(tmp, lib_path)
    return lib_path


def load_library():
    """The built kernel library (built at first use), its entry points'
    argument types set."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(_build_library())
        for name, args in _ENTRY_POINTS.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = _CI
        _LIB = lib
    return _LIB
