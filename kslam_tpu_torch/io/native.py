"""ctypes bindings to the native host runtime (libkslam_host.so).

Loads lazily and degrades gracefully: when the shared library cannot be
built or loaded, every accessor returns None and callers fall back to the
pure-Python implementations; BUILD_REPORT says which compiler built it,
or why nothing did.

The library is built once per process from the unchanged sources in the
repository's csrc/ (its Makefile, -fopenmp included) into
kslam_tpu_torch/csrc/build/host/, with the first of $CXX, g++ and c++
that builds it.  A file lock serialises concurrent builds (several test
workers or processes importing the package at once).
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess
import threading

_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "csrc")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "build", "host")

_lock = threading.Lock()
_lib = None
_tried = False
BUILD_REPORT = ""     # compiler that built the library, or why none did


def _configure(lib) -> None:
    i64, i32, u8p = ctypes.c_int64, ctypes.c_int32, \
        ctypes.POINTER(ctypes.c_uint8)
    lib.kslam_fastq_parse_chunk.restype = i64
    lib.kslam_fastq_parse_chunk.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(i64), i64, i32,
        u8p, u8p, ctypes.POINTER(i32), ctypes.c_char_p, i32]
    lib.kslam_fastq_write.restype = i32
    lib.kslam_fastq_write.argtypes = [
        ctypes.c_char_p, i64, i32, u8p, u8p, ctypes.POINTER(i32),
        ctypes.c_char_p, i32, i32]
    if hasattr(lib, "kslam_ref_sort_perm"):
        lib.kslam_ref_sort_perm.restype = None
        lib.kslam_ref_sort_perm.argtypes = [
            ctypes.POINTER(ctypes.c_uint32), i64, ctypes.POINTER(i32)]
    if hasattr(lib, "kslam_rescore_chains"):
        lib.kslam_rescore_chains.restype = None
        lib.kslam_rescore_chains.argtypes = [
            u8p, ctypes.POINTER(i32), ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(i32), ctypes.POINTER(i32), i64,
            ctypes.POINTER(ctypes.c_uint32)]
    if hasattr(lib, "kslam_ssw_cigar_batch"):
        i32p = ctypes.POINTER(i32)
        i64p = ctypes.POINTER(i64)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        lib.kslam_ssw_cigar_batch.restype = None
        lib.kslam_ssw_cigar_batch.argtypes = [
            u8p, i32p, i64,            # reads, read_len, stride
            u8p, i64p,                 # genome, entry_off
            i32p, i32p, i32p, u8p, i64,  # read_id, entry_id, rel_pos, rc, n
            i32, i32, i32, i32,        # match, mismatch, gap_open, gap_extend
            i32, i32,                  # score_filter, report_cigar
            i32p, i32p, i32p, i32p, i32p,  # score, rb, re, qb, qe
            u32p, i32p, i32]           # cigar_buf, cigar_len, max_ops


def host_compilers() -> list:
    """Compilers to try, in order: $CXX, then g++ and c++ on PATH."""
    out = []
    for cxx in (os.environ.get("CXX", ""), "g++", "c++"):
        if cxx and cxx not in out:
            out.append(cxx)
    return out


def build_host_library(build_dir: str, compilers) -> tuple:
    """`make -C csrc BUILD=build_dir CXX=<compiler>` with each compiler in
    turn until one builds the library (make's up-to-date check makes a
    rebuild of current sources a no-op).  The Makefile's CXXFLAGS, with
    -fopenmp, always apply: CXXFLAGS from the environment is not passed
    on.  Returns (library path or None, report)."""
    os.makedirs(build_dir, exist_ok=True)
    lib_path = os.path.join(build_dir, "libkslam_host.so")
    env = {k: v for k, v in os.environ.items()
           if k not in ("CXXFLAGS", "MAKEFLAGS", "MFLAGS")}
    failures = []
    with open(os.path.join(build_dir, "build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        for cxx in compilers:
            before = (os.path.getmtime(lib_path)
                      if os.path.exists(lib_path) else None)
            try:
                res = subprocess.run(
                    ["make", "-C", _CSRC, f"BUILD={build_dir}", f"CXX={cxx}"],
                    capture_output=True, text=True, timeout=300, env=env)
            except (OSError, subprocess.SubprocessError) as exc:
                failures.append(f"{cxx}: {exc}")
                continue
            if res.returncode == 0 and os.path.exists(lib_path):
                if os.path.getmtime(lib_path) != before:
                    with open(lib_path + ".cxx", "w") as fh:
                        fh.write(f"{cxx} ({shutil.which(cxx) or cxx})")
                try:
                    with open(lib_path + ".cxx") as fh:
                        return lib_path, f"built with {fh.read()}"
                except OSError:
                    return lib_path, "built earlier (compiler not recorded)"
            lines = [line for line in res.stderr.splitlines()
                     if line.strip() and "***" not in line]
            failures.append(f"{cxx}: " + (" | ".join(lines[-2:]) or
                                          f"make exited {res.returncode}"))
    return None, "no compiler built it: " + "; ".join(failures)


def get_lib():
    """The loaded native library, or None when unavailable (the reason is
    in BUILD_REPORT)."""
    global _lib, _tried, BUILD_REPORT
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path, BUILD_REPORT = build_host_library(_BUILD_DIR, host_compilers())
        if path is None:
            return None
        try:
            _lib = ctypes.CDLL(path)
            _configure(_lib)
        except OSError as exc:
            BUILD_REPORT += f"; loading it failed: {exc}"
            _lib = None
        return _lib


def available() -> bool:
    return get_lib() is not None


def ssw_cigar_batch(reads, read_lengths, genome, entry_offsets,
                    read_id, entry_id, rel_pos, rc, sw_params,
                    score_filter=0, report_cigar=True, max_ops=None):
    """Batched native SSW + banded traceback (csrc/ssw_batch.cc), exactly
    mirroring golden.ssw.slam_overlap_align per overlap.

    reads: uint8 [n_reads, stride] ASCII (padded); genome: uint8 ASCII
    concat; entry_offsets: int64 [n_entries+1].  Returns a dict of arrays
    {score, ref_begin, ref_end, query_begin, query_end, cigar_buf,
    cigar_len} or None when the native library is unavailable.  cigar_buf
    rows hold (len<<4|op) runs, op 0=M 1=I 2=D; cigar_len -1 marks the
    reference's banded-overflow abort (score zeroed, ssw.c:941-944), -2
    marks cigar-not-computed."""
    import numpy as np
    lib = get_lib()
    if lib is None or not hasattr(lib, "kslam_ssw_cigar_batch"):
        return None
    reads = np.ascontiguousarray(reads, dtype=np.uint8)
    read_lengths = np.ascontiguousarray(read_lengths, dtype=np.int32)
    genome = np.ascontiguousarray(genome, dtype=np.uint8)
    entry_offsets = np.ascontiguousarray(entry_offsets, dtype=np.int64)
    read_id = np.ascontiguousarray(read_id, dtype=np.int32)
    entry_id = np.ascontiguousarray(entry_id, dtype=np.int32)
    rel_pos = np.ascontiguousarray(rel_pos, dtype=np.int32)
    rc = np.ascontiguousarray(rc, dtype=np.uint8)
    n = len(read_id)
    if max_ops is None:
        max_l = int(read_lengths.max()) if len(read_lengths) else 0
        max_ops = 2 * max_l + 8
    i32, i64 = ctypes.c_int32, ctypes.c_int64
    i32p = ctypes.POINTER(i32)
    out = {k: np.zeros(n, np.int32) for k in
           ("score", "ref_begin", "ref_end", "query_begin", "query_end")}
    cigar_buf = np.zeros((n, max_ops) if report_cigar else (1, 1), np.uint32)
    cigar_len = np.full(n, -2, np.int32)
    p = lambda a, t: a.ctypes.data_as(ctypes.POINTER(t))
    lib.kslam_ssw_cigar_batch(
        p(reads, ctypes.c_uint8), p(read_lengths, i32),
        i64(reads.shape[1]),
        p(genome, ctypes.c_uint8), p(entry_offsets, i64),
        p(read_id, i32), p(entry_id, i32), p(rel_pos, i32),
        p(rc, ctypes.c_uint8), i64(n),
        i32(sw_params.match), i32(sw_params.mismatch),
        i32(sw_params.gap_open), i32(sw_params.gap_extend),
        i32(score_filter), i32(1 if report_cigar else 0),
        p(out["score"], i32), p(out["ref_begin"], i32),
        p(out["ref_end"], i32), p(out["query_begin"], i32),
        p(out["query_end"], i32),
        p(cigar_buf, ctypes.c_uint32), cigar_len.ctypes.data_as(i32p),
        i32(max_ops if report_cigar else 1))
    out["cigar_buf"] = cigar_buf
    out["cigar_len"] = cigar_len
    return out


def unpack_cigar(row, nops):
    """One cigar_buf row -> [(length, 'M'|'I'|'D'), ...] (None when nops<0)."""
    if nops < 0:
        return None
    return [(int(v) >> 4, "MID"[int(v) & 0xF]) for v in row[:nops]]


def rescore_chains(valid, cseg, score_u32, rs, re):
    """Exact C++-double pseudo-assembly chain rescoring over SORTED-order
    columns (csrc/rescore.cc), or None when the library is unavailable
    (callers fall back to the equivalent pure-Python walk)."""
    import numpy as np
    lib = get_lib()
    if lib is None or not hasattr(lib, "kslam_rescore_chains"):
        return None
    n = len(valid)
    valid = np.ascontiguousarray(valid, dtype=np.uint8)
    cseg = np.ascontiguousarray(cseg, dtype=np.int32)
    score_u32 = np.ascontiguousarray(score_u32, dtype=np.uint32)
    rs = np.ascontiguousarray(rs, dtype=np.int32)
    re = np.ascontiguousarray(re, dtype=np.int32)
    out = np.empty(n, dtype=np.uint32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.kslam_rescore_chains(
        valid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        cseg.ctypes.data_as(i32p), score_u32.ctypes.data_as(u32p),
        rs.ctypes.data_as(i32p), re.ctypes.data_as(i32p),
        ctypes.c_int64(n), out.ctypes.data_as(u32p))
    return out


def ref_sort_perm(keys):
    """Permutation of `keys` (uint32 array) under the reference's
    __gnu_parallel::sort with force_parallel settings (see csrc/ref_sort.cc),
    or None when the native library is unavailable."""
    import numpy as np
    lib = get_lib()
    if lib is None or not hasattr(lib, "kslam_ref_sort_perm"):
        return None
    keys = np.ascontiguousarray(keys, dtype=np.uint32)
    out = np.empty(len(keys), dtype=np.int32)
    lib.kslam_ref_sort_perm(
        keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        ctypes.c_int64(len(keys)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out
