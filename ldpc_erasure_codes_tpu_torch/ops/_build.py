"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/*.cu`` source compiles in its own ``nvcc`` process, all
started together, and one more ``nvcc`` links the objects into one shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds). The library's file name carries a hash of the sources and flags,
so an edited source is never served by a stale build. The build runs at the
first launch of a kernel, never at import: hosts without ``nvcc`` (CPU-only
test runs) import every module and run the plain versions.

Each launcher returns ``cudaGetLastError()`` as an int, which the wrappers
turn into an exception.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

# Shared memory a block may use on the H100 (232,448 bytes): the kernels'
# slabs and staged tables are sized against it.
SMEM_LIMIT = 232448


def round16(nbytes: int) -> int:
    """``nbytes`` rounded up to 16, as the kernels align their shared arrays."""
    return -(-nbytes // 16) * 16


_P = ctypes.c_void_p
_I = ctypes.c_int
# name -> argtypes; every pointer and the stream are c_void_p (a plain int
# would be cut to 32 bits).
LAUNCHERS = {
    # src, enc_src_idx, enc_par_idx, enc_src_val, enc_par_val, enc_diag_inv,
    # out, B, k, m, W, dmax, pmax, nb, stream
    "ldpc_encode_launch": [*[_P] * 7, *[_I] * 7, _P],
    # src, order, lvl_off, sidx, scoef, pidx, pcoef, plen, out, B, k, m, ds,
    # dp, L, W, wc, compute, nb, stream
    "ldpc_encode_slab_launch": [*[_P] * 9, *[_I] * 10, _P],
    # order, values, erased, vlist_idx, vlist_len, vlist_val, vlist_inv_val,
    # clist_idx, clist_len, check_groups, ngroups, values_out, erased_out,
    # iters_out, seq, res, lvl_off, nlev, B, n, m, dmax, nc, cmax, W, k_stop,
    # max_iters, wc, nb, stream
    "ldpc_peel_launch": [_I, *[_P] * 9, _I, *[_P] * 7, *[_I] * 11, _P],
    # order, erased, vlist_idx, vlist_len, clist_idx, clist_len,
    # check_groups, ngroups, seq, res, lvl_off, nlev, erased_out, iters_out,
    # B, n, m, dmax, nc, cmax, k_stop, max_iters, stream
    "ldpc_peel_schedule_launch": [_I, *[_P] * 6, _I, *[_P] * 6, *[_I] * 8, _P],
    # in, out, nreal, ncols, pivrow, failed, B, m, C, emax, a_words,
    # in_smem, stream
    "ldpc_elim_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # m, C
    "ldpc_elim_fits_smem": [_I, _I],
    # in, out, nreal, ncols, pivrow, failed, log_table, exp_table, B, m, C,
    # emax, a_words, in_smem, stream
    "ldpc_gf256_elim_launch": [*[_P] * 8, *[_I] * 6, _P],
    # m, C
    "ldpc_gf256_elim_fits_smem": [_I, _I],
    # values, idx, coef, out, B, n, m, d, W, stream
    "ldpc_gf_matvec_launch": [*[_P] * 4, *[_I] * 5, _P],
    # values, cols, ncols, offs, out, B, n, m, W, T, C, rows, stream
    "ldpc_gf_matvec_tiled_launch": [*[_P] * 5, *[_I] * 7, _P],
    # values, rhs, mats, idx, out, B, m, E, W, n, R, copy, stream
    "ldpc_gf_apply_launch": [*[_P] * 5, *[_I] * 7, _P],
    # rhs, mats, out, B, m, E, W, R, stream
    "ldpc_gf_matmul_launch": [*[_P] * 3, *[_I] * 5, _P],
    # erased, clist_idx, clist_len, scratch, failed, B, n, m, cmax, emax,
    # route, stream
    "ldpc_rank_launch": [*[_P] * 5, *[_I] * 6, _P],
    # route, n, m, emax
    "ldpc_rank_fits": [_I, _I, _I, _I],
    # m, emax
    "ldpc_rank_scratch_words": [_I, _I],
    # erased, vlist_idx, vlist_len, er_idx, nreal, cube, B, n, m, dmax, emax,
    # stream
    "ldpc_cube_launch": [*[_P] * 6, *[_I] * 5, _P],
    # erased, vlist_idx, vlist_len, clist_idx, clist_len, scratch,
    # erased_out, iters_out, B, n, m, dmax, cmax, k_stop, max_iters, stats,
    # k_count, rs_n, rs_k, stream
    "ldpc_peel_mask_launch": [*[_P] * 8, *[_I] * 7, _P, *[_I] * 3, _P],
    # values, out, mask, B, n, W, seed, num, stream
    "ldpc_channel_launch": [*[_P] * 3, *[_I] * 5, _P],
    # values, vlist_idx, vlist_len, out, B, n, m, dmax, W, stream
    "ldpc_synd_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # values, h_words, out, B, n, KW, m, W, stream
    "ldpc_f2_matvec_launch": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    # values, idx, len, out, B, K, m, d, W, wc, stream
    "ldpc_f2_matvec_rows_launch": [*[_P] * 4, *[_I] * 6, _P],
    # rhs, t_words, out, B, K, KW, E, W, stream
    "ldpc_f2_matmul_launch": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    # rhs, t_words, out, B, K, KW, E, W, wc, stream
    "ldpc_f2_matmul_rows_launch": [*[_P] * 3, *[_I] * 6, _P],
    # values, rhs, t_words, idx, out, B, K, KW, E, W, n, wc, stream
    "ldpc_f2_apply_rows_launch": [*[_P] * 5, *[_I] * 7, _P],
}


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu*"))):
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    return os.path.join(BUILD_DIR, f"libldpc_kernels-{h.hexdigest()[:16]}.so")


def build() -> tuple[str, float]:
    """Compile the library unless it exists; returns (path, build seconds)."""
    path = library_path()
    if os.path.exists(path):
        return path, 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{path[: -len('.so')]}.{os.getpid()}"
    nvcc = nvcc_path()
    objs = [f"{tag}.{os.path.basename(src)}.o" for src in sources()]
    compiles = [
        [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src] for src, obj in zip(sources(), objs)
    ]
    link = [nvcc, *LINK_FLAGS, "-o", f"{tag}.tmp", *objs]
    t0 = time.perf_counter()
    logs, procs, rcs = [], [], []
    try:
        for cmd in compiles:
            procs.append(subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ))
        for cmd, proc in zip(compiles, procs):
            out, _ = proc.communicate(timeout=900)
            logs.append(f"$ {' '.join(cmd)}\n{out}")
            rcs.append(proc.returncode)
        if not any(rcs):
            proc = subprocess.run(link, capture_output=True, text=True, timeout=900)
            logs.append(f"$ {' '.join(link)}\n{proc.stdout}{proc.stderr}")
            rcs.append(proc.returncode)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    seconds = time.perf_counter() - t0
    log = "".join(logs)
    with open(path[: -len(".so")] + ".log", "w") as f:
        f.write(log)
    if any(rcs):
        raise RuntimeError(f"nvcc failed ({rcs}):\n{log}")
    os.replace(f"{tag}.tmp", path)
    return path, seconds


@functools.cache
def library() -> ctypes.CDLL:
    """The built kernel library, with argtypes set on every launcher."""
    path, _ = build()
    lib = ctypes.CDLL(path)
    for name, argtypes in LAUNCHERS.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.ldpc_error_string.argtypes = [ctypes.c_int]
    lib.ldpc_error_string.restype = ctypes.c_char_p
    return lib


def check(rc: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if rc != 0:
        msg = library().ldpc_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} at launch: {msg}")
