"""Build, load and count the port's hand-written CUDA kernels.

The kernels live in ``blaze_tpu_torch/csrc/*.cu`` behind a plain C
interface. At first use on a CUDA tensor they are compiled with ``nvcc``
for Hopper (``sm_90a``) into one shared library under a build directory
beside the package (``build_kernels/``, or ``$BLAZE_TORCH_KERNEL_DIR``),
keyed by a hash of the sources, and loaded with ``ctypes``. Each source
compiles in its own ``nvcc`` process, all started together, then one link.

Every kernel wrapper adds one to its entry of ``LAUNCHES`` where it
launches its kernel and nowhere else, so a run can show that it went
through the kernels (``reset_launch_counts`` / ``launch_counts``); K11,
the generated Triton kernel of a fused chain (exprs/fused_triton.py),
counts under ``fused_chain``.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Optional

import torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc")
SOURCES = ("compact.cu", "murmur3.cu", "slot_agg.cu", "sort.cu", "gather.cu",
           "join.cu", "seg_agg.cu", "slot_update.cu")
HEADERS = ("common.cuh",)
LIB_NAME = "libblaze_torch_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES: Dict[str, int] = {
    "compact_planes": 0,
    "murmur3_pmod": 0,
    "slot_agg_partial": 0,
    "slot_agg_merge": 0,
    "sort_key_operands": 0,
    "lexsort_indices": 0,
    "gather_planes": 0,
    "slice_planes": 0,
    "concat_planes": 0,
    "inner_join_planes": 0,
    "probe_codes": 0,
    "segment_ids": 0,
    "seg_agg_partial": 0,
    "seg_agg_merge": 0,
    "fused_chain": 0,
    "slot_update": 0,
}

_LIB: Optional[ctypes.CDLL] = None
_LIB_LOCK = threading.Lock()
BUILD_INFO: Dict[str, object] = {}


# csrc/common.cuh BLZ_THREADS: one thread per row (or slot), 1024 a block
THREADS = 1024


def blocks(n: int) -> int:
    return (n + THREADS - 1) // THREADS


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def build_dir() -> str:
    root = os.environ.get("BLAZE_TORCH_KERNEL_DIR")
    if root is None:
        root = os.path.join(os.path.dirname(os.path.dirname(CSRC)),
                            "build_kernels")
    return root


def _source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS + NVCC_FLAGS:
        h.update(name.encode())
        path = os.path.join(CSRC, name)
        if os.path.exists(path):
            with open(path, "rb") as f:
                h.update(f.read())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine "
                       "with the CUDA toolkit (CUDA_HOME or PATH)")


def build() -> str:
    """Compile the kernels if this source hash has no library yet; returns
    the library path. Records ``BUILD_INFO`` (seconds, ptxas report)."""
    out_dir = os.path.join(build_dir(), _source_hash())
    lib = os.path.join(out_dir, LIB_NAME)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(lib):
            BUILD_INFO.setdefault("seconds", 0.0)
            BUILD_INFO.setdefault("cached", True)
            return lib
        t0 = time.perf_counter()
        nvcc = _nvcc()
        procs = []
        for src in SOURCES:
            obj = os.path.join(out_dir, src.replace(".cu", ".o"))
            cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC, "-c",
                   os.path.join(CSRC, src), "-o", obj]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log = []
        failed = []
        for src, _obj, p in procs:
            out, _ = p.communicate()
            log.append(f"== {src}\n{out}")
            if p.returncode != 0:
                failed.append(src)
        report = "\n".join(log)
        with open(os.path.join(out_dir, "build.log"), "w") as f:
            f.write(report)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{report[-6000:]}")
        tmp = lib + f".tmp{os.getpid()}"
        link = subprocess.run(
            [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
             *[obj for _s, obj, _p in procs], "-o", tmp],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout[-6000:]}")
        os.replace(tmp, lib)
        BUILD_INFO.update(seconds=time.perf_counter() - t0, cached=False,
                          ptxas=report)
        return lib


_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_U32 = ctypes.c_uint32
_I32 = ctypes.c_int32
_PP = ctypes.POINTER(ctypes.c_void_p)
_PI = ctypes.POINTER(ctypes.c_int)
_PLL = ctypes.POINTER(ctypes.c_longlong)

_SIGNATURES = {
    # mask, n, nplanes, srcs, dsts, sizes, scratch, stream
    "blz_compact_planes": [_P, _I64, _I, _PP, _PP, _PI, _P, _P],
    # k, datas, valids, wide, n, seed, nparts, hash_out, pid_out, stream
    "blz_murmur3_pmod": [_I, _PP, _PP, _PI, _I64, _U32, _I32, _P, _P, _P],
    "blz_slot_agg": [
        _I, _PP, _PP, _PLL, _PLL, _PLL,      # k, keys, kvalids, bases, sizes, strides
        _I64, _I, _PI,                       # num_rows, nops, op_kind
        _PP, _PI, _PP, _PP, _PLL, _PLL,      # op_src, op_nvalid, op_valid, op_table, op_mult, op_init
        _I, _PI, _PP, _PP, _PP,              # nemit, emit_kind, emit_table, emit_aux, emit_out
        _I64, _P, _P, _P, _I64,              # S, present, offs, overflow, out_cap
        _PP, _PP, _P, _P, _P, _I, _I,        # key_out, kvalid_out, count_out, brows, bgroups, shift, nb
        _P,                                  # stream
    ],
    # k, datas, valids, sizes, kinds, asc, nulls_first, exists, n,
    # rank_out, val_out, stream
    "blz_sort_key_operands": [_I, _PP, _PP, _PI, _PI, _PI, _PI, _P, _I64,
                              _PP, _PP, _P],
    # nops, datas, sizes, kinds, n, andor, stream
    "blz_sort_bits": [_I, _PP, _PI, _PI, _I64, _P, _P],
    # nops, datas, sizes, kinds, n_sort, n_total, npasses, pass_op,
    # pass_shift, idx_a, idx_b, counts, out, stream
    "blz_radix_sort": [_I, _PP, _PI, _PI, _I64, _I64, _I, _PI, _PI, _P, _P,
                       _P, _P, _P],
    # idx, n_out, live, out_cap, nplanes, srcs, dsts, caps, sizes, stream
    "blz_gather_planes": [_P, _I64, _P, _I64, _I, _PP, _PP, _PLL, _PI, _P],
    # table, k, nplanes, out_cap, stream
    "blz_concat_planes": [_P, _I, _I, _I64, _P],
    # uniq, nk, num_rows, key, key_size, key_kind, key_valid, cap_p, cap_b,
    # nprobe, nplanes, srcs, dsts, sizes, codes, offs, stream
    "blz_inner_join": [_P, _I64, _I64, _P, _I, _I, _P, _I64, _I64, _I, _I,
                       _PP, _PP, _PI, _P, _P, _P],
    # uniq, nk, key, key_size, key_kind, key_valid, cap, codes, stream
    "blz_probe_codes": [_P, _I64, _P, _I, _I, _P, _I64, _P, _P],
    # k, datas, valids, sizes, is_float, order, n, cap, flags, offs,
    # starts, stream
    "blz_segment_starts": [_I, _PP, _PP, _PI, _PI, _P, _I64, _I64, _P, _P, _P,
                           _P],
    "blz_segment_reduce": [
        _P, _P, _P, _I64,                    # starts, order, count, cap
        _I, _PI, _PI, _PP, _PI, _PP,         # nops, kind, is_float, src, nvalid, valid
        _PLL, _PLL,                          # mult, init
        _I, _PI, _PI, _PI, _PP,              # nemit, kind, table, aux, out
        _P, _P,                              # first, stream
    ],
    "blz_slot_update": [
        _P, _P, _I64, _I64, _P, _I,          # slots, mask, n, cap, perm, nops
        _PI, _PI, _PP, _PI, _PP, _PP,        # kind, is_float, src, nvalid, valid, table
        _PI, _PP, _PI, _PP, _PP, _PP,        # esize, order, nwvalid, wvalid,
                                             # valid_table, order_table
        _P,                                  # stream
    ],
}


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build())
            for name, args in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            _LIB = lib
        return _LIB


def ptr_array(tensors_or_ptrs, ctype=ctypes.c_void_p):
    """ctypes array of device pointers (tensor data_ptr()s, ints or None)."""
    vals = []
    for t in tensors_or_ptrs:
        if t is None:
            vals.append(None)
        elif isinstance(t, torch.Tensor):
            vals.append(t.data_ptr())
        else:
            vals.append(int(t))
    arr = (ctype * max(1, len(vals)))(*vals)
    return ctypes.cast(arr, ctypes.POINTER(ctype)), arr


def int_array(values, ctype=ctypes.c_int):
    arr = (ctype * max(1, len(values)))(*[int(v) for v in values])
    return ctypes.cast(arr, ctypes.POINTER(ctype)), arr


def stream_of(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """A wrapper's input check: every tensor on one CUDA device and
    contiguous."""
    dev = None
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: tensor on {t.device}, expected CUDA")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: non-contiguous input")
