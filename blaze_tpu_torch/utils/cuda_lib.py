"""Build, load and count the port's hand-written CUDA kernels.

The kernels live in ``blaze_tpu_torch/csrc/*.cu`` behind a plain C
interface. At first use on a CUDA tensor they are compiled with ``nvcc``
for Hopper (``sm_90a``) into one shared library under a build directory
beside the package (``build_kernels/``, or ``$BLAZE_TORCH_KERNEL_DIR``),
keyed by a hash of the sources, and loaded with ``ctypes``. Each source
compiles in its own ``nvcc`` process, all started together, then one link.

Every kernel wrapper adds one to its entry of ``LAUNCHES`` where it
launches its kernel and nowhere else, so a run can show that it went
through the kernels (``reset_launch_counts`` / ``launch_counts``); K7's
split form (the exchange's bucketize) counts under ``split_planes``; K11,
the generated Triton kernel of a fused chain (exprs/fused_triton.py),
counts under ``fused_chain``; K13, the window aggregates' segmented scan,
under ``segment_scan``; K14, the range exchange's partition ids, under
``range_partition``; K15, the xxhash64 row hash, under ``xxhash64``;
K16, the bloom filter's probe, under ``bloom_probe``; K17, the device
mesh's all-to-all (csrc/mesh.cu), under ``mesh_all_to_all``; the stacked
form of K11 (several same-shape batches a launch) under
``fused_chain_stacked``; K18, a fused partial aggregate's generated
input kernel (exprs/fused_triton.py), under ``fused_agg_input``; K19, the
passthrough of a skipped partial aggregate (csrc/passthrough.cu), under
``passthrough_states``. Beside them
``LIMB_LAUNCHES`` counts, per kernel, the launches that carried each
wide-decimal (limb) op: the aggregate kinds sum2/avg2/sum3/avg3/minw/maxw
of K3, K4 and K10, and K12's limb update ops (``limb_launch_counts``).
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
           "join.cu", "seg_agg.cu", "slot_update.cu", "seg_scan.cu", "range_part.cu",
           "xxhash64.cu", "bloom.cu", "mesh.cu", "passthrough.cu")
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
    "split_planes": 0,
    "inner_join_planes": 0,
    "probe_codes": 0,
    "segment_ids": 0,
    "seg_agg_partial": 0,
    "seg_agg_merge": 0,
    "fused_chain": 0,
    "slot_update": 0,
    "segment_scan": 0,
    "range_partition": 0,
    "xxhash64": 0,
    "bloom_probe": 0,
    "mesh_all_to_all": 0,
    "fused_chain_stacked": 0,
    "fused_agg_input": 0,
    "passthrough_states": 0,
}

LIMB_LAUNCHES: Dict[str, int] = {}

_LIB: Optional[ctypes.CDLL] = None
_LIB_LOCK = threading.Lock()
BUILD_INFO: Dict[str, object] = {}


# csrc/common.cuh BLZ_THREADS: one thread per row (or slot), 1024 a block
THREADS = 1024


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    LIMB_LAUNCHES.clear()


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def limb_keys(name: str, ops) -> list:
    """The counts one launch of kernel ``name`` carrying the limb ops
    ``ops`` adds one to: ``"name:op"`` for each distinct op, and
    ``"name:limbs"``."""
    return [f"{name}:{op}" for op in set(ops)] + ([f"{name}:limbs"] if ops else [])


def count_limb_launch(name: str, ops, keys=None) -> None:
    """One launch of kernel ``name`` carrying the limb ops ``ops`` (or the
    ``limb_keys`` made for them before)."""
    for key in limb_keys(name, ops) if keys is None else keys:
        LIMB_LAUNCHES[key] = LIMB_LAUNCHES.get(key, 0) + 1


def limb_launch_counts() -> Dict[str, int]:
    return dict(LIMB_LAUNCHES)


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
_D = ctypes.c_double

_SIGNATURES = {
    # the argument words (csrc/compact.cu blz_compact_planes; core/kernels.py _CW_*)
    "blz_compact_planes": [_PLL],
    # the argument words (csrc/murmur3.cu; exprs/spark_hash.py _HW_*)
    "blz_murmur3_pmod": [_PLL],
    "blz_slot_agg": [
        _I, _PP, _PP, _PI, _PLL, _PLL, _PLL,  # k, keys, kvalids, key_size, bases, sizes,
                                             # strides
        _I64, _P, _I, _PI,                   # num_rows, exists, nops, op_kind
        _PP, _PP, _PI, _PP, _PLL, _PLL,      # op_src, op_src0, op_nvalid, op_valid,
                                             # op_mult, op_init
        _I, _PI, _PI, _PI, _PI, _PI, _PP,    # nemit, emit_kind, emit_table, emit_aux,
                                             # emit_aux2, emit_size, emit_out
        _I64, _I64,                          # S, out_cap
        _PP, _PI, _PP, _P, _P, _I, _I,       # key_out, out_ksize, kvalid_out, valid_out,
                                             # meta, shift, nb
        _P, _I64, _P,                        # scratch, scratch_words, stream
    ],
    # S, nops, num_rows, nb -> int64 words
    "blz_slot_agg_scratch": [_I64, _I, _I64, _I],
    # k, datas, valids, sizes, kinds, asc, nulls_first, exists, n,
    # rank_out, val_out, stream
    "blz_sort_key_operands": [_I, _PP, _PP, _PI, _PI, _PI, _PI, _P, _I64,
                              _PP, _PP, _P],
    # the argument words (csrc/sort.cu blz_radix_sort), stream
    "blz_radix_sort": [_PLL, _P],
    # n_sort, n_total, ndigits -> scratch bytes
    "blz_radix_sort_scratch": [_I64, _I64, _I],
    # the argument words (csrc/gather.cu blz_gather_planes)
    "blz_gather_planes": [_PLL],
    # the argument words (csrc/gather.cu), the staged table or null, stream
    "blz_concat_planes": [_PLL, _P, _P],
    "blz_split_planes": [_PLL, _P, _P],
    # the argument words (csrc/join.cu blz_inner_join; core/kernels.py _JW_*)
    "blz_inner_join": [_PLL],
    # uniq, nk, key, key_size, key_kind, key_valid, cap, codes, stream
    "blz_probe_codes": [_P, _I64, _P, _I, _I, _P, _I64, _P, _P],
    # the argument words (csrc/seg_agg.cu blz_segment_keys; core/kernels.py _SW_*)
    "blz_segment_keys": [_PLL],
    "blz_segment_reduce": [
        _P, _P, _P, _I64,                    # starts, order, count, cap
        _I, _PI, _PI, _PP, _PP, _PI, _PP,    # nops, kind, is_float, src, src0, nvalid,
                                             # valid
        _PLL, _PLL,                          # mult, init
        _I, _PI, _PI, _PI, _PI, _PP,         # nemit, kind, table, aux, aux2, out
        _P, _P, _I64, _P,                    # first, scratch, scratch_words, stream
    ],
    # cap, nops -> int64 words
    "blz_segment_reduce_scratch": [_I64, _I],
    # the argument words (csrc/slot_update.cu BLZ_UPD_W_* / BLZ_UPD_O_*)
    "blz_slot_update": [_PLL],
    # data, kind, validity, exists, seg_start, n, carry_f, carry_i, carry_c,
    # rows, levels, out_s, out_c, stream
    "blz_segment_scan": [_P, _I, _P, _P, _P, _I64, _D, _I64, _I64, _P, _P, _P, _P, _P],
    # the argument words (csrc/range_part.cu; core/kernels.py _RW_*)
    "blz_range_partition_ids": [_PLL],
    # the argument words (csrc/xxhash64.cu; exprs/spark_hash.py _XW_*)
    "blz_xxhash64": [_PLL],
    # values, n, words, k, bit_size, out, stream
    "blz_bloom_probe": [_P, _I64, _P, _I, _I64, _P, _P],
    # the argument words (csrc/mesh.cu; core/kernels.py _MW_*)
    "blz_mesh_all_to_all": [_PLL],
    # the argument words (csrc/passthrough.cu BLZ_PASS_W_*)
    "blz_passthrough": [_PLL],
}


# the exports that return a size, not a cudaError_t
_RESTYPES = {"blz_slot_agg_scratch": _I64, "blz_segment_reduce_scratch": _I64,
             "blz_radix_sort_scratch": _I64}


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set every export's argument and result types on ``lib``."""
    for name, args in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = _RESTYPES.get(name, ctypes.c_int)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            _LIB = bind(ctypes.CDLL(build()))
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


def stream_handle(index: int) -> int:
    """The handle of the current CUDA stream of device ``index``, as an
    int: PyTorch's raw accessor (the one Triton launches with) where it has
    one; building a ``torch.cuda.Stream`` object for it costs tens of
    microseconds of host time a call on the card's machine."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(index)
    return torch.cuda.current_stream(index).cuda_stream


def stream_of(device: torch.device) -> ctypes.c_void_p:
    index = device.index if device.index is not None else torch.cuda.current_device()
    return ctypes.c_void_p(stream_handle(index))


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """A wrapper's input check: every tensor on one CUDA device and
    contiguous (by ``is_cuda`` and the device index: reading ``.device``
    builds an object a tensor)."""
    index = None
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{name}: tensor on {t.device}, expected CUDA")
        i = t.get_device()
        if index is None:
            index = i
        elif i != index:
            raise ValueError(f"{name}: tensors on cuda:{index} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: non-contiguous input")
