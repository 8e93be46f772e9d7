"""Whole-batch device kernels for the batch plumbing hot path.

``compact_planes`` (K1) is a hand-written CUDA kernel (csrc/compact.cu)
with a plain PyTorch twin: a tensor on the CPU takes the plain version,
a CUDA tensor launches the kernel or raises. The gathers, slices and
concatenation are plain PyTorch for now (ROADMAP.md Queue 2), as are the
slot-code and sort-key helpers the aggregation and top-k operators use.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from blaze_tpu_torch.core.batch import iota
from blaze_tpu_torch.utils import cuda_lib


def _zero_where(live: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.where(live, x, torch.zeros((), dtype=x.dtype, device=x.device))


def gather_planes(datas: Sequence[torch.Tensor], valids: Sequence[torch.Tensor],
                  idx: torch.Tensor, out_cap: int, n_out: int):
    """Gather rows ``idx`` (length n_out, each < the planes' length) of
    every (data, validity) plane into ``out_cap``-row planes; rows past
    n_out are padding (data 0, validity False). Plain PyTorch twin of
    blaze_tpu/core/kernels.py:_gather_n."""
    dev = idx.device
    full = torch.zeros(out_cap, dtype=torch.int64, device=dev)
    full[:n_out] = idx
    live = iota(out_cap, dev) < n_out
    out_d = [_zero_where(live, d[full.clamp(0, d.shape[0] - 1)]) for d in datas]
    out_v = [v[full.clamp(0, v.shape[0] - 1)] & live for v in valids]
    return out_d, out_v


def slice_planes(datas: Sequence[torch.Tensor], valids: Sequence[torch.Tensor],
                 offset: int, length: int, out_cap: int):
    """Contiguous row window [offset, offset + length) into ``out_cap``-row
    planes (blaze_tpu/core/kernels.py:_dyn_slice)."""
    dev = datas[0].device if datas else torch.device("cpu")
    idx = iota(out_cap, dev) + offset
    live = iota(out_cap, dev) < length
    out_d = [_zero_where(live, d[idx.clamp(0, d.shape[0] - 1)]) for d in datas]
    out_v = [v[idx.clamp(0, v.shape[0] - 1)] & live for v in valids]
    return out_d, out_v


def concat_planes(per_field_datas: List[List[torch.Tensor]],
                  per_field_valids: List[List[torch.Tensor]],
                  num_rows: Sequence[int], out_cap: int):
    """Field-wise concatenation of k batches' live rows into ``out_cap``-row
    planes (blaze_tpu/core/kernels.py:_concat_gather)."""
    total = int(sum(num_rows))

    def cat(parts):
        live = [p[:n] for p, n in zip(parts, num_rows)]
        out = torch.cat(live)
        return torch.nn.functional.pad(out, (0, out_cap - total))

    return ([cat(p) for p in per_field_datas],
            [cat(p) for p in per_field_valids])


# -- K1: stable compaction -----------------------------------------------------


def compact_planes_plain(datas: Sequence[torch.Tensor],
                         valids: Sequence[torch.Tensor], mask: torch.Tensor):
    """Plain PyTorch twin of K1, the same function as
    blaze_tpu/core/kernels.py:_compact: rows where ``mask`` holds move to
    the front in input order; padding past the count is data 0, validity
    False. Returns (count as a 0-d int64 tensor, datas, valids)."""
    count = mask.sum()
    order = torch.argsort((~mask).to(torch.uint8), stable=True)
    live = iota(mask.shape[0], mask.device) < count
    out_d = [_zero_where(live, d[order.clamp(0, d.shape[0] - 1)]) for d in datas]
    out_v = [v[order.clamp(0, v.shape[0] - 1)] & live for v in valids]
    return count, out_d, out_v


def compact_planes_cuda(datas: Sequence[torch.Tensor],
                        valids: Sequence[torch.Tensor], mask: torch.Tensor):
    """K1 on the card (csrc/compact.cu): same contract as
    :func:`compact_planes_plain`."""
    planes = list(datas) + list(valids)
    cuda_lib.require_cuda("compact_planes", mask, *planes)
    n = int(mask.shape[0])
    if mask.dtype != torch.bool:
        raise TypeError(f"compact_planes: mask dtype {mask.dtype}, expected bool")
    for p in planes:
        if p.shape != (n,):
            raise ValueError(f"compact_planes: plane shape {tuple(p.shape)}, "
                             f"expected ({n},)")
        if p.element_size() not in (1, 2, 4, 8):
            raise TypeError(f"compact_planes: element size {p.element_size()}")
    lib = cuda_lib.library()
    outs = [torch.empty_like(p) for p in planes]
    scratch = torch.empty(cuda_lib.blocks(n) + 1, dtype=torch.int64,
                          device=mask.device)
    srcs, _k1 = cuda_lib.ptr_array(planes)
    dsts, _k2 = cuda_lib.ptr_array(outs)
    sizes, _k3 = cuda_lib.int_array([p.element_size() for p in planes])
    err = lib.blz_compact_planes(mask.data_ptr(), n, len(planes), srcs, dsts,
                                 sizes, scratch.data_ptr(),
                                 cuda_lib.stream_of(mask.device))
    cuda_lib.check(err, "compact_planes")
    cuda_lib.LAUNCHES["compact_planes"] += 1
    k = len(datas)
    return scratch[-1], outs[:k], outs[k:]


def compact_planes(datas: Sequence[torch.Tensor], valids: Sequence[torch.Tensor],
                   mask: torch.Tensor):
    """Stable compaction of rows where ``mask`` holds (FilterExec hot path):
    K1 on a CUDA tensor, the plain version on a CPU tensor. Returns
    (count: int, datas, valids); the count is the one host sync."""
    fn = compact_planes_cuda if mask.is_cuda else compact_planes_plain
    count, out_d, out_v = fn(datas, valids, mask)
    return int(count), out_d, out_v


# -- slot codes (radix_pack) ---------------------------------------------------


def radix_strides(sizes: Sequence[int]) -> Tuple[int, ...]:
    """Row-major mixed-radix strides for per-key slot sizes (the LAST key
    varies fastest)."""
    strides = []
    acc = 1
    for s in reversed(sizes):
        strides.append(acc)
        acc *= s
    return tuple(reversed(strides))


def radix_bucket_shift(S: int, nbuck: int) -> Tuple[int, int]:
    """(shift, effective bucket count): a slot code's high bits select its
    radix bucket. S and nbuck are powers of two; nbuck clamps to S."""
    nb = min(nbuck, S)
    return (S // nb).bit_length() - 1, nb


def radix_pack(key_data, key_valid, exists, bases, sizes, strides):
    """Plain PyTorch twin of blaze_tpu/core/kernels.py:radix_pack: per key
    code 0 is the null slot and 1..size-1 map base..base+size-2; rows that
    do not exist go to the sentinel slot prod(sizes). Returns (seg int64,
    fits bool 0-d): fits turns False when an existing valid key fell
    outside its range (overflow-safe: wrapped differences are rejected)."""
    S = 1
    for s in sizes:
        S *= s
    seg = torch.zeros(exists.shape[0], dtype=torch.int64, device=exists.device)
    fits = torch.ones((), dtype=torch.bool, device=exists.device)
    for i, (d, v) in enumerate(zip(key_data, key_valid)):
        d64 = d.to(torch.int64)
        diff = d64 - bases[i]  # wrapping int64
        code = torch.where(v, diff + 1, torch.zeros_like(diff))
        infit = (d64 >= bases[i]) & (diff >= 0) & (diff < sizes[i] - 1)
        fits = fits & torch.where(exists & v, infit, True).all()
        seg = seg + code.clamp(0, sizes[i] - 1) * strides[i]
    return torch.where(exists, seg, torch.full_like(seg, S)), fits


# -- sort keys -----------------------------------------------------------------


def sort_key_operands(datas, valids, exists, spec):
    """Per key a (u8 rank, value) operand pair, direction-adjusted (plain
    PyTorch twin of blaze_tpu/core/kernels.py:_key_ops_traced):
      0 = null (nulls first)   1 = NaN under descending
      2 = valid                3 = NaN under ascending
      4 = null (nulls last)    6 = padding row (always last)
    """
    ops = []
    for (ascending, nulls_first), data, validity in zip(spec, datas, valids):
        validity = validity & exists
        if data.is_floating_point():
            nan = torch.isnan(data)
            val = _zero_where(~(nan | ~validity), data)
            if not ascending:
                val = -val
            rank = torch.where(nan, 3 if ascending else 1, 2)
        elif data.dtype == torch.bool:
            val = data.to(torch.uint8)
            if not ascending:
                val = 1 - val
            val = _zero_where(validity, val)
            rank = torch.full_like(val, 2)
        else:
            val = data if ascending else ~data
            val = _zero_where(validity, val)
            rank = torch.full(val.shape, 2, dtype=torch.uint8, device=val.device)
        rank = torch.where(validity, rank.to(torch.int64), 0 if nulls_first else 4)
        rank = torch.where(exists, rank, 6).to(torch.uint8)
        ops.append(rank)
        ops.append(val)
    return ops


def lexsort_indices(operands: List[torch.Tensor]) -> torch.Tensor:
    """Indices that sort rows lexicographically by ``operands`` (first
    operand most significant), ties in row order: successive stable sorts
    from the least significant operand."""
    n = operands[0].shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=operands[0].device)
    for op in reversed(operands):
        key = op[idx]
        if key.dtype == torch.uint8:
            key = key.to(torch.int16)
        order = torch.sort(key, stable=True).indices
        idx = idx[order]
    return idx
