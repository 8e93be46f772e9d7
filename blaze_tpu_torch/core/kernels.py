"""Whole-batch device kernels for the batch plumbing hot path.

Each is a hand-written CUDA kernel with a plain PyTorch twin in this
module: a tensor on the CPU takes the plain version, a CUDA tensor
launches the kernel or raises.

- K1 ``compact_planes`` (csrc/compact.cu): FilterExec's stable compaction.
- K5 ``sort_key_operands`` + ``lexsort_indices`` (csrc/sort.cu): the sort
  keys' (rank, value) operands and a stable LSD radix sort over them.
- K6 ``gather_planes`` (csrc/gather.cu): ``ColumnarBatch.take``.
- K7 ``slice_planes`` / ``concat_planes`` (csrc/gather.cu):
  ``ColumnarBatch.slice`` and ``.concat``.
- K8 ``inner_join_planes`` (csrc/join.cu): the unique-key inner
  broadcast join of one probe batch (probe, stable compaction, gathers
  of both sides), with ``canon_words``, the join key's canonical word.
- K9 ``probe_codes`` (csrc/join.cu): the generic join probe, each probe
  key's code in the build map or -1.
- K11 ``fused_chain`` (exprs/fused_triton.py, generated Triton): one
  fused chain segment of project / filter / rename / expand steps over a
  batch, then K1 once per filtered output group.

The slot-code helpers of the aggregation are plain PyTorch twins of the
JAX package's (the slot kernels K3/K4 are in ops/agg_device.py), and the
window counters are host numpy, as they are in the JAX package.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from blaze_tpu_torch.core.batch import iota
from blaze_tpu_torch.utils import cuda_lib


def _zero_where(live: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.where(live, x, torch.zeros((), dtype=x.dtype, device=x.device))


# -- K6: gather ------------------------------------------------------------------


def gather_planes_plain(datas: Sequence[torch.Tensor],
                        valids: Sequence[torch.Tensor], idx: torch.Tensor,
                        out_cap: int, n_out: int,
                        live: Optional[torch.Tensor] = None):
    """Gather rows ``idx`` (length n_out, each < the planes' length) of
    every (data, validity) plane into ``out_cap``-row planes; rows past
    n_out, and rows where the optional ``live`` mask (length n_out) is
    False, are padding (data 0, validity False). Plain PyTorch twin of
    K6, the same function as blaze_tpu/core/kernels.py:_gather_n (and,
    with ``live``, ``_gather``)."""
    dev = idx.device
    full = torch.zeros(out_cap, dtype=torch.int64, device=dev)
    full[:n_out] = idx[:n_out]
    on = iota(out_cap, dev) < n_out
    if live is not None:
        lfull = torch.zeros(out_cap, dtype=torch.bool, device=dev)
        lfull[:n_out] = live[:n_out]
        on = on & lfull
    out_d = [_zero_where(on, d[full.clamp(0, d.shape[0] - 1)]) for d in datas]
    out_v = [v[full.clamp(0, v.shape[0] - 1)] & on for v in valids]
    return out_d, out_v


def _check_planes(name: str, planes: Sequence[torch.Tensor]) -> None:
    for p in planes:
        if p.dim() != 1:
            raise ValueError(f"{name}: plane of shape {tuple(p.shape)}")
        if p.element_size() not in (1, 2, 4, 8):
            raise TypeError(f"{name}: element size {p.element_size()}")


def gather_planes_cuda(datas: Sequence[torch.Tensor],
                       valids: Sequence[torch.Tensor], idx: torch.Tensor,
                       out_cap: int, n_out: int,
                       live: Optional[torch.Tensor] = None):
    """K6 on the card (csrc/gather.cu): same contract as
    :func:`gather_planes_plain`, one launch for every plane."""
    planes = list(datas) + list(valids)
    extra = [live] if live is not None else []
    cuda_lib.require_cuda("gather_planes", idx, *planes, *extra)
    if idx.dtype != torch.int64 or idx.dim() != 1 or idx.shape[0] < n_out:
        raise ValueError(f"gather_planes: index {idx.dtype} of shape "
                         f"{tuple(idx.shape)} for {n_out} rows")
    if live is not None and (live.dtype != torch.bool or live.shape[0] < n_out):
        raise ValueError("gather_planes: live mask must be bool, n_out rows")
    if not 0 <= n_out <= out_cap:
        raise ValueError(f"gather_planes: {n_out} rows into {out_cap}")
    _check_planes("gather_planes", planes)
    outs = [torch.empty(out_cap, dtype=p.dtype, device=idx.device) for p in planes]
    k = len(datas)
    if not planes:
        return outs[:k], outs[k:]
    srcs, _k1 = cuda_lib.ptr_array(planes)
    dsts, _k2 = cuda_lib.ptr_array(outs)
    caps, _k3 = cuda_lib.int_array([p.shape[0] for p in planes],
                                   cuda_lib.ctypes.c_longlong)
    sizes, _k4 = cuda_lib.int_array([p.element_size() for p in planes])
    err = cuda_lib.library().blz_gather_planes(
        idx.data_ptr(), n_out, live.data_ptr() if live is not None else None,
        out_cap, len(planes), srcs, dsts, caps, sizes,
        cuda_lib.stream_of(idx.device))
    cuda_lib.check(err, "gather_planes")
    cuda_lib.LAUNCHES["gather_planes"] += 1
    return outs[:k], outs[k:]


def gather_planes(datas: Sequence[torch.Tensor], valids: Sequence[torch.Tensor],
                  idx: torch.Tensor, out_cap: int, n_out: int,
                  live: Optional[torch.Tensor] = None):
    """Row gather of a batch's planes (``ColumnarBatch.take``): K6 on a
    CUDA index, the plain version on a CPU one."""
    fn = gather_planes_cuda if idx.is_cuda else gather_planes_plain
    return fn(datas, valids, idx, out_cap, n_out, live)


# -- K7: slice and concat ----------------------------------------------------------


def slice_planes_plain(datas: Sequence[torch.Tensor],
                       valids: Sequence[torch.Tensor], offset: int,
                       length: int, out_cap: int):
    """Contiguous row window [offset, offset + length) into ``out_cap``-row
    planes; plain twin of K7, the same function as
    blaze_tpu/core/kernels.py:_dyn_slice."""
    dev = datas[0].device if datas else torch.device("cpu")
    idx = iota(out_cap, dev) + offset
    live = iota(out_cap, dev) < length
    out_d = [_zero_where(live, d[idx.clamp(0, d.shape[0] - 1)]) for d in datas]
    out_v = [v[idx.clamp(0, v.shape[0] - 1)] & live for v in valids]
    return out_d, out_v


def concat_planes_plain(per_field_datas: List[List[torch.Tensor]],
                        per_field_valids: List[List[torch.Tensor]],
                        num_rows: Sequence[int], out_cap: int):
    """Field-wise concatenation of k batches' live rows into ``out_cap``-row
    planes; plain twin of K7, the same function as
    blaze_tpu/core/kernels.py:_concat_gather."""
    total = int(sum(num_rows))

    def cat(parts):
        live = [p[:n] for p, n in zip(parts, num_rows)]
        out = torch.cat(live)
        return torch.nn.functional.pad(out, (0, out_cap - total))

    return ([cat(p) for p in per_field_datas],
            [cat(p) for p in per_field_valids])


def _rows_of_sources(name: str, per_plane: List[List[torch.Tensor]],
                     counts: Sequence[int], starts: Sequence[int], out_cap: int):
    """K7 on the card: output row r of the k sources (source b holds
    counts[b] rows from starts[b]) in one launch; rows past the total are
    padding."""
    if not per_plane:
        return []
    k = len(counts)
    flat = [t for parts in per_plane for t in parts]
    cuda_lib.require_cuda(name, *flat)
    _check_planes(name, flat)
    total = int(sum(counts))
    if not 0 <= total <= out_cap or min(counts) < 0 or min(starts) < 0:
        raise ValueError(f"{name}: {list(counts)} rows from {list(starts)} "
                         f"into {out_cap}")
    dev = flat[0].device
    for parts in per_plane:
        if len(parts) != k or any(t.dtype != parts[0].dtype for t in parts):
            raise ValueError(f"{name}: every source needs each plane, one dtype")
    outs = [torch.empty(out_cap, dtype=parts[0].dtype, device=dev)
            for parts in per_plane]
    prefix = np.zeros(k + 1, dtype=np.int64)
    np.cumsum(counts, out=prefix[1:])
    table = np.concatenate([
        prefix, np.asarray(starts, dtype=np.int64),
        np.array([o.data_ptr() for o in outs], dtype=np.uint64).view(np.int64),
        np.array([o.element_size() for o in outs], dtype=np.int64),
        np.array([t.data_ptr() for t in flat], dtype=np.uint64).view(np.int64),
        np.array([t.shape[0] for t in flat], dtype=np.int64)])
    dev_table = torch.from_numpy(table).to(dev, non_blocking=True)
    err = cuda_lib.library().blz_concat_planes(
        dev_table.data_ptr(), k, len(per_plane), out_cap,
        cuda_lib.stream_of(dev))
    cuda_lib.check(err, name)
    cuda_lib.LAUNCHES[name] += 1
    return outs


def slice_planes_cuda(datas, valids, offset: int, length: int, out_cap: int):
    """K7 as a slice (k = 1 with a start offset); same contract as
    :func:`slice_planes_plain`."""
    outs = _rows_of_sources("slice_planes", [[p] for p in list(datas) + list(valids)],
                            [length], [offset], out_cap)
    return outs[:len(datas)], outs[len(datas):]


def concat_planes_cuda(per_field_datas, per_field_valids, num_rows, out_cap: int):
    """K7 as a concat (every start 0); same contract as
    :func:`concat_planes_plain`."""
    outs = _rows_of_sources("concat_planes",
                            list(per_field_datas) + list(per_field_valids),
                            list(num_rows), [0] * len(num_rows), out_cap)
    return outs[:len(per_field_datas)], outs[len(per_field_datas):]


def slice_planes(datas: Sequence[torch.Tensor], valids: Sequence[torch.Tensor],
                 offset: int, length: int, out_cap: int):
    """``ColumnarBatch.slice``: K7 on CUDA planes, the plain version on CPU
    ones."""
    on_cuda = bool(datas) and datas[0].is_cuda
    fn = slice_planes_cuda if on_cuda else slice_planes_plain
    return fn(datas, valids, offset, length, out_cap)


def concat_planes(per_field_datas: List[List[torch.Tensor]],
                  per_field_valids: List[List[torch.Tensor]],
                  num_rows: Sequence[int], out_cap: int):
    """``ColumnarBatch.concat``: K7 on CUDA planes, the plain version on CPU
    ones."""
    on_cuda = bool(per_field_datas) and per_field_datas[0][0].is_cuda
    fn = concat_planes_cuda if on_cuda else concat_planes_plain
    return fn(per_field_datas, per_field_valids, num_rows, out_cap)


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


# -- K11: a fused chain segment -------------------------------------------------


def fused_chain_plain(in_schema, steps, datas: Sequence[torch.Tensor],
                      valids: Sequence[torch.Tensor], num_rows: int):
    """Plain PyTorch twin of K11, the same function as the jitted
    blaze_tpu/exprs/compiler.py:1042 build_fused_closure: ``steps`` (project
    / filter / rename / expand, no coalesce) over one batch's planes.
    Expressions evaluate with ExprEvaluator over a LiveBatch, whose live
    mask starts as the rows below ``num_rows`` and which filters only
    narrow; each filtered output group then compacts once with K1's plain
    version (stable order, dead lanes zeroed). Returns (groups, counts):
    ``groups[g]`` is that group's (datas, valids) at the input capacity,
    ``counts[g]`` its row count, a 0-d int64 tensor for a filtered group
    and ``num_rows`` for an unfiltered one."""
    from blaze_tpu_torch.core.batch import DeviceColumn
    from blaze_tpu_torch.exprs.compiler import ExprEvaluator, LiveBatch, \
        fused_chain_schemas

    schemas = fused_chain_schemas(in_schema, steps)
    cap = int(datas[0].shape[0])
    cols = [DeviceColumn(f.dtype, d, v) for f, d, v in zip(in_schema.fields, datas, valids)]
    groups = [(cols, iota(cap, datas[0].device) < num_rows, False)]
    for si, st in enumerate(steps):
        kind = st[0]
        out_groups = []
        for cols, live, filtered in groups:
            batch = LiveBatch(schemas[si], cols, live)
            if kind == "project":
                out_groups.append((ExprEvaluator(list(st[1]), schemas[si]).evaluate(batch),
                                   live, filtered))
            elif kind == "filter":
                out_groups.append((cols, ExprEvaluator(list(st[1]), schemas[si])
                                   .evaluate_predicate(batch), True))
            elif kind == "rename":
                out_groups.append((cols, live, filtered))
            elif kind == "expand":
                for proj in st[1]:
                    out_groups.append((ExprEvaluator(list(proj), schemas[si])
                                       .evaluate(batch), live, filtered))
            else:
                raise ValueError(f"unknown fused step {kind!r}")
        groups = out_groups
    outs, counts = [], []
    for cols, live, filtered in groups:
        ds = tuple(c.data for c in cols)
        vs = tuple(c.validity for c in cols)
        if filtered:
            count, ds, vs = compact_planes_plain(ds, vs, live)
            ds, vs = tuple(ds), tuple(vs)
        else:
            count = num_rows
        outs.append((ds, vs))
        counts.append(count)
    return tuple(outs), tuple(counts)


def fused_chain(in_schema, steps, datas: Sequence[torch.Tensor],
                valids: Sequence[torch.Tensor], num_rows: int, kernel=None):
    """One fused chain segment over a batch's planes: K11 (with K1) on
    CUDA planes, the plain version on CPU planes. ``kernel`` is the
    segment's cached ``exprs.fused_triton.FusedKernel``, made here when
    not given."""
    if datas[0].is_cuda:
        from blaze_tpu_torch.exprs.fused_triton import FusedKernel

        kernel = kernel or FusedKernel(in_schema, steps)
        return kernel(datas, valids, num_rows)
    return fused_chain_plain(in_schema, steps, datas, valids, num_rows)


# -- K8: the unique-key inner join -------------------------------------------------

_JOIN_KEY_INT, _JOIN_KEY_FLOAT = 0, 1


def canon_words(data: torch.Tensor) -> torch.Tensor:
    """Canonical int64 join words, the same function as
    blaze_tpu/ops/joins/keymap.py:canon_word_traced: integers (and bools)
    widen with their sign; floats fold -0.0 into +0.0 and every NaN
    payload into the quiet NaN, then f64 words are the int64 bits and
    f32 words the int32 bits sign-extended. K8 computes the same word in
    its probe (csrc/join.cu blz_canon_word)."""
    if data.is_floating_point():
        d = _zero_where(data != 0, data)
        d = torch.where(torch.isnan(d),
                        torch.full((), float("nan"), dtype=d.dtype, device=d.device), d)
        if d.dtype == torch.float32:
            return d.view(torch.int32).to(torch.int64)
        return d.view(torch.int64)
    return data.to(torch.int64)


def inner_join_planes_plain(uniq: torch.Tensor, nk: int, num_rows: int,
                            key_data: torch.Tensor, key_valid: torch.Tensor,
                            probe_datas: Sequence[torch.Tensor],
                            probe_valids: Sequence[torch.Tensor],
                            build_datas: Sequence[torch.Tensor],
                            build_valids: Sequence[torch.Tensor]):
    """Plain PyTorch twin of K8, the same function as
    blaze_tpu/ops/joins/bhj.py:_inner_fast_kernel. ``uniq`` holds the
    build's sorted unique canonical words (length max(nk, 1)); the probe
    key hits where it is valid, the row is live and its word is in
    uniq[0, nk). Hit rows move to the front in probe order, each probe
    plane beside build row clip(rank, 0, cap_b - 1) of every build plane;
    rows past the count are padding. Returns (count as a 0-d int64
    tensor, probe datas, probe valids, build datas, build valids), every
    output plane of the probe batch's capacity."""
    cap_p = key_data.shape[0]
    dev = key_data.device
    w = canon_words(key_data)
    idx = torch.searchsorted(uniq, w)
    cidx = idx.clamp(0, max(nk - 1, 0))
    hit = key_valid & (iota(cap_p, dev) < num_rows) & (idx < nk) & (uniq[cidx] == w)
    count = hit.sum()
    pos = torch.where(hit, torch.cumsum(hit, 0) - 1, cap_p)

    def compact(x):
        out = torch.zeros(cap_p + 1, dtype=x.dtype, device=dev)
        out[pos] = x
        return out[:cap_p]

    cap_b = build_datas[0].shape[0] if build_datas else 1
    bidx = cidx.clamp(0, cap_b - 1)
    return (count, [compact(d) for d in probe_datas],
            [compact(v) for v in probe_valids],
            [compact(d[bidx]) for d in build_datas],
            [compact(v[bidx]) for v in build_valids])


def _join_key_kind(t: torch.Tensor) -> int:
    if t.dtype in (torch.float32, torch.float64):
        return _JOIN_KEY_FLOAT
    if t.dtype in (torch.bool, torch.int8, torch.int16, torch.int32, torch.int64):
        return _JOIN_KEY_INT
    raise TypeError(f"join key of dtype {t.dtype}")


def inner_join_planes_cuda(uniq: torch.Tensor, nk: int, num_rows: int,
                           key_data: torch.Tensor, key_valid: torch.Tensor,
                           probe_datas: Sequence[torch.Tensor],
                           probe_valids: Sequence[torch.Tensor],
                           build_datas: Sequence[torch.Tensor],
                           build_valids: Sequence[torch.Tensor]):
    """K8 on the card (csrc/join.cu): same contract as
    :func:`inner_join_planes_plain`, one probe for every plane and one
    scatter launch per 32 planes."""
    probe = list(probe_datas) + list(probe_valids)
    build = list(build_datas) + list(build_valids)
    cuda_lib.require_cuda("inner_join_planes", uniq, key_data, key_valid,
                          *probe, *build)
    cap_p = int(key_data.shape[0])
    kind = _join_key_kind(key_data)
    if uniq.dtype != torch.int64 or uniq.shape != (max(nk, 1),) or nk < 0:
        raise ValueError(f"inner_join_planes: sorted keys {uniq.dtype} of shape "
                         f"{tuple(uniq.shape)} for {nk} keys")
    if key_valid.dtype != torch.bool or key_data.shape != (cap_p,) or \
            key_valid.shape != (cap_p,) or not 0 <= num_rows <= cap_p or cap_p == 0:
        raise ValueError(f"inner_join_planes: key planes {tuple(key_data.shape)} / "
                         f"{tuple(key_valid.shape)}, {num_rows} rows")
    if not build_datas:
        raise ValueError("inner_join_planes: the build side has no planes")
    cap_b = int(build_datas[0].shape[0])
    if any(p.shape != (cap_p,) for p in probe) or \
            any(p.shape != (cap_b,) for p in build) or cap_b >= 2 ** 31:
        raise ValueError(f"inner_join_planes: probe planes need {cap_p} rows, "
                         f"build planes one capacity below 2^31 (got {cap_b})")
    _check_planes("inner_join_planes", probe + build)
    dev = key_data.device
    planes = probe + build
    outs = [torch.empty(cap_p, dtype=p.dtype, device=dev) for p in planes]
    codes = torch.empty(cap_p, dtype=torch.int32, device=dev)
    offs = torch.empty(cuda_lib.blocks(cap_p) + 1, dtype=torch.int64, device=dev)
    srcs, _k1 = cuda_lib.ptr_array(planes)
    dsts, _k2 = cuda_lib.ptr_array(outs)
    sizes, _k3 = cuda_lib.int_array([p.element_size() for p in planes])
    err = cuda_lib.library().blz_inner_join(
        uniq.data_ptr(), nk, num_rows, key_data.data_ptr(), key_data.element_size(),
        kind, key_valid.data_ptr(), cap_p, cap_b, len(probe), len(planes), srcs,
        dsts, sizes, codes.data_ptr(), offs.data_ptr(), cuda_lib.stream_of(dev))
    cuda_lib.check(err, "inner_join_planes")
    cuda_lib.LAUNCHES["inner_join_planes"] += 1
    a, b, c = len(probe_datas), len(probe), len(probe) + len(build_datas)
    return offs[-1], outs[:a], outs[a:b], outs[b:c], outs[c:]


def inner_join_planes(uniq: torch.Tensor, nk: int, num_rows: int,
                      key_data: torch.Tensor, key_valid: torch.Tensor,
                      probe_datas: Sequence[torch.Tensor],
                      probe_valids: Sequence[torch.Tensor],
                      build_datas: Sequence[torch.Tensor],
                      build_valids: Sequence[torch.Tensor]):
    """One probe batch's unique-key inner join (BroadcastJoinExec's hot
    path): K8 on a CUDA key, the plain version on a CPU one. Returns
    (count: int, probe datas, probe valids, build datas, build valids);
    the count is the one host sync."""
    fn = inner_join_planes_cuda if key_data.is_cuda else inner_join_planes_plain
    count, pd, pv, bd, bv = fn(uniq, nk, num_rows, key_data, key_valid,
                               probe_datas, probe_valids, build_datas, build_valids)
    return int(count), pd, pv, bd, bv


# -- K9: the generic join probe ----------------------------------------------------


def probe_codes_plain(uniq: torch.Tensor, nk: int, key_data: torch.Tensor,
                      key_valid: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of K9, the same function as
    blaze_tpu/ops/joins/keymap.py:_probe_fn: each row's rank
    clip(searchsorted(uniq, w), 0, nk - 1) where its key is valid and its
    canonical word w is in uniq[0, nk), else -1. ``uniq`` holds the
    build's sorted unique words (length max(nk, 1)); the codes are an
    int64 plane of the key's capacity."""
    w = canon_words(key_data)
    idx = torch.searchsorted(uniq, w)
    cidx = idx.clamp(0, max(nk - 1, 0))
    hit = key_valid & (idx < nk) & (uniq[cidx] == w)
    return torch.where(hit, cidx, torch.full((), -1, dtype=torch.int64,
                                             device=cidx.device))


def probe_codes_cuda(uniq: torch.Tensor, nk: int, key_data: torch.Tensor,
                     key_valid: torch.Tensor) -> torch.Tensor:
    """K9 on the card (csrc/join.cu): same contract as
    :func:`probe_codes_plain`, one launch."""
    cuda_lib.require_cuda("probe_codes", uniq, key_data, key_valid)
    cap = int(key_data.shape[0])
    if uniq.dtype != torch.int64 or uniq.shape != (max(nk, 1),) or nk < 0:
        raise ValueError(f"probe_codes: sorted keys {uniq.dtype} of shape "
                         f"{tuple(uniq.shape)} for {nk} keys")
    if key_valid.dtype != torch.bool or key_data.shape != (cap,) or \
            key_valid.shape != (cap,) or cap == 0:
        raise ValueError(f"probe_codes: key planes {tuple(key_data.shape)} / "
                         f"{tuple(key_valid.shape)}")
    kind = _join_key_kind(key_data)
    codes = torch.empty(cap, dtype=torch.int64, device=key_data.device)
    err = cuda_lib.library().blz_probe_codes(
        uniq.data_ptr(), nk, key_data.data_ptr(), key_data.element_size(), kind,
        key_valid.data_ptr(), cap, codes.data_ptr(),
        cuda_lib.stream_of(key_data.device))
    cuda_lib.check(err, "probe_codes")
    cuda_lib.LAUNCHES["probe_codes"] += 1
    return codes


def probe_codes(uniq: torch.Tensor, nk: int, key_data: torch.Tensor,
                key_valid: torch.Tensor) -> torch.Tensor:
    """One probe batch's build-map codes (the generic hash join's probe):
    K9 on a CUDA key, the plain version on a CPU one."""
    fn = probe_codes_cuda if key_data.is_cuda else probe_codes_plain
    return fn(uniq, nk, key_data, key_valid)


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


# -- K5: the key sort ------------------------------------------------------------

_KEY_BOOL, _KEY_INT, _KEY_FLOAT = 0, 1, 2
_WORD_UNSIGNED, _WORD_SIGNED, _WORD_FLOAT = 0, 1, 2
_MAX_SORT_KEYS = 16
# csrc/sort.cu BLZ_SORT_TILE: rows per block of a radix pass
SORT_TILE = cuda_lib.THREADS * 4


def sort_key_operands_plain(datas, valids, exists, spec):
    """Per key a (u8 rank, value) operand pair, direction-adjusted (plain
    PyTorch twin of K5's key pass, the same function as
    blaze_tpu/core/kernels.py:_key_ops_traced):
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


def _key_kind(t: torch.Tensor) -> int:
    if t.dtype in (torch.float32, torch.float64):
        return _KEY_FLOAT
    if t.dtype == torch.bool:
        return _KEY_BOOL
    if t.dtype in (torch.int8, torch.int16, torch.int32, torch.int64):
        return _KEY_INT
    raise TypeError(f"sort_key_operands: sort key of dtype {t.dtype}")


def sort_key_operands_cuda(datas, valids, exists, spec):
    """K5's key pass on the card (csrc/sort.cu): same operands as
    :func:`sort_key_operands_plain`, every key in one launch."""
    cuda_lib.require_cuda("sort_key_operands", exists, *datas, *valids)
    n = int(exists.shape[0])
    k = len(datas)
    if not 0 < k <= _MAX_SORT_KEYS or len(valids) != k or len(spec) != k:
        raise ValueError(f"sort_key_operands: {k} keys, {len(spec)} specs")
    if exists.dtype != torch.bool or any(v.dtype != torch.bool for v in valids):
        raise TypeError("sort_key_operands: exists and validity must be bool")
    for p in list(datas) + list(valids):
        if p.shape != (n,):
            raise ValueError(f"sort_key_operands: plane {tuple(p.shape)}, "
                             f"expected ({n},)")
    kinds = [_key_kind(d) for d in datas]
    dev = exists.device
    ranks = [torch.empty(n, dtype=torch.uint8, device=dev) for _ in datas]
    vals = [torch.empty(n, dtype=torch.uint8 if kind == _KEY_BOOL else d.dtype,
                        device=dev) for d, kind in zip(datas, kinds)]
    if n:
        keep = []

        def arr(pair):
            keep.append(pair[1])
            return pair[0]

        err = cuda_lib.library().blz_sort_key_operands(
            k, arr(cuda_lib.ptr_array(datas)), arr(cuda_lib.ptr_array(valids)),
            arr(cuda_lib.int_array([d.element_size() for d in datas])),
            arr(cuda_lib.int_array(kinds)),
            arr(cuda_lib.int_array([int(a) for a, _ in spec])),
            arr(cuda_lib.int_array([int(nf) for _, nf in spec])),
            exists.data_ptr(), n, arr(cuda_lib.ptr_array(ranks)),
            arr(cuda_lib.ptr_array(vals)), cuda_lib.stream_of(dev))
        cuda_lib.check(err, "sort_key_operands")
        cuda_lib.LAUNCHES["sort_key_operands"] += 1
    return [t for pair in zip(ranks, vals) for t in pair]


def sort_key_operands(datas, valids, exists, spec):
    """All sort keys of a batch as [rank0, val0, rank1, val1, ...]: K5's
    key pass on a CUDA batch, the plain version on a CPU one."""
    fn = sort_key_operands_cuda if exists.is_cuda else sort_key_operands_plain
    return fn(datas, valids, exists, spec)


def lexsort_indices_plain(operands: List[torch.Tensor],
                          num_rows: Optional[int] = None) -> torch.Tensor:
    """Indices that sort rows lexicographically by ``operands`` (first
    operand most significant), ties in row order: successive stable sorts
    from the least significant operand (plain twin of K5's sort). Only
    rows [0, num_rows) are sorted; the rows past them keep their place
    at the end, as padding rows (rank 6 in the first operand, every value
    0) would in a sort of all rows."""
    n = operands[0].shape[0]
    m = n if num_rows is None else num_rows
    idx = torch.arange(m, dtype=torch.int64, device=operands[0].device)
    for op in reversed(operands):
        key = op[idx]
        if key.dtype == torch.uint8:
            key = key.to(torch.int16)
        order = torch.sort(key, stable=True).indices
        idx = idx[order]
    if m < n:
        idx = torch.cat([idx, torch.arange(m, n, dtype=torch.int64,
                                           device=idx.device)])
    return idx


def _word_kind(t: torch.Tensor) -> int:
    if t.dtype in (torch.float32, torch.float64):
        return _WORD_FLOAT
    if t.dtype in (torch.int8, torch.int16, torch.int32, torch.int64):
        return _WORD_SIGNED
    if t.dtype in (torch.uint8, torch.bool):
        return _WORD_UNSIGNED
    raise TypeError(f"lexsort_indices: operand of dtype {t.dtype}")


def radix_passes(and_or: np.ndarray, sizes: Sequence[int]) -> List[Tuple[int, int]]:
    """(operand, bit shift) of every 8-bit digit that is not the same in
    all rows, least significant first: K5's pass list. ``and_or`` holds
    per operand the AND and the OR of its order-preserving words."""
    passes = []
    for o in reversed(range(len(sizes))):
        differ = int(and_or[2 * o]) ^ int(and_or[2 * o + 1])
        passes += [(o, 8 * b) for b in range(sizes[o]) if (differ >> (8 * b)) & 0xFF]
    return passes


def lexsort_indices_cuda(operands: List[torch.Tensor],
                         num_rows: Optional[int] = None) -> torch.Tensor:
    """K5's stable LSD radix sort on the card (csrc/sort.cu); same result
    as :func:`lexsort_indices_plain`. One sync: the per-operand bits that
    decide which digit passes run."""
    cuda_lib.require_cuda("lexsort_indices", *operands)
    n = int(operands[0].shape[0])
    m = n if num_rows is None else int(num_rows)
    if not 0 < len(operands) <= 2 * _MAX_SORT_KEYS or not 0 <= m <= n or \
            n >= 2 ** 31 or any(op.shape != (n,) for op in operands):
        raise ValueError(f"lexsort_indices: {len(operands)} operands of "
                         f"{[tuple(o.shape) for o in operands]}, {m} rows")
    dev = operands[0].device
    out = torch.empty(n, dtype=torch.int64, device=dev)
    if n == 0:
        return out
    lib = cuda_lib.library()
    sizes = [op.element_size() for op in operands]
    kinds = [_word_kind(op) for op in operands]
    keep = []

    def arr(pair):
        keep.append(pair[1])
        return pair[0]

    datas = arr(cuda_lib.ptr_array(operands))
    csizes, ckinds = arr(cuda_lib.int_array(sizes)), arr(cuda_lib.int_array(kinds))
    stream = cuda_lib.stream_of(dev)
    passes = []
    if m > 1:
        and_or = torch.empty(2 * len(operands), dtype=torch.int64, device=dev)
        err = lib.blz_sort_bits(len(operands), datas, csizes, ckinds, m,
                                and_or.data_ptr(), stream)
        cuda_lib.check(err, "lexsort_indices")
        passes = radix_passes(and_or.cpu().numpy().view(np.uint64), sizes)
    ntiles = max(1, -(-m // SORT_TILE))
    idx_a = torch.empty(max(m, 1), dtype=torch.int32, device=dev)
    idx_b = torch.empty(max(m, 1), dtype=torch.int32, device=dev)
    counts = torch.empty(ntiles * 256, dtype=torch.int32, device=dev)
    err = lib.blz_radix_sort(
        len(operands), datas, csizes, ckinds, m, n, len(passes),
        arr(cuda_lib.int_array([o for o, _ in passes])),
        arr(cuda_lib.int_array([s for _, s in passes])),
        idx_a.data_ptr(), idx_b.data_ptr(), counts.data_ptr(), out.data_ptr(),
        stream)
    cuda_lib.check(err, "lexsort_indices")
    cuda_lib.LAUNCHES["lexsort_indices"] += 1
    return out


def lexsort_indices(operands: List[torch.Tensor],
                    num_rows: Optional[int] = None) -> torch.Tensor:
    """The permutation that sorts rows [0, num_rows) by ``operands`` (ties
    in row order), rows past them after, in place: K5 on CUDA operands,
    the plain version on CPU ones."""
    fn = lexsort_indices_cuda if operands[0].is_cuda else lexsort_indices_plain
    return fn(operands, num_rows)


# -- K10: the segmented aggregate ------------------------------------------------
#
# The sort route of the grouped aggregation, blaze_tpu/ops/agg_device.py
# _partial_kernel and _merge_kernel: K5 sorts the rows so that equal keys
# are adjacent, ``segment_ids`` cuts the sorted rows into segments, and
# ``segment_reduce`` runs the slot program's ops (ADD / COUNT / MIN / MAX,
# gated by up to three validity planes) and emits over each segment.
# Segments are dense by construction, so group s is segment s.

OP_ADD, OP_COUNT, OP_MIN, OP_MAX = 0, 1, 2, 3
EMIT_RAW, EMIT_NONZERO, EMIT_WHERE = 0, 1, 2
_INT_DTYPES = (torch.int8, torch.int16, torch.int32, torch.int64)
# csrc/seg_agg.cu limits of one launch
_MAX_SEG_KEYS = 16
_MAX_SEG_OPS = 24
_MAX_SEG_EMITS = 24
_QNAN_BITS = 0x7FF8000000000000  # every NaN a float state ends as


class AggOp:
    """One op of the slot program: ``kind`` into a table initialised to
    ``init``, from ``src`` (int64, or float64 for a float state; None for
    COUNT) times ``mult``, where every plane of ``valids`` holds."""

    __slots__ = ("kind", "src", "valids", "mult", "init")

    def __init__(self, kind, src, valids, mult=1, init=0):
        self.kind, self.src, self.valids = kind, src, list(valids)
        self.mult, self.init = mult, init

    @property
    def is_float(self) -> bool:
        return self.src is not None and self.src.is_floating_point()


class AggEmit:
    """One output column: table ``table`` RAW, NONZERO (as bool), or its
    value WHERE table ``aux`` is nonzero (else 0), cast to ``dtype``."""

    __slots__ = ("kind", "table", "aux", "dtype")

    def __init__(self, kind, table, dtype, aux=-1):
        self.kind, self.table, self.aux, self.dtype = kind, table, aux, dtype


def canonical_keys(key_data, key_valid):
    """blaze_tpu/ops/agg_device.py:_canonical_keys: float keys fold -0.0
    into 0.0 and every NaN into one NaN; null rows are 0."""
    out = []
    for d, v in zip(key_data, key_valid):
        if d.is_floating_point():
            d = torch.where(torch.isnan(d), float("nan"), d)
            d = torch.where(d == 0, 0.0, d)
        out.append(_zero_where(v, d))
    return out


def _segment_planes(key_data, key_valid, exists, direct: bool):
    """The planes ``_segmentation`` sorts and cuts by. A single integer
    key whose valid values all lie in [0, capacity - 1) is its own segment
    id, null rows going to capacity - 1 (so they come last); the choice is
    made on the device, as the reference's ``lax.cond`` makes it: the one
    plane is then that id, valid on every existing row. Otherwise the
    keys themselves, null first."""
    if not (direct and len(key_data) == 1 and key_data[0].dtype in _INT_DTYPES):
        return list(key_data), list(key_valid)
    cap = exists.shape[0]
    d64, v = key_data[0].to(torch.int64), key_valid[0]
    fits = torch.where(exists & v, (d64 >= 0) & (d64 < cap - 1), True).all()
    data = torch.where(fits, torch.where(v, d64, cap - 1), _zero_where(v, d64))
    return [data], [torch.where(fits, exists, v)]


def segment_starts_plain(datas, valids, order, num_rows: int):
    """Plain twin of K10's segmentation pass. Over the rows in ``order``'s
    sorted positions [0, num_rows), a segment starts where any key's
    validity differs from the previous row's, or both are valid and the
    values differ (IEEE: -0.0 equals 0.0, and a NaN differs from every
    key, itself included, as ``sd[1:] != sd[:-1]`` of the canonical keys
    does in the reference). Returns (starts, count): ``starts`` (capacity
    + 1 int64) holds the sorted position where segment s starts for s <
    count and num_rows after, ``count`` the segment count (0-d int64)."""
    dev = order.device
    cap = order.shape[0]
    n = num_rows
    rows = order[:n]
    new = torch.zeros(n, dtype=torch.bool, device=dev)
    if n:
        new[0] = True
    for d, v in zip(canonical_keys(datas, valids), valids):
        sd, sv = d[rows], v[rows]
        new[1:] |= (sd[1:] != sd[:-1]) | (sv[1:] != sv[:-1])
    sid = torch.cumsum(new.to(torch.int64), 0) - 1
    starts = torch.full((cap + 2,), n, dtype=torch.int64, device=dev)
    starts.scatter_(0, torch.where(new, sid, cap + 1), iota(n, dev))
    return starts[:cap + 1], new.sum()


def segment_starts_cuda(datas, valids, order, num_rows: int):
    """K10's segmentation pass on the card (csrc/seg_agg.cu: flag, block
    scan, stable scatter of the starts); same result as
    :func:`segment_starts_plain`."""
    cuda_lib.require_cuda("segment_ids", order, *datas, *valids)
    cap = int(order.shape[0])
    k = len(datas)
    if not 0 < k <= _MAX_SEG_KEYS or len(valids) != k or order.dtype != torch.int64:
        raise ValueError(f"segment_ids: {k} keys, order {order.dtype}")
    if not 0 <= num_rows <= cap:
        raise ValueError(f"segment_ids: {num_rows} rows of {cap}")
    for d, v in zip(datas, valids):
        if d.shape != (cap,) or v.shape != (cap,) or v.dtype != torch.bool:
            raise ValueError("segment_ids: key planes must be capacity-long, "
                             "validity bool")
        if d.dtype not in _INT_DTYPES + (torch.bool, torch.float32, torch.float64):
            raise TypeError(f"segment_ids: key of dtype {d.dtype}")
    dev = order.device
    starts = torch.empty(cap + 1, dtype=torch.int64, device=dev)
    if num_rows == 0:
        starts.zero_()
        return starts, torch.zeros((), dtype=torch.int64, device=dev)
    nb = cuda_lib.blocks(num_rows)
    flags = torch.empty(num_rows, dtype=torch.uint8, device=dev)
    offs = torch.empty(nb + 1, dtype=torch.int64, device=dev)
    keep = []

    def arr(pair):
        keep.append(pair[1])
        return pair[0]

    err = cuda_lib.library().blz_segment_starts(
        k, arr(cuda_lib.ptr_array(datas)), arr(cuda_lib.ptr_array(valids)),
        arr(cuda_lib.int_array([d.element_size() for d in datas])),
        arr(cuda_lib.int_array([int(d.is_floating_point()) for d in datas])),
        order.data_ptr(), num_rows, cap, flags.data_ptr(), offs.data_ptr(),
        starts.data_ptr(), cuda_lib.stream_of(dev))
    cuda_lib.check(err, "segment_ids")
    cuda_lib.LAUNCHES["segment_ids"] += 1
    return starts, offs[nb]


def segment_ids(key_data, key_valid, exists, num_rows: int, direct: bool = True):
    """``_segmentation`` of blaze_tpu/ops/agg_device.py:1082: the stable
    order that makes equal keys adjacent (K5's key pass and radix sort,
    keys ascending, null first, NaN last), then K10's segment starts over
    it. ``key_valid`` is masked with ``exists`` (a prefix of num_rows
    rows). ``direct`` allows the single-integer-key case where the key is
    the segment id. Returns (order, starts, count) as
    :func:`segment_starts_plain` describes them."""
    datas, valids = _segment_planes(key_data, key_valid, exists, direct)
    ops = sort_key_operands(datas, valids, exists, [(True, True)] * len(datas))
    order = lexsort_indices(ops, num_rows)
    fn = segment_starts_cuda if order.is_cuda else segment_starts_plain
    starts, count = fn(datas, valids, order, num_rows)
    return order, starts, count


def _order_words(x: torch.Tensor) -> torch.Tensor:
    """float64 -> int64 words in IEEE total order (-0.0 below 0.0); the
    map is its own inverse."""
    b = x.view(torch.int64)
    return b ^ ((b >> 63) & 0x7FFFFFFFFFFFFFFF)


def _quiet_nan(x: torch.Tensor) -> torch.Tensor:
    """Every NaN of a float64 plane as the quiet NaN 0x7FF8...: the payload
    a NaN gets from arithmetic differs between the host and the card."""
    return torch.where(torch.isnan(x), _QNAN_BITS, x.view(torch.int64)).view(torch.float64)


def narrow_float(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A float64 plane cast to ``dtype``; NaN narrows to the quiet float32
    NaN on either device."""
    out = x.to(dtype)
    if dtype != torch.float32:
        return out
    return torch.where(torch.isnan(x), 0x7FC00000, out.view(torch.int32)).view(torch.float32)


def _float_fold(seg, contrib, size):
    """Per-segment sums as left folds from +0.0 in row order: CPU
    ``index_add_`` on a 1-d float64 table adds its updates one by one in
    index order (the scatter-add order of the reference's XLA CPU
    kernels); on a CUDA tensor it would use atomics, so the fold runs on
    the host."""
    table = torch.zeros(size, dtype=torch.float64)
    table.index_add_(0, seg.cpu(), contrib.cpu())
    return table.to(contrib.device)


def segment_reduce_plain(order, starts, count, num_rows: int, ops, emits):
    """Plain twin of K10's reduction: the ops over the rows of each segment
    (the sorted positions starts[s] .. starts[s + 1]), in sorted order,
    then the emits; everything past ``count`` is 0. Float ADD is a left
    fold from +0.0 in sorted row order; float MIN/MAX follow XLA's
    scatter min/max (-0.0 below 0.0, a NaN in the segment gives NaN); a
    float result that is NaN is the quiet NaN. Returns (emit outputs
    (int64 / float64 / bool), first), ``first`` the row index of each
    segment's first row (0 past count)."""
    dev = order.device
    cap = order.shape[0]
    n = num_rows
    rows = order[:n]
    pos = iota(n, dev)
    seg = torch.searchsorted(starts[:cap], pos, right=True) - 1
    out_valid = iota(cap, dev) < count
    tables = []
    for op in ops:
        ok = torch.ones(n, dtype=torch.bool, device=dev)
        for v in op.valids:
            ok = ok & v[rows]
        if op.kind == OP_COUNT:
            t = torch.zeros(cap, dtype=torch.int64, device=dev)
            t.index_add_(0, seg, ok.to(torch.int64))
        elif op.is_float:
            src = op.src[rows]
            if op.kind == OP_ADD:
                t = _float_fold(seg, torch.where(ok, src, 0.0), cap)
            else:
                sent = float("inf") if op.kind == OP_MIN else float("-inf")
                w = _order_words(torch.where(ok, src, sent))
                t = torch.full((cap,), sent, dtype=torch.float64, device=dev)
                t = _order_words(_order_words(t).scatter_reduce(
                    0, seg, w, "amin" if op.kind == OP_MIN else "amax")).view(torch.float64)
                nan = torch.zeros(cap, dtype=torch.int64, device=dev)
                nan.index_add_(0, seg, (ok & torch.isnan(src)).to(torch.int64))
                t = torch.where(nan > 0, float("nan"), t)
            t = _quiet_nan(t)
        else:
            src = op.src[rows]
            if op.kind == OP_ADD:
                t = torch.zeros(cap, dtype=torch.int64, device=dev)
                t.index_add_(0, seg, torch.where(ok, src * op.mult, 0))
            else:
                t = torch.full((cap,), op.init, dtype=torch.int64, device=dev)
                t.scatter_reduce_(0, seg, torch.where(ok, src, op.init),
                                  "amin" if op.kind == OP_MIN else "amax")
        tables.append(t)
    outs = []
    for e in emits:
        t = tables[e.table]
        if e.kind == EMIT_NONZERO:
            outs.append((t != 0) & out_valid)
            continue
        if e.kind == EMIT_WHERE:
            t = _zero_where(tables[e.aux] != 0, t)
        outs.append(_zero_where(out_valid, t))
    first = _zero_where(out_valid, order[starts[:cap].clamp(max=max(n - 1, 0))])
    return outs, first


def segment_reduce_cuda(name, order, starts, count, num_rows: int, ops, emits):
    """K10's reduction on the card (csrc/seg_agg.cu: one thread per
    segment folds its rows in sorted order); same outputs as
    :func:`segment_reduce_plain`. ``count`` is the device scalar
    ``segment_starts_cuda`` returned."""
    srcs = [op.src for op in ops if op.src is not None]
    valids = [v for op in ops for v in op.valids]
    cuda_lib.require_cuda(name, order, starts, *srcs, *valids)
    cap = int(order.shape[0])
    if len(ops) > _MAX_SEG_OPS or len(emits) > _MAX_SEG_EMITS or \
            any(len(op.valids) > 3 for op in ops):
        raise NotImplementedError(f"{name}: more aggregates than one "
                                  "segment-reduce launch takes")
    for s in srcs:
        if s.dtype not in (torch.int64, torch.float64) or s.shape != (cap,):
            raise TypeError(f"{name}: state source {s.dtype} of {tuple(s.shape)}")
    for v in valids:
        if v.dtype != torch.bool or v.shape != (cap,):
            raise TypeError(f"{name}: validity plane {v.dtype} of {tuple(v.shape)}")
    if starts.shape != (cap + 1,) or count.dtype != torch.int64:
        raise ValueError(f"{name}: starts {tuple(starts.shape)} for {cap} rows")
    dev = order.device
    outs = [torch.empty(cap, dtype=torch.bool, device=dev) if e.kind == EMIT_NONZERO
            else torch.empty(cap, dtype=torch.float64 if ops[e.table].is_float
                             else torch.int64, device=dev) for e in emits]
    first = torch.empty(cap, dtype=torch.int64, device=dev)
    keep = []

    def arr(pair):
        keep.append(pair[1])
        return pair[0]

    def init_bits(op):
        if not op.is_float:
            return int(op.init)
        return int(torch.tensor(float(op.init), dtype=torch.float64)
                   .view(torch.int64).item())

    op_valid = []
    for op in ops:
        op_valid += list(op.valids) + [None] * (3 - len(op.valids))
    LL = cuda_lib.ctypes.c_longlong
    err = cuda_lib.library().blz_segment_reduce(
        starts.data_ptr(), order.data_ptr(), count.data_ptr(), cap,
        len(ops), arr(cuda_lib.int_array([op.kind for op in ops])),
        arr(cuda_lib.int_array([int(op.is_float) for op in ops])),
        arr(cuda_lib.ptr_array([op.src for op in ops])),
        arr(cuda_lib.int_array([len(op.valids) for op in ops])),
        arr(cuda_lib.ptr_array(op_valid)),
        arr(cuda_lib.int_array([op.mult for op in ops], LL)),
        arr(cuda_lib.int_array([init_bits(op) for op in ops], LL)),
        len(emits), arr(cuda_lib.int_array([e.kind for e in emits])),
        arr(cuda_lib.int_array([e.table for e in emits])),
        arr(cuda_lib.int_array([e.aux for e in emits])),
        arr(cuda_lib.ptr_array(outs)), first.data_ptr(), cuda_lib.stream_of(dev))
    cuda_lib.check(err, name)
    cuda_lib.LAUNCHES[name] += 1
    return outs, first


def segment_reduce(name, order, starts, count, num_rows: int, ops, emits):
    """``_reduce_aggs`` (:1165) / ``_merge_reduce`` (:1330) over sorted
    segments: K10 on CUDA planes, the plain version on CPU ones. ``name``
    is the launch count to add to."""
    if order.is_cuda:
        return segment_reduce_cuda(name, order, starts, count, num_rows, ops, emits)
    return segment_reduce_plain(order, starts, count, num_rows, ops, emits)


# -- K12: the host table's slot update ---------------------------------------------
#
# The eager scatters of blaze_tpu/ops/aggfns.py (.at[slots].add/min/max/set,
# mode="drop") that the host AggTable runs into its persistent slot tables,
# one call per batch for all of its aggregates. Rows carry their interned
# slot id; a padding row carries the table capacity and drops.

UPD_ADD, UPD_MIN, UPD_MAX, UPD_FLAG, UPD_FIRST = 0, 1, 2, 3, 4
# csrc/slot_update.cu limit of one call
_MAX_UPD_OPS = 24
I64_MAX = (1 << 63) - 1


class SlotUpdate:
    """One op of K12 into ``table`` (capacity-long, updated in place), over
    the rows where the row exists and every plane of ``valids`` holds:

    - ADD: ``table += src`` (int64 table; ``src`` None counts 1 a row), or
      the same into a float64 table as a left fold in row order from the
      slot's value;
    - MIN / MAX: the extreme of the slot's value and ``src`` (int64, or
      float64 with -0.0 below 0.0 and NaN propagating);
    - FLAG: ``table = True`` (bool table);
    - FIRST: the row of least ``order`` wins where that order is at most
      ``order_table``'s, the last row in row order of those tied on it:
      ``order_table`` takes the order, ``table`` the row's ``src`` and
      ``valid_table`` the AND of its ``wvalids``.
    """

    __slots__ = ("kind", "table", "src", "valids", "order", "wvalids",
                 "valid_table", "order_table")

    def __init__(self, kind, table, src=None, valids=(), order=None,
                 wvalids=(), valid_table=None, order_table=None):
        self.kind, self.table, self.src = kind, table, src
        self.valids = list(valids)
        self.order, self.wvalids = order, list(wvalids)
        self.valid_table, self.order_table = valid_table, order_table

    @property
    def folds(self) -> bool:
        """Run in slot-sorted row order (float ADD, FIRST), not by atomics."""
        return self.kind == UPD_FIRST or (
            self.kind == UPD_ADD and self.table.is_floating_point())


def _upd_rows(op: SlotUpdate, slots: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    ok = mask & (slots >= 0) & (slots < op.table.shape[0])
    for v in op.valids:
        ok = ok & v
    return ok


def _touched(cap: int, s: torch.Tensor) -> torch.Tensor:
    out = torch.zeros(cap, dtype=torch.bool, device=s.device)
    out[s] = True
    return out


def slot_update_plain(slots: torch.Tensor, mask: torch.Tensor, ops) -> None:
    """Plain PyTorch twin of K12: each op's update of its table in place,
    the arithmetic of the reference's scatters. Float ADD is CPU
    ``index_add_`` (one by one in row order, XLA's scatter-add order) on a
    copy of the table, so the fold starts from the slot's value; a touched
    float slot holding a NaN ends as the quiet NaN."""
    n = slots.shape[0]
    for op in ops:
        table = op.table
        cap = table.shape[0]
        ok = _upd_rows(op, slots, mask)
        s = slots[ok]
        if op.kind == UPD_FLAG:
            table[s] = True
        elif op.kind == UPD_ADD and table.is_floating_point():
            work = table.detach().cpu().clone()
            work.index_add_(0, s.cpu(), op.src[ok].cpu())
            work = work.to(table.device)
            table.copy_(torch.where(_touched(cap, s), _quiet_nan(work), work))
        elif op.kind == UPD_ADD:
            src = torch.ones(n, dtype=torch.int64, device=slots.device) \
                if op.src is None else op.src
            table.index_add_(0, s, src[ok])
        elif op.kind in (UPD_MIN, UPD_MAX):
            how = "amin" if op.kind == UPD_MIN else "amax"
            if not table.is_floating_point():
                table.scatter_reduce_(0, s, op.src[ok], how)
                continue
            src = op.src[ok]
            words = _order_words(table).scatter_reduce(0, s, _order_words(src), how)
            nan = torch.zeros(cap, dtype=torch.int64, device=table.device)
            nan.index_add_(0, s, torch.isnan(src).to(torch.int64))
            out = torch.where((nan > 0) | torch.isnan(table), float("nan"),
                              _order_words(words).view(torch.float64))
            table.copy_(torch.where(_touched(cap, s), _quiet_nan(out), table))
        else:  # UPD_FIRST
            rows = iota(n, slots.device)[ok]
            o = op.order[ok]
            best = op.order_table.scatter_reduce(0, s, o, "amin")
            win = o == best[s]
            last = torch.full((cap,), -1, dtype=torch.int64, device=table.device)
            last.scatter_reduce_(0, s[win], rows[win], "amax")
            w = win & (rows == last[s])
            wvalid = torch.ones(n, dtype=torch.bool, device=slots.device)
            for v in op.wvalids:
                wvalid = wvalid & v
            table[s[w]] = op.src[rows[w]]
            op.valid_table[s[w]] = wvalid[rows[w]]
            op.order_table.copy_(best)


def _check_table(op: SlotUpdate, cap: int) -> None:
    """The words of an op that stay the same from batch to batch."""
    t = op.table
    if t.shape != (cap,):
        raise ValueError(f"slot_update: table of {tuple(t.shape)}, expected ({cap},)")
    if len(op.valids) > 3 or len(op.wvalids) > 3:
        raise ValueError("slot_update: at most three validity planes an op")
    if op.kind == UPD_FLAG:
        ok = t.dtype == torch.bool
    elif op.kind == UPD_FIRST:
        ok = (t.element_size() in (1, 2, 4, 8)
              and op.valid_table is not None and op.valid_table.dtype == torch.bool
              and op.valid_table.shape == (cap,) and op.order_table is not None
              and op.order_table.dtype == torch.int64 and op.order_table.shape == (cap,))
    else:
        ok = op.kind in (UPD_ADD, UPD_MIN, UPD_MAX) and t.dtype in (torch.int64, torch.float64)
    if not ok:
        raise TypeError(f"slot_update: op kind {op.kind} over a {t.dtype} table")


def _check_rows(op: SlotUpdate, n: int) -> None:
    """The row planes of one batch's op."""
    planes = [p for p in [op.src, op.order] + op.valids + op.wvalids if p is not None]
    if any(p.shape != (n,) for p in planes):
        raise ValueError(f"slot_update: row planes must be ({n},)")
    if any(v.dtype != torch.bool for v in op.valids + op.wvalids):
        raise TypeError("slot_update: validity planes must be bool")
    src = None if op.src is None else op.src.dtype
    t = op.table.dtype
    if op.kind == UPD_FLAG:
        ok = src is None
    elif op.kind == UPD_FIRST:
        ok = src == t and op.order is not None and op.order.dtype == torch.int64
    elif op.kind == UPD_ADD and t == torch.int64:
        ok = src in (None, torch.int64)
    else:
        ok = src == t
    if not ok:
        raise TypeError(f"slot_update: op kind {op.kind} over a {t} table from {src}")


class SlotUpdatePack:
    """K12's argument arrays for an op list that recurs batch after batch,
    as the host table's does. The words that stay the same (kinds, table
    pointers, FIRST's tables, element sizes, plane counts) are checked and
    packed once; each call then only checks the rows and writes their
    planes' pointers into the arrays in place. An op list that differs in
    any of those words (a table that grew is a new tensor) packs anew."""

    def __init__(self):
        self.key = None
        self.static = ()
        self.rows = ()

    @staticmethod
    def _key(ops, cap: int):
        def ptr(t):
            return None if t is None else t.data_ptr()

        return (cap,) + tuple((op.kind, op.table.dtype, op.table.data_ptr(), len(op.valids),
                               len(op.wvalids), ptr(op.valid_table), ptr(op.order_table))
                              for op in ops)

    def args(self, ops, n: int, cap: int):
        """(static arrays, row arrays) for ``blz_slot_update``: kind,
        is_float, nvalid, table, esize, nwvalid, valid_table, order_table;
        then src, valid, order, wvalid."""
        key = self._key(ops, cap)
        if key != self.key:
            for op in ops:
                _check_table(op, cap)
            m = max(1, len(ops))
            I, P = cuda_lib.ctypes.c_int, cuda_lib.ctypes.c_void_p

            def ptrs(ts):
                return (P * m)(*[None if t is None else t.data_ptr() for t in ts])

            self.static = (
                (I * m)(*[op.kind for op in ops]),
                (I * m)(*[int(op.table.is_floating_point()) for op in ops]),
                (I * m)(*[len(op.valids) for op in ops]),
                ptrs([op.table for op in ops]),
                (I * m)(*[op.table.element_size() for op in ops]),
                (I * m)(*[len(op.wvalids) for op in ops]),
                ptrs([op.valid_table for op in ops]),
                ptrs([op.order_table for op in ops]))
            self.rows = ((P * m)(), (P * (3 * m))(), (P * m)(), (P * (3 * m))())
            self.key = key
        src, valid, order, wvalid = self.rows
        for o, op in enumerate(ops):
            _check_rows(op, n)
            src[o] = None if op.src is None else op.src.data_ptr()
            order[o] = None if op.order is None else op.order.data_ptr()
            for q in range(3):
                valid[3 * o + q] = op.valids[q].data_ptr() if q < len(op.valids) else None
                wvalid[3 * o + q] = op.wvalids[q].data_ptr() if q < len(op.wvalids) else None
        return self.static, self.rows


def slot_update_cuda(slots: torch.Tensor, mask: torch.Tensor, ops,
                     pack: Optional[SlotUpdatePack] = None) -> None:
    """K12 on the card (csrc/slot_update.cu): every op's update in one
    atomic launch (integer ADD, MIN, MAX, FLAG) and one fold launch over
    the rows sorted by slot (float ADD, FIRST; K5 sorts them); same
    tables as :func:`slot_update_plain`. ``pack`` keeps the argument
    arrays of a caller that sends the same op list every batch."""
    if not ops:
        return
    tensors = [slots, mask]
    for op in ops:
        tensors += [p for p in [op.table, op.src, op.order, op.valid_table, op.order_table]
                    + op.valids + op.wvalids if p is not None]
    cuda_lib.require_cuda("slot_update", *tensors)
    n = int(slots.shape[0])
    cap = int(ops[0].table.shape[0])
    if len(ops) > _MAX_UPD_OPS:
        raise NotImplementedError("slot_update: more aggregates than one launch takes")
    if slots.dtype != torch.int64 or slots.shape != (n,) or mask.dtype != torch.bool \
            or mask.shape != (n,):
        raise TypeError("slot_update: slots must be int64 and the mask bool, both (n,)")
    (kind, is_float, nvalid, table, esize, nwvalid, valid_table, order_table), \
        (src, valid, order, wvalid) = (pack or SlotUpdatePack()).args(ops, n, cap)
    perm = lexsort_indices([slots]) if any(op.folds for op in ops) else None
    err = cuda_lib.library().blz_slot_update(
        slots.data_ptr(), mask.data_ptr(), n, cap,
        None if perm is None else perm.data_ptr(), len(ops), kind, is_float, src, nvalid,
        valid, table, esize, order, nwvalid, wvalid, valid_table, order_table,
        cuda_lib.stream_of(slots.device))
    cuda_lib.check(err, "slot_update")
    cuda_lib.LAUNCHES["slot_update"] += 1


def slot_update(slots: torch.Tensor, mask: torch.Tensor, ops,
                pack: Optional[SlotUpdatePack] = None) -> None:
    """The reference's scatters of one batch into the host table's slot
    tables, in place: K12 on CUDA planes (``pack`` keeps its argument
    arrays between calls), the plain version on CPU ones."""
    if slots.is_cuda:
        slot_update_cuda(slots, mask, ops, pack)
    else:
        slot_update_plain(slots, mask, ops)


# -- window counters (host numpy) -------------------------------------------------
#
# Group structure arrives as boundary masks over rows sorted by (partition,
# order), never as control flow; a carry continues a segment left open by
# the previous batch (blaze_tpu/core/kernels.py:374-404, copied).


def seg_start_index(seg_start: np.ndarray) -> np.ndarray:
    """Per-row index of the most recent True in ``seg_start`` at or before
    the row; -1 for head rows that continue a segment carried in from the
    previous batch."""
    n = len(seg_start)
    idx = np.arange(n, dtype=np.int64)
    return np.maximum.accumulate(np.where(seg_start, idx, np.int64(-1)))


def restarting_counters(part_start: np.ndarray, new_peer: np.ndarray,
                        carry_rn: int = 0, carry_rank: int = 1,
                        carry_dense: int = 0):
    """row_number / rank / dense_rank as restart-at-segment prefix scans.

    ``part_start``/``new_peer`` are boundary masks over rows pre-sorted by
    (partition, order); every partition start must also be a peer start.
    Carries seed rows belonging to the partition left open by the previous
    batch: carry_rn = its last row_number, carry_rank = the rank of its open
    peer group, carry_dense = its last dense_rank."""
    n = len(part_start)
    idx = np.arange(n, dtype=np.int64)
    psi = seg_start_index(part_start)
    rn = np.where(psi >= 0, idx - psi + 1, idx + 1 + carry_rn)
    ppi = seg_start_index(new_peer)
    rank = np.where(ppi >= 0, rn[np.clip(ppi, 0, None)], carry_rank)
    c = np.cumsum(new_peer.astype(np.int64))
    base = np.where(psi >= 0, c[np.clip(psi, 0, None)] - 1,
                    np.int64(-carry_dense))
    dense = c - base
    return rn, rank, dense
