"""Whole-batch device kernels for the batch plumbing hot path.

Each is a hand-written CUDA kernel with a plain PyTorch twin in this
module: a tensor on the CPU takes the plain version, a CUDA tensor
launches the kernel or raises.

- K1 ``compact_planes`` (csrc/compact.cu): FilterExec's stable compaction.
- K5 ``sort_key_operands`` + ``lexsort_indices`` (csrc/sort.cu): the sort
  keys' (rank, value) operands and a stable LSD radix sort over them, one
  launch and no host sync; ``partition_order`` sorts partition ids.
- K6 ``gather_planes`` (csrc/gather.cu): ``ColumnarBatch.take``.
- K7 ``slice_planes`` / ``concat_planes`` / ``split_planes``
  (csrc/gather.cu): ``ColumnarBatch.slice`` and ``.concat``, and the
  exchange's bucketize split of a batch by the partition order.
- K8 ``inner_join_planes`` (csrc/join.cu): the unique-key inner
  broadcast join of one probe batch (probe, stable compaction, gathers
  of both sides, the padding) in one launch for up to 128 planes, its
  argument words packed once a build map (``JoinPack``); the join key's
  canonical word is ops/joins/keymap.py's ``canon_words``.
- K9 ``probe_codes`` (csrc/join.cu): the generic join probe, each probe
  key's code in the build map or -1.
- K11 ``fused_chain`` (exprs/fused_triton.py, generated Triton): one
  fused chain segment of project / filter / rename / expand steps over a
  batch, each filtered output group compacted by the same launch (the
  stacked form: K1 once per filtered group and batch).
- K18 ``fused_agg_input`` (exprs/fused_triton.py, generated Triton): a
  fused partial aggregate's input (its joins' probes and gathers, steps,
  predicates, keys and arguments) over a batch, with a live mask.
- K13 ``segment_scan`` (csrc/seg_scan.cu): the window aggregates'
  segmented (sum, count) prefix scan with a carry, in XLA's float order.
- K14 ``range_partition_ids`` (csrc/range_part.cu): the range exchange's
  partition ids, a binary search of each row's normalised key tuple over
  the sorted bound rows; ``range_partition_order`` sorts rows by them.
- K19 ``passthrough_states`` (csrc/passthrough.cu): a skipped partial
  aggregate's batch as one singleton state a row (the slot program with
  the slot equal to the row).

The slot-code helpers of the aggregation are plain PyTorch twins of the
JAX package's (the slot kernels K3/K4 are in ops/agg_device.py), and the
window counters and the window's numpy scans (decimals, MIN/MAX) are host
numpy, as they are in the JAX package.
"""

from __future__ import annotations

import struct
import threading
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


_WORDS = threading.local()


def _words(values: Sequence[int]):
    """The argument words of one launch, in this thread's reused ctypes
    buffer (the exported function reads them before it returns)."""
    buf = getattr(_WORDS, "buf", None)
    if buf is None or len(buf) < len(values):
        buf = _WORDS.buf = (cuda_lib.ctypes.c_longlong * max(256, len(values)))()
    buf[:len(values)] = values
    return buf


def _alloc_planes(dtypes: Sequence[torch.dtype], rows: int, device: torch.device):
    """Planes of ``rows`` rows of each dtype: the planes of one dtype are
    the rows of one 2-d allocation, each at a 16-byte boundary (one
    allocation and one ``unbind`` a dtype cost less host time than a
    ``torch.empty`` a plane, or than views of one allocation for every
    dtype). Returns (planes, their addresses)."""
    groups = {}
    for i, dt in enumerate(dtypes):
        groups.setdefault(dt, []).append(i)
    outs, ptrs = [None] * len(dtypes), [0] * len(dtypes)
    for dt, ix in groups.items():
        size = dt.itemsize
        stride = (rows * size + 15) // 16 * 16 // size
        block = torch.empty((len(ix), stride), dtype=dt, device=device)
        if stride != rows:
            block = block[:, :rows]
        base, step = block.data_ptr(), stride * size
        for j, (i, plane) in enumerate(zip(ix, block.unbind(0))):
            outs[i], ptrs[i] = plane, base + j * step
    return outs, ptrs


def gather_planes_cuda(datas: Sequence[torch.Tensor],
                       valids: Sequence[torch.Tensor], idx: torch.Tensor,
                       out_cap: int, n_out: int,
                       live: Optional[torch.Tensor] = None):
    """K6 on the card (csrc/gather.cu): same contract as
    :func:`gather_planes_plain`, one launch for every 32 planes. A plane
    passed more than once (a wide column's validity, once a limb) is
    gathered once and its output returned for each. The output planes of
    one dtype are views of one allocation; the plane table goes to the
    library in a reused word buffer."""
    given = [*datas, *valids]
    planes = list({id(p): p for p in given}.values())
    cuda_lib.require_cuda("gather_planes", idx, *planes, *([live] if live is not None else []))
    if idx.dtype != torch.int64 or idx.dim() != 1 or idx.shape[0] < n_out:
        raise ValueError(f"gather_planes: index {idx.dtype} of shape "
                         f"{tuple(idx.shape)} for {n_out} rows")
    if live is not None and (live.dtype != torch.bool or live.shape[0] < n_out):
        raise ValueError("gather_planes: live mask must be bool, n_out rows")
    if not 0 <= n_out <= out_cap:
        raise ValueError(f"gather_planes: {n_out} rows into {out_cap}")
    if not planes:
        return [], []
    words = [n_out, out_cap, idx.data_ptr(), live.data_ptr() if live is not None else 0,
             cuda_lib.stream_handle(idx.get_device()), len(planes)]
    for p in planes:
        size = p.element_size()
        if p.dim() != 1 or size not in (1, 2, 4, 8):
            _check_planes("gather_planes", [p])
        words += (p.data_ptr(), 0, p.shape[0], size)
    outs, words[7::4] = _alloc_planes([p.dtype for p in planes], out_cap, idx.device)
    err = cuda_lib.library().blz_gather_planes(_words(words))
    cuda_lib.check(err, "gather_planes")
    cuda_lib.LAUNCHES["gather_planes"] += 1
    out_of = {id(p): o for p, o in zip(planes, outs)}
    outs = [out_of[id(p)] for p in given]
    k = len(datas)
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


# csrc/gather.cu: the by-value table of the slice/concat kernel
_CAT_MAX_SRC, _CAT_MAX_PLANES, _CAT_MAX_REFS = 8, 32, 128
# csrc/gather.cu: partitions and output planes of the split's by-value table
_SPLIT_MAX_PARTS, _SPLIT_MAX_DSTS = 64, 256
_PLL = cuda_lib.ctypes.POINTER(cuda_lib.ctypes.c_longlong)


def _rows_of_sources(name: str, per_plane: List[List[torch.Tensor]],
                     counts: Sequence[int], starts: Sequence[int], out_cap: int):
    """K7 on the card: output row r of the k sources (source b holds
    counts[b] rows from starts[b]) in one launch; rows past the total are
    padding. The table goes by value, or through the library's pinned
    buffer when it is too large. Each output plane is its own allocation,
    so a consumer that keeps one plane frees the others."""
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
    outs = [torch.empty(out_cap, dtype=parts[0].dtype, device=dev) for parts in per_plane]
    np_ = len(per_plane)
    prefix = np.zeros(k + 1, dtype=np.int64)
    np.cumsum(counts, out=prefix[1:])
    words = np.concatenate([
        np.array([k, np_, out_cap], dtype=np.int64), prefix,
        np.asarray(starts, dtype=np.int64),
        np.array([o.data_ptr() for o in outs], dtype=np.uint64).view(np.int64),
        np.array([o.element_size() for o in outs], dtype=np.int64),
        np.array([t.data_ptr() for t in flat], dtype=np.uint64).view(np.int64),
        np.array([t.shape[0] for t in flat], dtype=np.int64)])
    staged = None
    if k > _CAT_MAX_SRC or np_ > _CAT_MAX_PLANES or np_ * k > _CAT_MAX_REFS:
        staged = torch.empty(len(words) - 3, dtype=torch.int64, device=dev)
    err = cuda_lib.library().blz_concat_planes(
        words.ctypes.data_as(_PLL), staged.data_ptr() if staged is not None else None,
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


def split_planes_plain(datas: Sequence[torch.Tensor], valids: Sequence[torch.Tensor],
                       order: torch.Tensor, counts: Sequence[int], caps: Sequence[int]):
    """The exchange's bucketize split: partition p's rows are
    ``order[pre[p]:pre[p] + counts[p]]`` (pre = exclusive sum of the
    counts), gathered into ``caps[p]``-row planes, padding past its count;
    None for an empty partition. Plain twin of K7's split form, the same
    function as blaze_tpu/core/kernels.py:_gather_n by the order followed
    by a _dyn_slice per partition."""
    out, pre = [], 0
    for c, cap in zip(counts, caps):
        out.append(gather_planes_plain(datas, valids, order[pre:pre + c], cap, c)
                   if c else None)
        pre += c
    return out


def split_planes_cuda(datas: Sequence[torch.Tensor], valids: Sequence[torch.Tensor],
                      order: torch.Tensor, counts: Sequence[int], caps: Sequence[int]):
    """K7's split form on the card (csrc/gather.cu ``blz_split_planes``):
    same result as :func:`split_planes_plain`, every partition and plane
    in one launch (32 planes a launch). Each output plane is its own
    allocation, as a take's and a slice's are."""
    planes = list(datas) + list(valids)
    cuda_lib.require_cuda("split_planes", order, *planes)
    _check_planes("split_planes", planes)
    counts, caps = [int(c) for c in counts], [int(c) for c in caps]
    if order.dtype != torch.int64 or order.dim() != 1 or \
            order.shape[0] < sum(counts) or len(caps) != len(counts) or \
            any(c < 0 or c > cap for c, cap in zip(counts, caps)):
        raise ValueError(f"split_planes: {counts} rows into {caps} by an order of "
                         f"{tuple(order.shape)} {order.dtype}")
    dev = order.device
    k = len(datas)
    live = [p for p, c in enumerate(counts) if c]
    out = [None] * len(counts)
    if not live or not planes:
        for p in live:
            out[p] = ([], [])
        return out
    dsts = []
    for p in live:
        outs = [torch.empty(caps[p], dtype=t.dtype, device=dev) for t in planes]
        dsts += [o.data_ptr() for o in outs]
        out[p] = (outs[:k], outs[k:])
    pre = np.zeros(len(counts) + 1, dtype=np.int64)
    np.cumsum(counts, out=pre[1:])
    rowpre = np.zeros(len(live) + 1, dtype=np.int64)
    np.cumsum([caps[p] for p in live], out=rowpre[1:])
    plane_words = np.array([[t.data_ptr(), t.shape[0], t.element_size()] for t in planes],
                           dtype=np.uint64).view(np.int64)
    words = np.concatenate([
        np.array([len(planes), len(live), order.data_ptr()], dtype=np.uint64).view(np.int64),
        plane_words.reshape(-1), rowpre, pre[live], pre[live[-1] + 1:live[-1] + 2],
        np.array(dsts, dtype=np.uint64).view(np.int64)])
    staged = None
    if len(live) > _SPLIT_MAX_PARTS or len(live) * len(planes) > _SPLIT_MAX_DSTS:
        staged = torch.empty(2 * len(live) + 2 + len(dsts), dtype=torch.int64, device=dev)
    err = cuda_lib.library().blz_split_planes(
        words.ctypes.data_as(_PLL), staged.data_ptr() if staged is not None else None,
        cuda_lib.stream_of(dev))
    cuda_lib.check(err, "split_planes")
    cuda_lib.LAUNCHES["split_planes"] += 1
    return out


def split_planes(datas: Sequence[torch.Tensor], valids: Sequence[torch.Tensor],
                 order: torch.Tensor, counts: Sequence[int], caps: Sequence[int]):
    """``Repartitioner.bucketize``'s split of a batch's planes by the
    partition order: K7's split form on a CUDA order, the plain version on
    a CPU one. Returns per partition (datas, valids), None where empty."""
    fn = split_planes_cuda if order.is_cuda else split_planes_plain
    return fn(datas, valids, order, counts, caps)


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


# csrc/compact.cu blz_compact_planes' argument words: n, mask, scratch, its
# tiles, tag, count, stream, planes, the ends of the 8-, 4-, 2- and 1-byte
# planes, the table in device memory (_CW_TABLE; 0: by value), three
# unused, then (src, dst) a plane in that order of sizes
_CW_TABLE = 12
# csrc/compact.cu: rows a tile, planes by value
_COMPACT_TILE, _COMPACT_MAX_PLANES = 1024, 128
_COMPACT_TAGS = (1 << 30) - 1
# per device: [the scratch (the tickets' counter, then a look-back word a
# tile; zeroed once, grown with the rows), the last launch's tag]
_COMPACT_STATE = {}
_COMPACT_LOCK = threading.Lock()


def _compact_state(index: int, tiles: int) -> Tuple[torch.Tensor, int]:
    """K1's scratch on device ``index`` and the next launch's tag: the
    kernel resets its counter and tags its words, so the scratch is never
    zeroed again. The launches of one device go in stream order."""
    with _COMPACT_LOCK:
        state = _COMPACT_STATE.get(index)
        if state is None or state[0].shape[0] < 1 + tiles:
            state = _COMPACT_STATE[index] = [
                torch.zeros(1 + tiles, dtype=torch.int64, device=torch.device("cuda", index)),
                0 if state is None else state[1]]
        state[1] = state[1] % _COMPACT_TAGS + 1
        return state[0], state[1]


def compact_planes_cuda(datas: Sequence[torch.Tensor],
                        valids: Sequence[torch.Tensor], mask: torch.Tensor):
    """K1 on the card (csrc/compact.cu): same contract as
    :func:`compact_planes_plain`, one launch a call. The outputs of one
    dtype are 16-byte aligned rows of one allocation (as ``_alloc_planes``
    lays them out), made in the same pass that groups the planes by
    element size for the kernel; the argument words go in a reused buffer
    (past 128 planes the plane table goes in device memory)."""
    planes = [*datas, *valids]
    cuda_lib.require_cuda("compact_planes", mask)
    n = mask.shape[0]
    if mask.dtype != torch.bool or mask.dim() != 1:
        raise TypeError(f"compact_planes: mask {mask.dtype}{tuple(mask.shape)}, expected "
                        "a bool plane")
    if not 0 < n < 2 ** 31:
        raise ValueError(f"compact_planes: {n} rows (1 to 2^31 - 1)")
    dev, index = mask.device, mask.get_device()
    groups = {}
    for i, p in enumerate(planes):
        if p.shape != (n,) or not p.is_cuda or p.get_device() != index or \
                not p.is_contiguous():
            cuda_lib.require_cuda("compact_planes", mask, p)
            raise ValueError(f"compact_planes: plane shape {tuple(p.shape)}, expected ({n},)")
        groups.setdefault(p.dtype, []).append(i)
    outs = [None] * len(planes)
    by_size = {8: [], 4: [], 2: [], 1: []}
    for dt, ix in groups.items():
        size = dt.itemsize
        pairs = by_size.get(size)
        if pairs is None:
            raise TypeError(f"compact_planes: element size {size}")
        stride = (n * size + 15) // 16 * 16 // size
        block = torch.empty((len(ix), stride), dtype=dt, device=dev)
        if stride != n:
            block = block[:, :n]
        base, step = block.data_ptr(), stride * size
        for j, (i, out) in enumerate(zip(ix, block.unbind(0))):
            outs[i] = out
            pairs += (planes[i].data_ptr(), base + j * step)
    count = torch.empty((), dtype=torch.int64, device=dev)
    scratch, tag = _compact_state(index, -(-n // _COMPACT_TILE))
    e8 = len(by_size[8]) >> 1
    e4 = e8 + (len(by_size[4]) >> 1)
    e2 = e4 + (len(by_size[2]) >> 1)
    pairs = by_size[8] + by_size[4] + by_size[2] + by_size[1]
    words = [n, mask.data_ptr(), scratch.data_ptr(), scratch.shape[0] - 1, tag,
             count.data_ptr(), cuda_lib.stream_handle(index), len(planes), e8, e4, e2,
             len(planes), 0, 0, 0, 0]
    table = None
    if len(planes) > _COMPACT_MAX_PLANES:
        table = torch.tensor(pairs, dtype=torch.int64).to(dev)
        words[_CW_TABLE] = table.data_ptr()
    else:
        words += pairs
    err = cuda_lib.library().blz_compact_planes(_words(words))
    cuda_lib.check(err, "compact_planes")
    cuda_lib.LAUNCHES["compact_planes"] += 1
    k = len(datas)
    return count, outs[:k], outs[k:]


def compact_planes(datas: Sequence[torch.Tensor], valids: Sequence[torch.Tensor],
                   mask: torch.Tensor):
    """Stable compaction of rows where ``mask`` holds (FilterExec hot path):
    K1 on a CUDA tensor, the plain version on a CPU tensor. Returns
    (count: int, datas, valids); the count is the one host sync."""
    fn = compact_planes_cuda if mask.is_cuda else compact_planes_plain
    count, out_d, out_v = fn(datas, valids, mask)
    return int(count), out_d, out_v


# -- K11: a fused chain segment -------------------------------------------------


def _fused_step_groups(in_schema, steps, datas, valids, live):
    """The output groups of a fused chain's steps over planes whose live
    rows are ``live``: per group (columns, live mask, filtered).
    Expressions evaluate with ExprEvaluator over a LiveBatch; filters only
    narrow the mask."""
    from blaze_tpu_torch.core.batch import DeviceColumn
    from blaze_tpu_torch.exprs.compiler import ExprEvaluator, LiveBatch, \
        fused_chain_schemas

    schemas = fused_chain_schemas(in_schema, steps)
    cols = [DeviceColumn(f.dtype, d, v) for f, d, v in zip(in_schema.fields, datas, valids)]
    groups = [(cols, live, False)]
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
    return groups


def _compact_groups(groups, num_rows: int, rows=slice(None)):
    """(groups, counts) of one batch, the rows ``rows`` of every group's
    planes: a filtered group compacted once with K1's plain version."""
    outs, counts = [], []
    for cols, live, filtered in groups:
        ds = tuple(c.data[rows] for c in cols)
        vs = tuple(c.validity[rows] for c in cols)
        if filtered:
            count, ds, vs = compact_planes_plain(ds, vs, live[rows])
            ds, vs, count = tuple(ds), tuple(vs), int(count)
        else:
            count = num_rows
        outs.append((ds, vs))
        counts.append(count)
    return tuple(outs), tuple(counts)


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
    ``counts[g]`` its row count (an int; ``num_rows`` for an unfiltered
    group)."""
    live = iota(int(datas[0].shape[0]), datas[0].device) < num_rows
    return _compact_groups(_fused_step_groups(in_schema, steps, datas, valids, live), num_rows)


def fused_chain_stacked_plain(in_schema, steps, batch_datas, batch_valids,
                              batch_nrows: Sequence[int]):
    """Plain PyTorch twin of the stacked K11: k same-shape batches (per
    batch its planes, each of one capacity, and its row count) as one
    stack: every expression evaluated once over the k * capacity rows, the
    live mask each batch's rows below its count, then each filtered group
    compacted per batch (K1's plain version). Returns per batch exactly
    what :func:`fused_chain_plain` returns for it."""
    cap = int(batch_datas[0][0].shape[0])
    dev = batch_datas[0][0].device
    ncols = len(in_schema.fields)
    groups = _fused_step_groups(
        in_schema, steps, [torch.cat([bd[i] for bd in batch_datas]) for i in range(ncols)],
        [torch.cat([bv[i] for bv in batch_valids]) for i in range(ncols)],
        torch.cat([iota(cap, dev) < int(nr) for nr in batch_nrows]))
    return [_compact_groups(groups, int(nr), slice(b * cap, (b + 1) * cap))
            for b, nr in enumerate(batch_nrows)]


def fused_chain(in_schema, steps, datas: Sequence[torch.Tensor],
                valids: Sequence[torch.Tensor], num_rows: int, kernel=None):
    """One fused chain segment over a batch's planes: K11 (one launch,
    its filtered groups compacted in it) on CUDA planes, the plain version
    on CPU planes. ``kernel`` is the segment's cached
    ``exprs.fused_triton.FusedKernel``, made here when not given. Returns
    (groups, counts) as :func:`fused_chain_plain` does; on the card the
    filtered groups' counts come to the host in one sync."""
    if datas[0].is_cuda:
        from blaze_tpu_torch.exprs.fused_triton import FusedKernel, fused_chain_cuda

        kernel = kernel or FusedKernel(in_schema, steps)
        groups, counts = fused_chain_cuda(kernel, datas, valids, num_rows)
        synced = iter(counts.tolist() if kernel.gen.filtered else ())
        return groups, tuple(num_rows if mask is None else next(synced)
                             for _d, _v, mask in kernel.gen.groups)
    return fused_chain_plain(in_schema, steps, datas, valids, num_rows)


def fused_chain_stacked(in_schema, steps, batch_datas, batch_valids,
                        batch_nrows: Sequence[int], kernel=None):
    """One fused chain segment over k same-shape batches: the stacked K11
    (with K1 per filtered group per batch) on CUDA planes, the plain
    version on CPU planes. Returns per batch (groups, counts) as
    :func:`fused_chain` does; on the card every batch's counts come to the
    host in one sync."""
    if batch_datas[0][0].is_cuda:
        from blaze_tpu_torch.exprs.fused_triton import FusedKernel, fused_chain_stacked_cuda

        kernel = kernel or FusedKernel(in_schema, steps)
        return fused_chain_stacked_cuda(kernel, batch_datas, batch_valids, batch_nrows)
    return fused_chain_stacked_plain(in_schema, steps, batch_datas, batch_valids, batch_nrows)


# -- K18: the fused aggregate input ------------------------------------------------


def fused_agg_input_plain(spec, columns, num_rows: int, joins):
    """Plain PyTorch twin of K18, the prologue of the JAX package's fused
    partial aggregate (blaze_tpu/ops/agg_device.py:518 _trace_tb_mask with
    :245 FusedJoinSpec.trace_join, exprs/compiler.py:1110
    trace_fused_steps, and the keys and arguments of :411 _flow) for
    ``spec`` (exprs/fused_triton.py FusedAggSpec) over one batch's
    ``columns``. ``joins``: per fused join, inner-first, (the build's
    sorted unique words, length max(nk, 1); nk; its build columns, code c
    at row c; and for K18 its ops/joins/keymap.JoinRank, which the twin
    does not read). Each join probes with ops/joins/keymap.py sorted_probe (the
    key valid on a row below num_rows), gathers every build column at the
    clipped rank, valid on a hit, and narrows the live mask (the rows below
    num_rows) by the hit; the steps run as K11's plain version runs them,
    over a LiveBatch; the predicates narrow the mask; keys and arguments
    evaluate over the aggregate's child schema. Returns (keys, args, live):
    per key (data, valid & live), per argument (data, valid & live), for a
    wide-decimal argument (its limb planes, valid & live), for COUNT(*)
    None."""
    from blaze_tpu_torch.core.batch import DeviceColumn
    from blaze_tpu_torch.exprs.compiler import ExprEvaluator, LiveBatch, broadcast
    from blaze_tpu_torch.ops.joins.keymap import sorted_probe

    cap = int(columns[0].capacity)
    dev = columns[0].validity.device
    inrow = iota(cap, dev) < num_rows
    live = inrow
    cols = list(columns)
    for js, (uniq, nk, bcols, *_rank) in zip(spec.joins, joins):
        batch = LiveBatch(js.probe_schema, cols, live)
        kd, kv = broadcast(ExprEvaluator([js.key_expr], js.probe_schema)
                           .eval(js.key_expr, batch), batch)
        cidx, hit = sorted_probe(uniq, kd, kv & inrow, nk)
        gathered = [DeviceColumn(c.dtype, c.data[cidx], c.validity[cidx] & hit)
                    for c in bcols]
        cols = cols + gathered if js.probe_on_left else gathered + cols
        live = live & hit
    if spec.steps:
        (cols, live, _), = _fused_step_groups(
            spec.input_schema, spec.steps, [c.data for c in cols],
            [c.validity for c in cols], live)
    schema = spec.child_schema
    if spec.predicates:
        live = ExprEvaluator(list(spec.predicates), schema).evaluate_predicate(
            LiveBatch(schema, cols, live))
    batch = LiveBatch(schema, cols, live)

    def plane(e):
        ev = ExprEvaluator([e], schema)
        d, v = broadcast(ev.eval(e, batch), batch)
        return d, v & live

    keys = [plane(e) for e in spec.groupings]
    args = [None if e is None else plane(e) for e in spec.args]
    return keys, args, live


def fused_agg_input(spec, columns, num_rows: int, joins, kernel=None):
    """The fused aggregate input of one batch: K18 on a CUDA batch (its
    cached ``exprs.fused_triton.FusedAggKernel``, made here when not
    given), the plain version on a CPU one. Same (keys, args, live) as
    :func:`fused_agg_input_plain`."""
    if columns[0].validity.is_cuda:
        from blaze_tpu_torch.exprs.fused_triton import fused_agg_input_cuda, fused_agg_kernel

        return fused_agg_input_cuda(kernel or fused_agg_kernel(spec), columns, num_rows,
                                    joins)
    return fused_agg_input_plain(spec, columns, num_rows, joins)


# -- K8: the unique-key inner join -------------------------------------------------

_JOIN_KEY_INT, _JOIN_KEY_FLOAT = 0, 1


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
    from blaze_tpu_torch.ops.joins.keymap import sorted_probe  # keymap imports this module

    cap_p = key_data.shape[0]
    dev = key_data.device
    cidx, hit = sorted_probe(uniq, key_data, key_valid & (iota(cap_p, dev) < num_rows), nk)
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


# csrc/join.cu blz_inner_join's argument words: the header, then (src, dst,
# size) a plane from _JW_PLANES
(_JW_NK, _JW_LO, _JW_HI, _JW_DENSE, _JW_TOP, _JW_STEP, _JW_UNIQ, _JW_KEY, _JW_KSIZE,
 _JW_KKIND, _JW_KVALID, _JW_ROWS, _JW_CAP_P, _JW_CAP_B, _JW_SCRATCH, _JW_TILES, _JW_TAG,
 _JW_COUNT, _JW_STREAM, _JW_NPROBE, _JW_NPLANES) = range(21)
_JW_PLANES = 24
# csrc/join.cu: rows a tile, words of the staged search top, planes a launch
_JOIN_TILE, _JOIN_TOP, _JOIN_MAX_PLANES = 1024, 4096, 128
_JOIN_TAGS = (1 << 30) - 1


class JoinPack:
    """K8's argument words for one build map on one device, packed once:
    ``uniq`` the sorted unique words on the device (length max(nk, 1)),
    ``words`` the same words on the host (nk of them), from which the
    search is decided here: the dense route when they are one run of
    consecutive integers (``ops/joins/keymap.dense_key_words``; ``search``
    forces the staged-top search), else the staged top's size and step.
    The build planes' pointers and sizes are packed with them, anew only
    when the probe's capacity or plane types change. A join of up to 128
    planes (probe and build) is one launch; a wider one is a launch for
    each 128 planes, each a whole pass over the batch (probe, look-back,
    its planes' scatter and padding). Each probe batch checks its planes
    and writes their pointers, those of the outputs it allocates and the
    count's into the words in place. The pack also keeps the kernel's
    scratch (the tickets' counter, then a look-back word a tile), grown
    with the capacity and never zeroed: each launch tags its words anew.
    One pack serves one build map; its launches go in stream order."""

    def __init__(self, uniq: torch.Tensor, words: np.ndarray,
                 build_datas: Sequence[torch.Tensor], build_valids: Sequence[torch.Tensor],
                 search: bool = False):
        from blaze_tpu_torch.ops.joins.keymap import dense_key_words  # imports this module

        name = "inner_join_planes"
        build = list(build_datas) + list(build_valids)
        cuda_lib.require_cuda(name, uniq, *build)
        nk = len(words)
        if uniq.dtype != torch.int64 or uniq.shape != (max(nk, 1),):
            raise ValueError(f"{name}: sorted keys {uniq.dtype} of shape "
                             f"{tuple(uniq.shape)} for {nk} keys")
        if not build_datas:
            raise ValueError(f"{name}: the build side has no planes")
        cap_b = int(build[0].shape[0])
        if any(p.shape != (cap_b,) for p in build) or cap_b >= 2 ** 31:
            raise ValueError(f"{name}: build planes need one capacity below 2^31 "
                             f"(got {cap_b})")
        _check_planes(name, build)
        self.uniq, self.nk, self.cap_b = uniq, nk, cap_b
        self.build, self.nbuild_datas = build, len(build_datas)
        self.dense = not search and dense_key_words(words)
        self.lo = int(words[0]) if self.dense else 0
        self.device, self.index = uniq.device, uniq.get_device()
        self.sig = None
        self.words = []
        self.out_dtypes = ()
        self.scratch = None
        self.tag = 0

    def _pack(self, sig, key_data: torch.Tensor, probe: Sequence[torch.Tensor]) -> None:
        """One word array a launch, each over its group of at most 128 of
        the planes (probe planes first, then the build's)."""
        _check_planes("inner_join_planes", probe)
        cap_p, nprobe = sig[0], len(probe)
        planes = list(probe) + self.build
        step = max(1, -(-self.nk // _JOIN_TOP))
        tiles = -(-cap_p // _JOIN_TILE)
        if self.scratch is None or self.scratch.shape[0] < 1 + tiles:
            self.scratch = torch.zeros(1 + tiles, dtype=torch.int64, device=self.device)
        self.words = []
        for g0 in range(0, len(planes), _JOIN_MAX_PLANES):
            group = planes[g0:g0 + _JOIN_MAX_PLANES]
            w = (cuda_lib.ctypes.c_longlong * (_JW_PLANES + 3 * len(group)))()
            w[_JW_NK], w[_JW_LO], w[_JW_HI] = self.nk, self.lo, self.lo + self.nk - 1
            w[_JW_DENSE], w[_JW_TOP], w[_JW_STEP] = int(self.dense), \
                max(1, -(-self.nk // step)), step
            w[_JW_UNIQ], w[_JW_KSIZE], w[_JW_KKIND] = self.uniq.data_ptr(), \
                key_data.element_size(), _join_key_kind(key_data)
            w[_JW_CAP_P], w[_JW_CAP_B] = cap_p, self.cap_b
            w[_JW_SCRATCH], w[_JW_TILES] = self.scratch.data_ptr(), self.scratch.shape[0] - 1
            w[_JW_NPROBE] = min(max(nprobe - g0, 0), len(group))
            w[_JW_NPLANES] = len(group)
            for j, p in enumerate(group):
                w[_JW_PLANES + 3 * j + 2] = p.element_size()
                if g0 + j >= nprobe:
                    w[_JW_PLANES + 3 * j] = p.data_ptr()
            self.words.append((g0, w))
        self.sig = sig
        self.out_dtypes = [p.dtype for p in planes]

    def _row(self, p: torch.Tensor, cap: int, dtype) -> int:
        """A probe plane's pointer, after its check."""
        if p.dtype is not dtype or p.numel() != cap or p.dim() != 1 or \
                p.get_device() != self.index or not p.is_contiguous():
            raise ValueError(f"inner_join_planes: a probe plane of {p.dtype}{tuple(p.shape)} "
                             f"on {p.device}, expected {dtype} ({cap},) on {self.device}")
        return p.data_ptr()

    def bind(self, num_rows: int, key_data: torch.Tensor, key_valid: torch.Tensor,
             probe: Sequence[torch.Tensor]):
        """Pack the probe's signature if it is not the packed one, check the
        batch's planes, allocate the outputs and the count and write every
        pointer and each launch's tag; returns (outputs, count, the word
        arrays to launch)."""
        cap_p = int(key_data.shape[0])
        sig = (cap_p, key_data.dtype, tuple(p.dtype for p in probe))
        if sig != self.sig:
            self._pack(sig, key_data, probe)
        if not 0 <= num_rows <= cap_p or cap_p == 0:
            raise ValueError(f"inner_join_planes: {num_rows} rows of {cap_p}")
        row, dev = self._row, self.device
        key, kvalid = row(key_data, cap_p, key_data.dtype), row(key_valid, cap_p, torch.bool)
        srcs = [row(p, cap_p, dt) for p, dt in zip(probe, sig[2])]
        outs = [torch.empty(cap_p, dtype=dt, device=dev) for dt in self.out_dtypes]
        count = torch.empty(1, dtype=torch.int64, device=dev)
        stream = cuda_lib.stream_handle(self.index)
        launches = []
        for g0, w in self.words:
            w[_JW_ROWS], w[_JW_KEY], w[_JW_KVALID] = num_rows, key, kvalid
            w[_JW_COUNT], w[_JW_STREAM] = count.data_ptr(), stream
            for j in range(w[_JW_NPLANES]):
                if g0 + j < len(srcs):
                    w[_JW_PLANES + 3 * j] = srcs[g0 + j]
                w[_JW_PLANES + 3 * j + 1] = outs[g0 + j].data_ptr()
            self.tag = self.tag % _JOIN_TAGS + 1
            w[_JW_TAG] = self.tag
            launches.append(w)
        return outs, count, launches


def inner_join_planes_cuda(pack: JoinPack, num_rows: int, key_data: torch.Tensor,
                           key_valid: torch.Tensor, probe_datas: Sequence[torch.Tensor],
                           probe_valids: Sequence[torch.Tensor]):
    """K8 on the card (csrc/join.cu): the contract of
    :func:`inner_join_planes_plain` for the build map that ``pack`` holds
    (its sorted words and build planes), one launch for up to 128 planes."""
    probe = list(probe_datas) + list(probe_valids)
    outs, count, launches = pack.bind(num_rows, key_data, key_valid, probe)
    lib = cuda_lib.library()
    for w in launches:
        cuda_lib.check(lib.blz_inner_join(w), "inner_join_planes")
        cuda_lib.LAUNCHES["inner_join_planes"] += 1
    a, b, c = len(probe_datas), len(probe), len(probe) + pack.nbuild_datas
    return count[0], outs[:a], outs[a:b], outs[b:c], outs[c:]


# -- K9: the generic join probe ----------------------------------------------------


def probe_codes_plain(uniq: torch.Tensor, nk: int, key_data: torch.Tensor,
                      key_valid: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of K9, the same function as
    blaze_tpu/ops/joins/keymap.py:_probe_fn: each row's rank
    clip(searchsorted(uniq, w), 0, nk - 1) where its key is valid and its
    canonical word w is in uniq[0, nk), else -1. ``uniq`` holds the
    build's sorted unique words (length max(nk, 1)); the codes are an
    int64 plane of the key's capacity."""
    from blaze_tpu_torch.ops.joins.keymap import sorted_probe  # keymap imports this module

    cidx, hit = sorted_probe(uniq, key_data, key_valid, nk)
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
# csrc/sort.cu's rank of a padding (or dead) row in the key pass's rank plane
RANK_DEAD = 6


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


def _key_kind(dtype: torch.dtype) -> int:
    if dtype in (torch.float32, torch.float64):
        return _KEY_FLOAT
    if dtype == torch.bool:
        return _KEY_BOOL
    if dtype in (torch.int8, torch.int16, torch.int32, torch.int64):
        return _KEY_INT
    raise TypeError(f"sort_key_operands: sort key of dtype {dtype}")


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
    kinds = [_key_kind(d.dtype) for d in datas]
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


def _sort_words(op: torch.Tensor) -> torch.Tensor:
    """csrc/sort.cu ``blz_sort_word`` as int64 (the uint64 word's bits):
    the order-preserving word of each value of ``op``."""
    size = op.element_size()
    if op.dtype in (torch.uint8, torch.bool):
        return op.to(torch.int64)
    if op.dtype in (torch.float32, torch.float64):
        bits = op.view(torch.int64) if size == 8 else \
            op.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        sign = -(1 << 63) if size == 8 else 1 << 31
        full = -1 if size == 8 else 0xFFFFFFFF
        bits = torch.where(bits == sign, 0, bits)  # -0.0 sorts as +0.0
        w = torch.where((bits & sign) != 0, ~bits & full, bits | sign)
        return torch.where(torch.isnan(op), full, w)
    if size == 8:
        return op ^ -(1 << 63)
    return (op.to(torch.int64) & ((1 << (8 * size)) - 1)) ^ (1 << (8 * size - 1))


def radix_digits(sizes: Sequence[int], widths: Optional[Sequence[int]] = None
                 ) -> List[Tuple[int, int]]:
    """(operand, bit shift) of every 8-bit digit that may vary, least
    significant first: an operand's low ``widths[o]`` bytes (all of them
    by default). The digits above an operand's width are the same in
    every row (a pid below 256 is one byte, a rank plane one byte), so
    the caller's widths are what lets the sort skip them without reading
    the rows."""
    widths = list(sizes) if widths is None else list(widths)
    if len(widths) != len(sizes) or any(not 0 < w <= s for w, s in zip(widths, sizes)):
        raise ValueError(f"lexsort_indices: widths {widths} for operand sizes {list(sizes)}")
    return [(o, 8 * b) for o in reversed(range(len(sizes))) for b in range(widths[o])]


def radix_passes(and_or: np.ndarray, sizes: Sequence[int],
                 widths: Optional[Sequence[int]] = None) -> List[Tuple[int, int]]:
    """(operand, bit shift) of every 8-bit digit that is not the same in
    all rows, least significant first: K5's pass list, the digits of
    :func:`radix_digits` whose histogram has more than one bin. ``and_or``
    holds per operand the AND and the OR of its order-preserving words
    over the rows the passes sort."""
    passes = []
    for o, shift in radix_digits(sizes, widths):
        differ = int(and_or[2 * o]) ^ int(and_or[2 * o + 1])
        if (differ >> shift) & 0xFF:
            passes.append((o, shift))
    return passes


def lexsort_indices_plain(operands: List[torch.Tensor], num_rows: Optional[int] = None,
                          widths: Optional[Sequence[int]] = None,
                          dead_last: bool = False) -> torch.Tensor:
    """Indices that sort rows lexicographically by ``operands`` (first
    operand most significant), ties in row order; plain twin of K5's sort,
    by its algorithm: one stable pass per digit of :func:`radix_digits`
    that is not the same in every sorted row, least significant first.
    Only rows [0, num_rows) are sorted; the rows past them keep their
    place at the end, as padding rows (rank 6 in the first operand, every
    value 0) would in a sort of all rows. With ``dead_last`` the first
    operand is the key pass's rank plane: its rank-6 rows below num_rows
    (a fused aggregate's dead rows) go after the others in row order, as
    the sort of all rows puts them, and take no part in the passes."""
    n = operands[0].shape[0]
    m = n if num_rows is None else num_rows
    dev = operands[0].device
    if dead_last and operands[0].dtype != torch.uint8:
        raise TypeError("lexsort_indices: dead_last needs the rank plane first")
    digits = radix_digits([op.element_size() for op in operands], widths)
    words = [_sort_words(op[:m]) for op in operands]
    live = operands[0][:m] != RANK_DEAD if dead_last else \
        torch.ones(m, dtype=torch.bool, device=dev)
    nlive = int(live.sum())
    passes = []
    for o, shift in digits:
        b = (words[o][live] >> shift) & 0xFF
        if nlive and bool(b.min() != b.max()):
            passes.append((o, shift))
    if not passes and 0 < nlive < m:
        passes = digits[:1]  # the compaction of the dead rows alone
    idx = torch.arange(m, dtype=torch.int64, device=dev)
    for r, (o, shift) in enumerate(passes):
        if r == 0:
            key = torch.where(live, (words[o] >> shift) & 0xFF, 256)
            idx = idx[torch.sort(key.to(torch.int16), stable=True).indices]
        else:
            head = idx[:nlive]
            key = (words[o][head] >> shift) & 0xFF
            idx = torch.cat([head[torch.sort(key.to(torch.int16), stable=True).indices],
                             idx[nlive:]])
    if m < n:
        idx = torch.cat([idx, torch.arange(m, n, dtype=torch.int64, device=dev)])
    return idx


def _word_kind(t: torch.Tensor) -> int:
    if t.dtype in (torch.float32, torch.float64):
        return _WORD_FLOAT
    if t.dtype in (torch.int8, torch.int16, torch.int32, torch.int64):
        return _WORD_SIGNED
    if t.dtype in (torch.uint8, torch.bool):
        return _WORD_UNSIGNED
    raise TypeError(f"lexsort_indices: operand of dtype {t.dtype}")


def lexsort_indices_cuda(operands: List[torch.Tensor], num_rows: Optional[int] = None,
                         widths: Optional[Sequence[int]] = None, dead_last: bool = False,
                         hist: Optional[torch.Tensor] = None,
                         trace: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K5's stable LSD radix sort on the card (csrc/sort.cu), one launch
    and no device-to-host copy: the kernel chooses its digit passes from
    its own histograms. Same result as :func:`lexsort_indices_plain`.
    ``hist`` (256 int64 on the card): receives the histogram of the least
    significant digit of the last operand over the sorted rows (a one-byte
    pid's partition counts). ``trace`` (64 int64 on the card, measurement
    only): the %globaltimer ns at each phase boundary of the launch
    (csrc/sort.cu ``blz_rs_stamp``)."""
    cuda_lib.require_cuda("lexsort_indices", *operands, *([hist] if hist is not None else []))
    n = int(operands[0].shape[0])
    m = n if num_rows is None else int(num_rows)
    if not 0 < len(operands) <= 2 * _MAX_SORT_KEYS or not 0 <= m <= n or \
            m >= 2 ** 30 or any(op.shape != (n,) for op in operands):
        raise ValueError(f"lexsort_indices: {len(operands)} operands of "
                         f"{[tuple(o.shape) for o in operands]}, {m} rows")
    if dead_last and operands[0].dtype != torch.uint8:
        raise TypeError("lexsort_indices: dead_last needs the rank plane first")
    if hist is not None and (hist.dtype != torch.int64 or hist.shape != (256,)):
        raise ValueError("lexsort_indices: hist must be 256 int64")
    dev = operands[0].device
    out = torch.empty(n, dtype=torch.int64, device=dev)
    if n == 0:
        return out
    lib = cuda_lib.library()
    digits = radix_digits([op.element_size() for op in operands], widths)
    side = lib.blz_radix_sort_scratch(m, n, len(digits))
    scratch = torch.empty(side, dtype=torch.uint8, device=dev) if side else None
    idx_a = torch.empty(max(m, 1), dtype=torch.int32, device=dev)
    idx_b = torch.empty(max(m, 1), dtype=torch.int32, device=dev)
    bar = torch.empty(1, dtype=torch.int32, device=dev)
    words = [len(operands), m, n, int(dead_last), out.data_ptr(),
             hist.data_ptr() if hist is not None else 0,
             scratch.data_ptr() if scratch is not None else 0, len(digits),
             trace.data_ptr() if trace is not None else 0, idx_a.data_ptr(), idx_b.data_ptr(),
             bar.data_ptr()]
    for op in operands:
        words += [op.data_ptr(), op.element_size(), _word_kind(op)]
    for o, shift in digits:
        words += [o, shift]
    w = np.array(words, dtype=np.int64)
    err = lib.blz_radix_sort(w.ctypes.data_as(cuda_lib.ctypes.POINTER(cuda_lib.ctypes.c_longlong)),
                             cuda_lib.stream_of(dev))
    cuda_lib.check(err, "lexsort_indices")
    cuda_lib.LAUNCHES["lexsort_indices"] += 1
    return out


def lexsort_indices(operands: List[torch.Tensor], num_rows: Optional[int] = None,
                    widths: Optional[Sequence[int]] = None,
                    dead_last: bool = False) -> torch.Tensor:
    """The permutation that sorts rows [0, num_rows) by ``operands`` (ties
    in row order), rows past them after, in place: K5 on CUDA operands,
    the plain version on CPU ones. ``widths``: per operand the low bytes
    of its order-preserving word that may vary; ``dead_last``: the first
    operand is a rank plane whose rank-6 rows go last in row order."""
    fn = lexsort_indices_cuda if operands[0].is_cuda else lexsort_indices_plain
    return fn(operands, num_rows, widths, dead_last)


def pid_width(num_partitions: int) -> int:
    """Bytes of an int32 partition id below ``num_partitions`` that may
    vary in its sort word."""
    return max(1, (max(num_partitions - 1, 0).bit_length() + 7) // 8)


def partition_order(pids: torch.Tensor, num_partitions: int):
    """(order, counts): the stable order of the rows by their int32
    partition id (each below ``num_partitions``) and the rows of each
    partition as an int64 device tensor. On the card one K5 launch, whose
    histogram is the counts where an id is one byte (up to 256
    partitions); past that the counts are a ``bincount``."""
    width = pid_width(num_partitions)
    if not pids.is_cuda:
        order = lexsort_indices_plain([pids], None, [width])
        return order, torch.bincount(pids.to(torch.int64), minlength=num_partitions)
    if width == 1:
        hist = torch.empty(256, dtype=torch.int64, device=pids.device)
        order = lexsort_indices_cuda([pids], None, [1], hist=hist)
        return order, hist[:num_partitions]
    order = lexsort_indices_cuda([pids], None, [width])
    return order, torch.bincount(pids.to(torch.int64), minlength=num_partitions)


# -- K14: range-partition ids ------------------------------------------------------
#
# blaze_tpu/core/kernels.py _range_pids: a row's partition is the number of
# bound rows whose key tuple is <= the row's (bisect_right), both compared
# as K5's key pass normalises them: (u8 rank, value) per key, the value
# compared with < and == in its own dtype (so a -0.0 bound equals a 0.0
# row). The reference counts over a (rows x bounds) broadcast. K14 and its
# twin compare each key's (rank, int64 word) (``_range_words``: a float as
# its double's order-preserving integer, -0.0 as 0.0) against the bounds
# that ``range_bound_operands`` hands over in ascending order, laid out by
# ``range_bound_words`` as the nodes of the implicit search tree, level by
# level: the kernel counts the nodes <= a row (up to
# RANGE_COUNT_MAX_BOUNDS bounds) or, as the twin does, walks d =
# ceil(log2(B + 1)) levels down the tree. A count of bounds <= a row does
# not depend on their order, and over bounds in ascending order those
# bounds are a prefix, so all three agree on any bound set. Padding rows
# park at ``len(bounds) + 1``, past every partition.

# csrc/range_part.cu: the search tree's nodes staged in shared memory up to
# this many bytes (8-byte words and 1-byte ranks), read from global memory
# past it
RANGE_SMEM_BYTES = 48 << 10
# csrc/range_part.cu's routes: a count of the staged nodes <= each row, a
# search down the staged tree, a search down the tree in global memory
RANGE_COUNT, RANGE_SEARCH, RANGE_GLOBAL = 0, 1, 2
# the count's crossover: up to this many bounds every row counts them all
# (no branch; each node a shared-memory broadcast), past it the search's
# ceil(log2(B + 1)) levels cost less. On the H100 (chip_smoke.py
# kernel_k14's ``route_ms``, PERF.md row 12) the count wins at 3 bounds on
# hash_sample's store exchange, ties at 3 on sort10M's map batch and
# loses from 7 bounds on
RANGE_COUNT_MAX_BOUNDS = 3
# the rank of a node past the bounds: above every row's (0..4)
_RANK_PAST = 5
_I64_MIN = -(1 << 63)


def range_bound_operands(datas, valids, spec) -> List[torch.Tensor]:
    """The bound rows' key operands ([rank0, val0, ...], one row a bound,
    K5's key pass), sorted ascending (K5's sort): what K14 searches."""
    exists = torch.ones(datas[0].shape[0], dtype=torch.bool, device=datas[0].device)
    ops = sort_key_operands(datas, valids, exists, spec)
    if not exists.shape[0]:
        return ops
    order = lexsort_indices(ops)
    return [op[order] for op in ops]


def _range_words(op: torch.Tensor) -> torch.Tensor:
    """A key operand's values as the int64 words K14 compares: a float's
    double as its order-preserving integer (-0.0 as 0.0, then a negative
    value's magnitude bits flipped, so that signed order is the float's
    order and == is IEEE's ==; no operand is NaN: the rank holds it), an
    integer sign-extended, a bool's 0 / 1."""
    if not op.is_floating_point():
        return op.to(torch.int64)
    b = op.to(torch.float64).view(torch.int64)
    b = torch.where(b == _I64_MIN, 0, b)
    return torch.where(b < 0, b ^ 0x7FFFFFFFFFFFFFFF, b)


def _search_order(nb: int) -> List[int]:
    """The sorted bound each node of K14's search tree holds, level by
    level: node 2^L - 1 + p of level L holds bound p * 2^(d-L) +
    2^(d-1-L) - 1, d = ceil(log2(nb + 1)); 2^d - 1 nodes, those past the
    nb bounds are padding."""
    d = nb.bit_length()
    out = []
    for level in range(d):
        step = 1 << (d - 1 - level)
        out += [p * 2 * step + step - 1 for p in range(1 << level)]
    return out


def range_tree_staged(k: int, nb: int) -> bool:
    """Whether K14's search tree over ``nb`` bounds of ``k`` keys fits
    RANGE_SMEM_BYTES (9 bytes a key of each of its 2^d - 1 nodes)."""
    return k * ((1 << nb.bit_length()) - 1) * 9 <= RANGE_SMEM_BYTES


def range_bound_words(bound_ops) -> Tuple[torch.Tensor, torch.Tensor]:
    """K14's table, made once an exchange from ``bound_ops`` (ascending,
    from :func:`range_bound_operands`): (int64 words, uint8 ranks), one of
    each a key of a node, key-major, the nodes of the search tree level by
    level (``_search_order``); a padding node has rank 5, above every
    row."""
    nb = int(bound_ops[1].shape[0])
    idx = torch.tensor(_search_order(nb), dtype=torch.int64, device=bound_ops[0].device)
    real = idx < nb
    at = idx.clamp(max=max(nb - 1, 0))
    words = torch.stack([torch.where(real, _range_words(v)[at], 0) for v in bound_ops[1::2]])
    ranks = torch.stack([torch.where(real, r[at], _RANK_PAST) for r in bound_ops[0::2]])
    return words.reshape(-1).contiguous(), ranks.to(torch.uint8).reshape(-1).contiguous()


def _bound_rows_le(bw, br, rw, rr) -> torch.Tensor:
    """Is node i (words ``bw[i]``, ranks ``br[i]``) <= row i,
    lexicographically over the keys' (rank, word)?"""
    lt = torch.zeros(rw.shape[0], dtype=torch.bool, device=rw.device)
    eq = torch.ones(rw.shape[0], dtype=torch.bool, device=rw.device)
    for c in range(rw.shape[1]):
        b, r, v, w = br[:, c], rr[:, c], bw[:, c], rw[:, c]
        lt |= eq & ((b < r) | ((b == r) & (v < w)))
        eq &= (b == r) & (v == w)
    return lt | eq


def range_partition_ids_plain(datas, valids, exists, bound_ops, spec) -> torch.Tensor:
    """Plain PyTorch twin of K14: int32 partition ids over the capacity,
    the rows and ``bound_ops`` (ascending, from
    :func:`range_bound_operands`) as K14 normalises them, every row's
    walk down the search tree (:func:`range_bound_words`) at once."""
    k = len(datas)
    ops = sort_key_operands_plain(datas, valids, exists, spec)
    rw = torch.stack([_range_words(v) for v in ops[1::2]], 1)
    rr = torch.stack(ops[0::2], 1)
    nb = int(bound_ops[1].shape[0])
    bw, br = range_bound_words(bound_ops)
    bw, br = bw.view(k, -1), br.view(k, -1)
    d = nb.bit_length()
    pos = torch.zeros(rw.shape[0], dtype=torch.int64, device=exists.device)
    for level in range(d):
        e = (1 << level) - 1 + (pos >> (d - level))
        le = _bound_rows_le(bw[:, e].T, br[:, e].T, rw, rr)
        pos = pos + (le.to(torch.int64) << (d - 1 - level))
    return torch.where(exists, pos, nb + 1).to(torch.int32)


# csrc/range_part.cu blz_range_partition_ids' argument words: the header,
# then (data, validity, element bytes, kind, asc, nulls_first) a key from
# _RW_KEYS
(_RW_K, _RW_NB, _RW_N, _RW_EXISTS, _RW_OUT, _RW_STREAM, _RW_BWORDS, _RW_BRANKS, _RW_ROUTE,
 _RW_KEYS) = range(10)


class RangePack:
    """K14's argument words for one exchange's bounds, checked and packed
    once: the key and bound counts, each key's element size, kind,
    direction and null order, the route, and the search tree the kernel
    stages (:func:`range_bound_words`, kept here on the device). Each call
    checks its planes' device, shape and dtypes against the pack, writes
    only the key planes', ``exists``' and the output's pointers, the row
    count and the stream into the words in place, and allocates the int32
    ids. ``RangePartitioner`` makes one an exchange on the card (its map
    tasks run in turn, so one thread writes the words at a time). ``route``
    forces RANGE_COUNT, RANGE_SEARCH or RANGE_GLOBAL (timing); by default
    the bound count and :func:`range_tree_staged` decide."""

    def __init__(self, bound_ops, spec, dtypes: Sequence[torch.dtype],
                 route: Optional[int] = None):
        k = len(dtypes)
        if not 0 < k <= _MAX_SORT_KEYS or len(spec) != k or len(bound_ops) != 2 * k:
            raise ValueError(f"range_partition_ids: {k} keys, {len(spec)} specs, "
                             f"{len(bound_ops)} bound operands")
        index = bound_ops[0].get_device()
        if index < 0:
            raise ValueError("range_partition_ids: bounds off the card, expected CUDA")
        nb = int(bound_ops[0].shape[0])
        kinds = [_key_kind(dt) for dt in dtypes]
        for c, (dt, kind) in enumerate(zip(dtypes, kinds)):
            rank, val = bound_ops[2 * c], bound_ops[2 * c + 1]
            want = torch.uint8 if kind == _KEY_BOOL else dt
            if rank.dtype != torch.uint8 or val.dtype != want or \
                    rank.shape != (nb,) or val.shape != (nb,) or \
                    rank.get_device() != index or val.get_device() != index:
                raise TypeError(f"range_partition_ids: key {c}'s bounds are {rank.dtype}/"
                                f"{val.dtype} of {tuple(val.shape)} on {val.device}, "
                                f"expected uint8/{want} of ({nb},) on cuda:{index}")
        staged = range_tree_staged(k, nb)
        if route is None:
            route = RANGE_GLOBAL if not staged else \
                RANGE_COUNT if nb <= RANGE_COUNT_MAX_BOUNDS else RANGE_SEARCH
        if route not in (RANGE_COUNT, RANGE_SEARCH, RANGE_GLOBAL) or \
                (route != RANGE_GLOBAL and not staged):
            raise ValueError(f"range_partition_ids: route {route} for {nb} bounds of {k} keys")
        self.index, self.dtypes = index, tuple(dtypes)
        self.bwords, self.branks = range_bound_words(bound_ops)
        self.fn = cuda_lib.library().blz_range_partition_ids
        w = self.words = (cuda_lib.ctypes.c_longlong * (_RW_KEYS + 6 * k))()
        w[_RW_K], w[_RW_NB], w[_RW_ROUTE] = k, nb, route
        w[_RW_BWORDS], w[_RW_BRANKS] = self.bwords.data_ptr(), self.branks.data_ptr()
        for c, (dt, kind, (asc, nf)) in enumerate(zip(dtypes, kinds, spec)):
            at = _RW_KEYS + 6 * c
            w[at + 2] = torch.empty((), dtype=dt).element_size()
            w[at + 3], w[at + 4], w[at + 5] = kind, int(asc), int(nf)

    def launch(self, datas, valids, exists) -> torch.Tensor:
        """The int32 ids of ``exists``' rows: one K14 launch."""
        index, n = self.index, int(exists.shape[0])
        if exists.get_device() != index or exists.dtype is not torch.bool or \
                exists.dim() != 1 or not exists.is_contiguous() or \
                len(datas) != len(self.dtypes) or len(valids) != len(self.dtypes):
            raise ValueError(f"range_partition_ids: exists {exists.dtype}"
                             f"{tuple(exists.shape)} on {exists.device}, {len(datas)} keys, "
                             f"expected a contiguous bool plane on cuda:{index} and "
                             f"{len(self.dtypes)} keys")
        w, at = self.words, _RW_KEYS
        for d, v, dt in zip(datas, valids, self.dtypes):
            # get_device() is -1 off the card: one check for the device and CUDA
            if d.get_device() != index or v.get_device() != index or \
                    d.dtype is not dt or v.dtype is not torch.bool or \
                    d.dim() != 1 or v.dim() != 1 or d.shape[0] != n or v.shape[0] != n or \
                    not d.is_contiguous() or not v.is_contiguous():
                raise TypeError(f"range_partition_ids: key planes {d.dtype}{tuple(d.shape)} "
                                f"on {d.device} and {v.dtype}{tuple(v.shape)} on {v.device}, "
                                f"expected contiguous {dt} and bool planes of ({n},) on "
                                f"cuda:{index}")
            w[at], w[at + 1] = d.data_ptr(), v.data_ptr()
            at += 6
        out = torch.empty(n, dtype=torch.int32, device=exists.device)
        if n:
            w[_RW_N], w[_RW_EXISTS], w[_RW_OUT] = n, exists.data_ptr(), out.data_ptr()
            w[_RW_STREAM] = cuda_lib.stream_handle(index)
            cuda_lib.check(self.fn(w), "range_partition_ids")
            cuda_lib.LAUNCHES["range_partition"] += 1
        return out


def range_partition_ids_cuda(datas, valids, exists, bound_ops, spec,
                             pack: Optional[RangePack] = None) -> torch.Tensor:
    """K14 on the card (csrc/range_part.cu): same ids as
    :func:`range_partition_ids_plain`, one launch, through ``pack`` (an
    exchange's :class:`RangePack` over these bounds) or a pack made for
    this call."""
    if pack is None:
        cuda_lib.require_cuda("range_partition_ids", exists, *datas, *valids, *bound_ops)
        pack = RangePack(bound_ops, spec, [d.dtype for d in datas])
    return pack.launch(datas, valids, exists)


def range_partition_ids(datas, valids, exists, bound_ops, spec,
                        pack: Optional[RangePack] = None) -> torch.Tensor:
    """Row-order int32 range-partition ids over the capacity: K14 on a
    CUDA batch (through ``pack`` where the caller keeps one), the plain
    version on a CPU one."""
    if exists.is_cuda:
        return range_partition_ids_cuda(datas, valids, exists, bound_ops, spec, pack)
    return range_partition_ids_plain(datas, valids, exists, bound_ops, spec)


def range_partition_order(datas, valids, exists, bound_ops, spec,
                          num_rows: Optional[int] = None):
    """(sorted_pids, order): K14's ids, then K5's stable sort of the rows
    by id (blaze_tpu/core/kernels.py _range_order). Padding rows carry the
    largest id, so sorting only the first ``num_rows`` rows leaves them
    where a sort of every row would put them."""
    pids = range_partition_ids(datas, valids, exists, bound_ops, spec)
    order = lexsort_indices([pids], num_rows)
    return pids[order], order


# -- K10: the segmented aggregate ------------------------------------------------
#
# The sort route of the grouped aggregation, blaze_tpu/ops/agg_device.py
# _partial_kernel and _merge_kernel: K5 sorts the rows so that equal keys
# are adjacent, ``segment_ids`` cuts the sorted rows into segments, and
# ``segment_reduce`` runs the slot program's ops (ADD / COUNT / MIN / MAX,
# the limb ops below, each gated by up to three validity planes) and emits
# over each segment. Segments are dense by construction, so group s is
# segment s.
#
# The limb ops carry a decimal wider than one int64 (ir/aggstate.py): a
# two-limb sum (sum2/avg2) adds the low 32 bits and the arithmetic >> 32
# of an int64 source; a three-limb sum (sum3/avg3) adds the limbs (l0, l1,
# l2) with OP_ADD; emits renormalise the carries (the reference's
# ``_limb_renorm`` / ``_limb3_renorm``: LO32 the low limb, CARRY a
# two-limb high limb, MID and TOP a three-limb l1 and l2). A wide MIN/MAX
# (minw/maxw) is OP_LEXMIN/OP_LEXMAX over l2 followed by OP_LEXLO over
# the low word (l1 << 32) | l0, compared as unsigned: l1 and l0 are
# non-negative 32-bit chunks, so the pair orders as ``_segment_lex3``'s
# cascade does; WORD_HI and WORD_LO emit the word's chunks, 0 where the
# count is 0.

OP_ADD, OP_COUNT, OP_MIN, OP_MAX = 0, 1, 2, 3
OP_ADD_LO32, OP_ADD_HI32 = 4, 5
OP_LEXMIN, OP_LEXMAX, OP_LEXLO = 6, 7, 8
EMIT_RAW, EMIT_NONZERO, EMIT_WHERE = 0, 1, 2
EMIT_LO32, EMIT_CARRY, EMIT_MID, EMIT_TOP = 3, 4, 5, 6
EMIT_WORD_HI, EMIT_WORD_LO = 7, 8
LO32 = 0xFFFFFFFF
_LIMB_OPS = (OP_ADD_LO32, OP_ADD_HI32, OP_LEXMIN, OP_LEXMAX, OP_LEXLO)
_INT_DTYPES = (torch.int8, torch.int16, torch.int32, torch.int64)
# csrc/seg_agg.cu limits of one launch
_MAX_SEG_KEYS = 16
_SEG_KEY_DTYPES = _INT_DTYPES + (torch.bool, torch.float32, torch.float64)
_MAX_SEG_OPS = 24
_MAX_SEG_EMITS = 24
_QNAN_BITS = 0x7FF8000000000000  # every NaN a float state ends as


class AggOp:
    """One op of the slot program: ``kind`` into a table initialised to
    ``init``, from ``src`` (int64, or float64 for a float state; None for
    COUNT) times ``mult``, where every plane of ``valids`` holds. OP_LEXLO
    also reads ``src0`` (l0; ``src`` is l1) and belongs to the
    OP_LEXMIN/OP_LEXMAX op just before it, with the same gate."""

    __slots__ = ("kind", "src", "valids", "mult", "init", "src0")

    def __init__(self, kind, src, valids, mult=1, init=0, src0=None):
        self.kind, self.src, self.valids = kind, src, list(valids)
        self.mult, self.init, self.src0 = mult, init, src0

    @property
    def is_float(self) -> bool:
        return self.src is not None and self.src.is_floating_point()


class AggEmit:
    """One output column: table ``table`` RAW, NONZERO (as bool), its
    value WHERE table ``aux`` is nonzero (else 0), or a limb emit over
    tables ``table``, ``aux`` and ``aux2`` (see above), cast to
    ``dtype``."""

    __slots__ = ("kind", "table", "aux", "dtype", "aux2")

    def __init__(self, kind, table, dtype, aux=-1, aux2=-1):
        self.kind, self.table, self.aux, self.dtype = kind, table, aux, dtype
        self.aux2 = aux2


def lex_ops(kind: str, l0, l1, l2, gate) -> List[AggOp]:
    """The two ops of a wide MIN/MAX (``kind`` "min" or "max") over limb
    planes gated by ``gate``; the first table holds l2, the second the
    low word."""
    info = torch.iinfo(torch.int64)
    if kind == "max":
        return [AggOp(OP_LEXMAX, l2, gate, init=info.min),
                AggOp(OP_LEXLO, l1, gate, init=0, src0=l0)]
    return [AggOp(OP_LEXMIN, l2, gate, init=info.max),
            AggOp(OP_LEXLO, l1, gate, init=-1, src0=l0)]


def limb_emits(t: int, nlimbs: int) -> List[AggEmit]:
    """The renormalised limbs of an ``nlimbs``-limb sum in tables t, t+1
    (, t+2)."""
    if nlimbs == 2:
        return [AggEmit(EMIT_LO32, t, torch.int64),
                AggEmit(EMIT_CARRY, t + 1, torch.int64, aux=t)]
    return [AggEmit(EMIT_LO32, t, torch.int64),
            AggEmit(EMIT_MID, t + 1, torch.int64, aux=t),
            AggEmit(EMIT_TOP, t + 2, torch.int64, aux=t + 1, aux2=t)]


def lex_emits(t: int, count: int) -> List[AggEmit]:
    """(b0, b1, b2) of the wide extreme in tables t (l2) and t + 1 (low
    word), zeros where table ``count`` is 0: ``_segment_lex3``'s order."""
    return [AggEmit(EMIT_WORD_LO, t + 1, torch.int64, aux=count),
            AggEmit(EMIT_WORD_HI, t + 1, torch.int64, aux=count),
            AggEmit(EMIT_WHERE, t, torch.int64, aux=count)]


def check_limb_program(name: str, ops, emits) -> None:
    """The kernels' rules for the limb ops: OP_LEXLO right after an
    OP_LEXMIN/OP_LEXMAX, with both sources int64; every emit's tables in
    range."""
    for o, op in enumerate(ops):
        lex = op.kind in (OP_LEXMIN, OP_LEXMAX)
        if lex != (o + 1 < len(ops) and ops[o + 1].kind == OP_LEXLO) or (
                op.kind == OP_LEXLO and (o == 0 or ops[o - 1].kind not in
                                         (OP_LEXMIN, OP_LEXMAX) or op.src0 is None)):
            raise ValueError(f"{name}: a lexicographic op without its partner at op {o}")
        if op.kind in _LIMB_OPS and any(p is not None and p.dtype != torch.int64
                                        for p in (op.src, op.src0)):
            raise TypeError(f"{name}: limb op {op.kind} over a non-int64 source")
    for e in emits:
        if not all(-1 <= t < len(ops) for t in (e.aux, e.aux2)) or \
                not 0 <= e.table < len(ops):
            raise ValueError(f"{name}: emit over tables {e.table}, {e.aux}, {e.aux2} "
                             f"of {len(ops)}")


def op_contrib(op: AggOp, src: torch.Tensor) -> torch.Tensor:
    """What an integer ADD-family op adds for each row of ``src``."""
    if op.kind == OP_ADD_LO32:
        return src & LO32
    if op.kind == OP_ADD_HI32:
        return src >> 32
    return src * op.mult


def lex_tables_plain(seg, ok, l2, l1, l0, size: int, is_max: bool):
    """Plain twin of a wide MIN/MAX pair: per segment of ``seg`` (size
    ``size``) the extreme l2 and the extreme low word among the rows tied
    on it, by ``_segment_lex3``'s cascade (l1, then l0). Returns the two
    tables; a segment without an ``ok`` row holds no defined value."""
    info = torch.iinfo(torch.int64)
    how = "amax" if is_max else "amin"
    hi0 = info.min if is_max else info.max
    lo0 = -1 if is_max else info.max

    def extreme(vals, take, init):
        t = torch.full((size,), init, dtype=torch.int64, device=seg.device)
        return t.scatter_reduce(0, seg, torch.where(take, vals, init), how)

    b2 = extreme(l2, ok, hi0)
    t2 = ok & (l2 == b2[seg])
    b1 = extreme(l1, t2, lo0)
    t1 = t2 & (l1 == b1[seg])
    b0 = extreme(l0, t1, lo0)
    return b2, (b1 << 32) | b0


def emit_plain(e: AggEmit, tables: List[torch.Tensor]) -> torch.Tensor:
    """One emit over the final tables (int64 limb arithmetic wraps)."""
    t = tables[e.table]
    if e.kind == EMIT_NONZERO:
        return t != 0
    if e.kind == EMIT_WHERE:
        return _zero_where(tables[e.aux] != 0, t)
    if e.kind == EMIT_LO32:
        return t & LO32
    if e.kind == EMIT_CARRY:
        return t + (tables[e.aux] >> 32)
    if e.kind == EMIT_MID:
        return (t + (tables[e.aux] >> 32)) & LO32
    if e.kind == EMIT_TOP:
        return t + ((tables[e.aux] + (tables[e.aux2] >> 32)) >> 32)
    if e.kind == EMIT_WORD_HI:
        return _zero_where(tables[e.aux] != 0, (t >> 32) & LO32)
    if e.kind == EMIT_WORD_LO:
        return _zero_where(tables[e.aux] != 0, t & LO32)
    return t


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


def segment_keys_plain(datas, valids, order, num_rows: int, key_data, key_valid):
    """Plain twin of K10's segmentation: :func:`segment_starts_plain`,
    then each segment's keys from its first row (``gather_planes_plain``
    of the key planes at order[starts[:count]]). ``datas``/``valids`` are
    the planes compared, ``key_data``/``key_valid`` the keys emitted (the
    same planes but in the direct single-integer mode). Returns (starts,
    count, key datas, key valids), the key planes capacity-long and
    padding past the count."""
    starts, count = segment_starts_plain(datas, valids, order, num_rows)
    c = int(count)
    kd, kv = gather_planes_plain(key_data, key_valid, order[starts[:c]], order.shape[0], c)
    return starts, count, kd, kv


# csrc/seg_agg.cu: positions a tile of the segmentation (the smaller of its two
# tile sizes), keys a chunk of its loads
_SEG_TILE, _SEG_CHUNK = 512, 4


class _SegScratch:
    """The segmentation's scratch on one device and stream (the tickets'
    counter, then a look-back word a tile), grown with the rows and never
    zeroed after its allocation: each launch tags its words anew. Its
    launches go in stream order."""

    def __init__(self):
        self.words = None
        self.tag = 0

    def take(self, rows: int, device: torch.device):
        tiles = -(-rows // _SEG_TILE)
        if self.words is None or self.words.shape[0] < 1 + tiles:
            self.words = torch.zeros(1 + max(tiles, 128), dtype=torch.int64, device=device)
        self.tag = self.tag % _JOIN_TAGS + 1
        return self.words, self.tag


_SEG_SCRATCH = {}


def segment_keys_cuda(datas, valids, order, num_rows: int, key_data, key_valid):
    """K10's segmentation on the card (csrc/seg_agg.cu blz_segment_keys:
    one launch ranks the segment starts and takes each segment's keys
    from its first row); same result as :func:`segment_keys_plain`."""
    name = "segment_ids"
    k, m = len(datas), len(key_data)
    # the emitted planes are the compared ones (no direct plane): the kernel
    # stores the rows it compared
    reuse = m == k <= _SEG_CHUNK and all(a is b for a, b in zip(datas, key_data)) and \
        all(a is b for a, b in zip(valids, key_valid))
    keys = [*datas, *key_data] if not reuse else list(datas)
    flags = [*valids, *key_valid] if not reuse else list(valids)
    cuda_lib.require_cuda(name, order, *keys, *flags)
    cap = int(order.shape[0])
    if not 0 < k <= _MAX_SEG_KEYS or len(valids) != k or order.dtype != torch.int64 or \
            m > _MAX_SEG_KEYS or len(key_valid) != m:
        raise ValueError(f"{name}: {k} keys compared, {m} emitted, order {order.dtype}")
    if not 0 <= num_rows <= cap:
        raise ValueError(f"{name}: {num_rows} rows of {cap}")
    for d, v in zip(keys, flags):
        if d.dim() != 1 or v.dim() != 1 or d.shape[0] != cap or v.shape[0] != cap or \
                v.dtype != torch.bool:
            raise ValueError(f"{name}: key planes must be capacity-long, validity bool")
        if d.dtype not in _SEG_KEY_DTYPES:
            raise TypeError(f"{name}: key of dtype {d.dtype}")
    dev = order.device
    index = order.get_device()
    stream = cuda_lib.stream_handle(index)
    scratch = _SEG_SCRATCH.get((index, stream))
    if scratch is None:
        scratch = _SEG_SCRATCH[(index, stream)] = _SegScratch()
    words_t, tag = scratch.take(num_rows, dev)
    head = torch.empty(cap + 2, dtype=torch.int64, device=dev)  # the starts, then the count
    outs, ptrs = _alloc_planes([d.dtype for d in key_data] + [torch.bool] * m, cap, dev)
    head_at = head.data_ptr()
    words = [k, m, order.data_ptr(), num_rows, cap, head_at, head_at + 8 * (cap + 1),
             words_t.data_ptr(), words_t.shape[0] - 1, tag, stream, int(reuse)]
    for d, v in zip(datas, valids):
        words += (d.data_ptr(), v.data_ptr(), d.element_size(), int(d.is_floating_point()))
    for j, (d, v) in enumerate(zip(key_data, key_valid)):
        words += (d.data_ptr(), v.data_ptr(), ptrs[j], ptrs[m + j], d.element_size())
    err = cuda_lib.library().blz_segment_keys(_words(words))
    cuda_lib.check(err, name)
    cuda_lib.LAUNCHES[name] += 1
    return head[:cap + 1], head[cap + 1], outs[:m], outs[m:]


def segment_ids(key_data, key_valid, exists, num_rows: int, direct: bool = True,
                live_rows: Optional[int] = None):
    """``_segmentation`` of blaze_tpu/ops/agg_device.py:1082: the stable
    order that makes equal keys adjacent (K5's key pass and radix sort,
    keys ascending, null first, NaN last), then K10's segmentation over it,
    which also takes each segment's keys from its first row. ``key_valid``
    is masked with ``exists``: a prefix of num_rows rows, or a live mask
    within it whose ``live_rows`` rows the sort puts first (a dead row
    takes K5's padding rank), so the segments cover the first live_rows
    sorted positions. ``direct`` allows the single-integer-key case where
    the key is the segment id. Returns (order, starts, count, (key datas,
    key valids)): starts and count as :func:`segment_starts_plain`
    describes them, the keys of segment s at row s of capacity-long
    planes, padding past the count."""
    datas, valids = _segment_planes(key_data, key_valid, exists, direct)
    ops = sort_key_operands(datas, valids, exists, [(True, True)] * len(datas))
    order = lexsort_indices(ops, num_rows, dead_last=True)
    fn = segment_keys_cuda if order.is_cuda else segment_keys_plain
    starts, count, kd, kv = fn(datas, valids, order,
                               num_rows if live_rows is None else live_rows,
                               key_data, key_valid)
    return order, starts, count, (kd, kv)


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
    for o, op in enumerate(ops):
        ok = torch.ones(n, dtype=torch.bool, device=dev)
        for v in op.valids:
            ok = ok & v[rows]
        if op.kind in (OP_LEXMIN, OP_LEXMAX):
            lo = ops[o + 1]
            tables += lex_tables_plain(seg, ok, op.src[rows], lo.src[rows], lo.src0[rows],
                                       cap, op.kind == OP_LEXMAX)
            continue
        if op.kind == OP_LEXLO:
            continue
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
            if op.kind in (OP_ADD, OP_ADD_LO32, OP_ADD_HI32):
                t = torch.zeros(cap, dtype=torch.int64, device=dev)
                t.index_add_(0, seg, torch.where(ok, op_contrib(op, src), 0))
            else:
                t = torch.full((cap,), op.init, dtype=torch.int64, device=dev)
                t.scatter_reduce_(0, seg, torch.where(ok, src, op.init),
                                  "amin" if op.kind == OP_MIN else "amax")
        tables.append(t)
    outs = []
    for e in emits:
        t = emit_plain(e, tables)
        outs.append(t & out_valid if e.kind == EMIT_NONZERO else _zero_where(out_valid, t))
    first = _zero_where(out_valid, order[starts[:cap].clamp(max=max(n - 1, 0))])
    return outs, first


def segment_reduce_cuda(name, order, starts, count, num_rows: int, ops, emits,
                        kinds=()):
    """K10's reduction on the card (csrc/seg_agg.cu: a thread folds a
    segment of up to 64 rows, a warp one of up to 256 or each piece of 256
    rows or more of a longer one); same outputs as
    :func:`segment_reduce_plain`. ``count`` is the
    device scalar ``segment_keys_cuda`` returned; ``kinds`` the
    program's limb aggregate kinds, counted per launch
    (``cuda_lib.LIMB_LAUNCHES``)."""
    check_limb_program(name, ops, emits)
    srcs = [p for op in ops for p in (op.src, op.src0) if p is not None]
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
    lib = cuda_lib.library()
    words = lib.blz_segment_reduce_scratch(cap, len(ops))
    scratch = torch.empty(words, dtype=torch.int64, device=dev)
    keep = []

    def arr(pair):
        keep.append(pair[1])
        return pair[0]

    def init_bits(op):
        if not op.is_float:
            return int(op.init)
        return struct.unpack("<q", struct.pack("<d", float(op.init)))[0]

    op_valid = []
    for op in ops:
        op_valid += list(op.valids) + [None] * (3 - len(op.valids))
    LL = cuda_lib.ctypes.c_longlong
    err = lib.blz_segment_reduce(
        starts.data_ptr(), order.data_ptr(), count.data_ptr(), cap,
        len(ops), arr(cuda_lib.int_array([op.kind for op in ops])),
        arr(cuda_lib.int_array([int(op.is_float) for op in ops])),
        arr(cuda_lib.ptr_array([op.src for op in ops])),
        arr(cuda_lib.ptr_array([op.src0 for op in ops])),
        arr(cuda_lib.int_array([len(op.valids) for op in ops])),
        arr(cuda_lib.ptr_array(op_valid)),
        arr(cuda_lib.int_array([op.mult for op in ops], LL)),
        arr(cuda_lib.int_array([init_bits(op) for op in ops], LL)),
        len(emits), arr(cuda_lib.int_array([e.kind for e in emits])),
        arr(cuda_lib.int_array([e.table for e in emits])),
        arr(cuda_lib.int_array([e.aux for e in emits])),
        arr(cuda_lib.int_array([e.aux2 for e in emits])),
        arr(cuda_lib.ptr_array(outs)), first.data_ptr(), scratch.data_ptr(), words,
        cuda_lib.stream_of(dev))
    cuda_lib.check(err, name)
    cuda_lib.LAUNCHES[name] += 1
    cuda_lib.count_limb_launch(name, kinds)
    return outs, first


def segment_reduce(name, order, starts, count, num_rows: int, ops, emits, kinds=()):
    """``_reduce_aggs`` (:1165) / ``_merge_reduce`` (:1330) over sorted
    segments: K10 on CUDA planes, the plain version on CPU ones. ``name``
    is the launch count to add to."""
    if order.is_cuda:
        return segment_reduce_cuda(name, order, starts, count, num_rows, ops, emits,
                                   kinds)
    return segment_reduce_plain(order, starts, count, num_rows, ops, emits)


# -- K19: the passthrough of a skipped partial aggregate ---------------------------
#
# blaze_tpu/ops/agg_device.py:1710 _passthrough_kernel: once the partial
# skipper decides that partials do not reduce, every existing row becomes
# its own group, so ``_reduce_aggs`` runs with seg = where(exists, iota,
# capacity) and each op's table value is the op applied once onto its init.
# The program is K3's and K10's (``_partial_program``'s ops and emits).

_MAX_PASS_KEYS = 16  # csrc/passthrough.cu limits of one launch
_MAX_PASS_OPS = 24
_MAX_PASS_EMITS = 24


def _emit_out(x: torch.Tensor, e: AggEmit) -> torch.Tensor:
    """An emit's value plane in its column's type (NaN as the quiet NaN of
    a float32 column)."""
    if e.kind == EMIT_NONZERO:
        return x
    return narrow_float(x, e.dtype) if x.is_floating_point() else x.to(e.dtype)


def passthrough_states_plain(keys, kvalids, exists: torch.Tensor, num_rows: int,
                             ops, emits):
    """Plain twin of K19. ``exists`` is the batch's row mask (the rows below
    ``num_rows``), ``kvalids`` are masked with it, every op's gate too.
    Returns ``_passthrough_kernel``'s outputs: (num_rows, exists, per key
    (data zeroed where null, validity), per emit its column), all
    capacity-long."""
    tables = []
    for op in ops:
        ok = exists
        for v in op.valids:
            ok = ok & v
        if op.kind == OP_COUNT:
            t = op.init + ok.to(torch.int64)
        elif op.is_float:
            x = torch.where(ok, op.src, 0.0)
            init = torch.full_like(op.src, float(op.init))
            # a sum starts from its init, +0.0: -0.0 and a null row sum to +0.0
            t = _quiet_nan(init + x if op.kind == OP_ADD else torch.where(ok, op.src, init))
        elif op.kind in (OP_ADD, OP_ADD_LO32, OP_ADD_HI32):
            t = op.init + torch.where(ok, op_contrib(op, op.src), 0)
        elif op.kind == OP_LEXLO:
            t = torch.where(ok, (op.src << 32) | op.src0, op.init)
        else:  # MIN, MAX, LEXMIN, LEXMAX: the row's own value
            t = torch.where(ok, op.src, op.init)
        tables.append(t)
    results = [num_rows, exists]
    for d, v in zip(keys, kvalids):
        results += [_zero_where(v, d), v]
    results += [_emit_out(emit_plain(e, tables), e) for e in emits]
    return tuple(results)


# csrc/passthrough.cu's argument words: the header, then a fixed slot of
# words for each key, op and emit
_PW_K, _PW_ROWS, _PW_CAP, _PW_NOPS, _PW_NEMIT, _PW_STREAM = range(6)
_PASS_HEAD, _PASS_KEY_WORDS, _PASS_OP_WORDS, _PASS_EMIT_WORDS = 8, 4, 10, 7
_PASS_OPS_AT = _PASS_HEAD + _MAX_PASS_KEYS * _PASS_KEY_WORDS
_PASS_EMITS_AT = _PASS_OPS_AT + _MAX_PASS_OPS * _PASS_OP_WORDS
_PASS_WORDS = _PASS_EMITS_AT + _MAX_PASS_EMITS * _PASS_EMIT_WORDS


def _bits(op) -> int:
    """An op's init as the table's 64 bits (a float's IEEE bits)."""
    if not op.is_float:
        return int(op.init)
    return struct.unpack("<q", struct.pack("<d", float(op.init)))[0]


class PassthroughPack:
    """K19's argument words for the program a skipping partial aggregate
    sends with every batch of a task: the same ops, emits and key types.
    The program (kinds, float flags, mults, init bits, emit descriptors
    and output types, key sizes, the capacity and the device) is checked
    and packed once, and packed anew only when one of those changes; each
    batch then only checks its planes and writes their pointers, and
    those of the outputs it allocates, into the words in place."""

    def __init__(self):
        self.key = None
        self.words = None
        self.device = None
        self.index = -1
        self.out_dtypes = ()
        self.src_dtypes = ()

    @staticmethod
    def _key(keys, exists, ops, emits):
        return (int(exists.shape[0]), exists.device, tuple(d.dtype for d in keys),
                tuple((op.kind, op.is_float, len(op.valids), op.mult, op.init,
                       op.src is None, op.src0 is None) for op in ops),
                tuple((e.kind, e.table, e.aux, e.aux2, e.dtype) for e in emits))

    def _pack(self, key, keys, exists, ops, emits) -> None:
        name = "passthrough_states"
        check_limb_program(name, ops, emits)
        if len(keys) > _MAX_PASS_KEYS or len(ops) > _MAX_PASS_OPS or \
                len(emits) > _MAX_PASS_EMITS or any(len(op.valids) > 3 for op in ops):
            raise NotImplementedError(f"{name}: more keys or aggregates than one launch takes")
        if exists.dtype != torch.bool:
            raise TypeError(f"{name}: row mask of {exists.dtype}")
        if any(d.element_size() not in (1, 2, 4, 8) for d in keys):
            raise TypeError(f"{name}: keys of {[d.dtype for d in keys]}")
        outs = [torch.bool if e.kind == EMIT_NONZERO else e.dtype for e in emits]
        if any(dt.is_floating_point and torch.empty(0, dtype=dt).element_size() < 4
               for dt in outs):
            raise TypeError(f"{name}: emits of {outs}")
        w = (cuda_lib.ctypes.c_longlong * _PASS_WORDS)()
        w[_PW_K], w[_PW_CAP], w[_PW_NOPS], w[_PW_NEMIT] = len(keys), key[0], len(ops), len(emits)
        for j, d in enumerate(keys):
            w[_PASS_HEAD + j * _PASS_KEY_WORDS + 3] = d.element_size()
        for o, op in enumerate(ops):
            b = _PASS_OPS_AT + o * _PASS_OP_WORDS
            w[b], w[b + 1], w[b + 2] = op.kind, int(op.is_float), len(op.valids)
            w[b + 8], w[b + 9] = int(op.mult), _bits(op)
        for c, (e, dt) in enumerate(zip(emits, outs)):
            b = _PASS_EMITS_AT + c * _PASS_EMIT_WORDS
            w[b], w[b + 1], w[b + 2], w[b + 3] = e.kind, e.table, e.aux, e.aux2
            w[b + 4] = torch.empty(0, dtype=dt).element_size()
            w[b + 5] = int(dt.is_floating_point)
        self.key, self.words, self.device = key, w, exists.device
        self.index = exists.get_device()
        self.out_dtypes = outs
        self.src_dtypes = [None if op.src is None else
                           torch.float64 if op.is_float else torch.int64 for op in ops]

    def _row(self, p: torch.Tensor, cap: int, dtype) -> int:
        """A plane's pointer, after its check."""
        if p.dtype is not dtype or p.numel() != cap or p.dim() != 1 or \
                p.get_device() != self.index or not p.is_contiguous():
            raise TypeError(f"passthrough_states: a plane of {p.dtype}{tuple(p.shape)} on "
                            f"{p.device}, expected {dtype} ({cap},) on {self.device}")
        return p.data_ptr()

    def bind(self, keys, kvalids, exists: torch.Tensor, num_rows: int, ops, emits):
        """Pack the program if it is not the packed one, check the batch's
        planes, allocate the outputs and write every pointer; returns
        (words, key outputs, emit outputs)."""
        key = self._key(keys, exists, ops, emits)
        if key != self.key:
            self._pack(key, keys, exists, ops, emits)
        cap = key[0]
        if not 0 <= num_rows <= cap:
            raise ValueError(f"passthrough_states: {num_rows} rows of {cap}")
        w, row, dev = self.words, self._row, self.device
        w[_PW_ROWS] = num_rows
        row(exists, cap, torch.bool)
        key_out = []
        for j, (d, v) in enumerate(zip(keys, kvalids)):
            b = _PASS_HEAD + j * _PASS_KEY_WORDS
            out = torch.empty(cap, dtype=d.dtype, device=dev)
            w[b], w[b + 1], w[b + 2] = row(d, cap, d.dtype), row(v, cap, torch.bool), \
                out.data_ptr()
            key_out.append(out)
        for o, (op, st) in enumerate(zip(ops, self.src_dtypes)):
            b = _PASS_OPS_AT + o * _PASS_OP_WORDS
            w[b + 3] = 0 if st is None else row(op.src, cap, st)
            w[b + 4] = 0 if op.src0 is None else row(op.src0, cap, torch.int64)
            for q, v in enumerate(op.valids):
                w[b + 5 + q] = row(v, cap, torch.bool)
        outs = []
        for c, dt in enumerate(self.out_dtypes):
            out = torch.empty(cap, dtype=dt, device=dev)
            w[_PASS_EMITS_AT + c * _PASS_EMIT_WORDS + 6] = out.data_ptr()
            outs.append(out)
        return w, key_out, outs


def passthrough_states_cuda(keys, kvalids, exists: torch.Tensor, num_rows: int,
                            ops, emits, pack: Optional[PassthroughPack] = None):
    """K19 on the card (csrc/passthrough.cu); same outputs as
    :func:`passthrough_states_plain`. The kernel takes the row mask as
    ``num_rows`` (``exists`` must be that prefix; it is returned as the
    groups' validity), and writes keys and emits in their own types.
    ``pack`` keeps the argument words of a task's batches."""
    pack = pack if pack is not None else PassthroughPack()
    w, key_out, outs = pack.bind(keys, kvalids, exists, num_rows, ops, emits)
    if pack.device.type != "cuda":
        raise ValueError(f"passthrough_states: planes on {pack.device}, expected CUDA")
    w[_PW_STREAM] = cuda_lib.stream_handle(pack.index)
    cuda_lib.check(cuda_lib.library().blz_passthrough(w), "passthrough_states")
    cuda_lib.LAUNCHES["passthrough_states"] += 1
    results = [num_rows, exists]
    for d, v in zip(key_out, kvalids):
        results += [d, v]
    return tuple(results + outs)


def passthrough_states(keys, kvalids, exists: torch.Tensor, num_rows: int, ops, emits,
                       pack: Optional[PassthroughPack] = None):
    """K19 on a CUDA batch (``pack``: a task's argument words), its plain
    twin on a CPU one."""
    if exists.is_cuda:
        return passthrough_states_cuda(keys, kvalids, exists, num_rows, ops, emits, pack)
    return passthrough_states_plain(keys, kvalids, exists, num_rows, ops, emits)


# -- K12: the host table's slot update ---------------------------------------------
#
# The eager scatters of blaze_tpu/ops/aggfns.py (.at[slots].add/min/max/set,
# mode="drop") that the host AggTable runs into its persistent slot tables,
# one call per batch for all of its aggregates. Rows carry their interned
# slot id; a padding row carries the table capacity and drops.

UPD_ADD, UPD_MIN, UPD_MAX, UPD_FLAG, UPD_FIRST = 0, 1, 2, 3, 4
# the limb ops of a wide-decimal state (ops/aggfns.py limbs "2"/"3"/"w")
UPD_ADD_LO32, UPD_ADD_HI32, UPD_RENORM, UPD_LEXMIN, UPD_LEXMAX = 5, 6, 7, 8, 9
_UPD_LIMB_NAMES = {UPD_ADD_LO32: "add_lo32", UPD_ADD_HI32: "add_hi32",
                   UPD_LEXMIN: "lexmin", UPD_LEXMAX: "lexmax"}
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
      ``valid_table`` the AND of its ``wvalids``;
    - ADD_LO32 / ADD_HI32: ``table += src & 0xFFFFFFFF`` / ``src >> 32``
      (arithmetic), a two-limb sum's split of an int64 source;
    - RENORM: the carry renormalisation of the limb sum in ``table`` (l0)
      and ``tables`` ([l1] or [l1, l2]) at the slots of the rows, after
      the batch's adds (``_limb_renorm`` / ``_limb3_renorm``; idempotent,
      so the other slots, already normal, need none);
    - LEXMIN / LEXMAX: the wide extreme: per slot the batch's best (l2,
      l1, l0) of ``src`` (l2) and ``srcs`` ([l1, l0]) replaces the state
      in ``table`` (s2) and ``tables`` ([s1, s0]) where it wins or
      ``valid_table`` (has) is False, which it then sets
      (``_lex_scatter_minmax``).
    """

    __slots__ = ("kind", "table", "src", "valids", "order", "wvalids",
                 "valid_table", "order_table", "srcs", "tables")

    def __init__(self, kind, table, src=None, valids=(), order=None,
                 wvalids=(), valid_table=None, order_table=None, srcs=(), tables=()):
        self.kind, self.table, self.src = kind, table, src
        self.valids = list(valids)
        self.order, self.wvalids = order, list(wvalids)
        self.valid_table, self.order_table = valid_table, order_table
        self.srcs, self.tables = list(srcs), list(tables)

    @property
    def folds(self) -> bool:
        """Runs in slot-sorted row order (a float ADD: a left fold), not
        by atomics."""
        return self.kind == UPD_ADD and self.table.is_floating_point()


def _upd_rows(op: SlotUpdate, slots: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    ok = mask & (slots >= 0) & (slots < op.table.shape[0])
    for v in op.valids:
        ok = ok & v
    return ok


def _touched(cap: int, s: torch.Tensor) -> torch.Tensor:
    out = torch.zeros(cap, dtype=torch.bool, device=s.device)
    out[s] = True
    return out


def slot_update_plain(slots: torch.Tensor, mask: torch.Tensor, ops,
                      num_rows: Optional[int] = None) -> None:
    """Plain PyTorch twin of K12: each op's update of its table in place,
    the arithmetic of the reference's scatters. Float ADD is CPU
    ``index_add_`` (one by one in row order, XLA's scatter-add order) on a
    copy of the table, so the fold starts from the slot's value; a touched
    float slot holding a NaN ends as the quiet NaN. Rows at or past
    ``num_rows`` (where given) do not exist."""
    n = slots.shape[0]
    if num_rows is not None:
        mask = mask & (iota(n, mask.device) < num_rows)
    for op in ops:
        table = op.table
        cap = table.shape[0]
        ok = _upd_rows(op, slots, mask)
        s = slots[ok]
        if op.kind == UPD_FLAG:
            table[s] = True
        elif op.kind in (UPD_ADD_LO32, UPD_ADD_HI32):
            src = op.src[ok]
            table.index_add_(0, s, src & LO32 if op.kind == UPD_ADD_LO32 else src >> 32)
        elif op.kind == UPD_RENORM:
            _renorm_plain([table] + op.tables, _touched(cap, s))
        elif op.kind in (UPD_LEXMIN, UPD_LEXMAX):
            _lex_update_plain(op, s, ok, cap)
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


def _renorm_plain(limbs: List[torch.Tensor], touched: torch.Tensor) -> None:
    """``_limb_renorm`` / ``_limb3_renorm`` of the touched slots, in place."""
    carry = limbs[0] >> 32
    new = [limbs[0] & LO32]
    for i, t in enumerate(limbs[1:]):
        t = t + carry
        if i + 2 < len(limbs):
            carry = t >> 32
            t = t & LO32
        new.append(t)
    for t, x in zip(limbs, new):
        t.copy_(torch.where(touched, x, t))


def _lex_update_plain(op: SlotUpdate, s: torch.Tensor, ok: torch.Tensor, cap: int) -> None:
    """``_lex_scatter_minmax``: each slot's best of the batch (the cascade
    of ``lex_tables_plain``) replaces the state where it wins or the slot
    has none."""
    is_max = op.kind == UPD_LEXMAX
    l2, l1, l0 = op.src[ok], op.srcs[0][ok], op.srcs[1][ok]
    b2, word = lex_tables_plain(s, torch.ones_like(s, dtype=torch.bool), l2, l1, l0,
                                cap, is_max)
    b1, b0 = (word >> 32) & LO32, word & LO32
    s2, (s1, s0), has = op.table, op.tables, op.valid_table
    if is_max:
        better = (b2 > s2) | ((b2 == s2) & (b1 > s1)) | ((b2 == s2) & (b1 == s1) & (b0 > s0))
    else:
        better = (b2 < s2) | ((b2 == s2) & (b1 < s1)) | ((b2 == s2) & (b1 == s1) & (b0 < s0))
    take = _touched(cap, s) & (better | ~has)
    for t, x in ((s2, b2), (s1, b1), (s0, b0)):
        t.copy_(torch.where(take, x, t))
    has |= take


def _check_table(op: SlotUpdate, cap: int) -> None:
    """The words of an op that stay the same from batch to batch."""
    t = op.table
    if any(x.shape != (cap,) for x in [t] + op.tables):
        raise ValueError(f"slot_update: table of {tuple(t.shape)}, expected ({cap},)")
    if len(op.valids) > 3 or len(op.wvalids) > 3:
        raise ValueError("slot_update: at most three validity planes an op")
    limbs = [t] + op.tables
    if op.kind == UPD_FLAG:
        ok = t.dtype == torch.bool
    elif op.kind in (UPD_ADD_LO32, UPD_ADD_HI32):
        ok = t.dtype == torch.int64
    elif op.kind == UPD_RENORM:
        ok = len(op.tables) in (1, 2) and all(x.dtype == torch.int64 for x in limbs)
    elif op.kind in (UPD_LEXMIN, UPD_LEXMAX):
        ok = (len(op.tables) == 2 and all(x.dtype == torch.int64 for x in limbs)
              and op.valid_table is not None and op.valid_table.dtype == torch.bool
              and op.valid_table.shape == (cap,))
    elif op.kind == UPD_FIRST:
        ok = (t.element_size() in (1, 2, 4, 8)
              and op.valid_table is not None and op.valid_table.dtype == torch.bool
              and op.valid_table.shape == (cap,) and op.order_table is not None
              and op.order_table.dtype == torch.int64 and op.order_table.shape == (cap,))
    else:
        ok = op.kind in (UPD_ADD, UPD_MIN, UPD_MAX) and t.dtype in (torch.int64, torch.float64)
    if not ok:
        raise TypeError(f"slot_update: op kind {op.kind} over a {t.dtype} table")


def _row_dtypes(op: SlotUpdate):
    """The dtypes an op's row planes must have: (src, order, limb sources);
    None where the op takes no such plane. The counts of validity planes
    are the op's own (bool)."""
    t = op.table.dtype
    if op.kind in (UPD_FLAG, UPD_RENORM):
        return None, None, None
    if op.kind in (UPD_LEXMIN, UPD_LEXMAX):
        return torch.int64, None, torch.int64
    if op.kind == UPD_FIRST:
        return t, torch.int64, None
    if op.kind == UPD_ADD and t == torch.int64 and op.src is None:
        return None, None, None  # a count
    return t, None, None


# csrc/slot_update.cu's argument words: the header, then _UPD_OP_WORDS an op
_UW_N, _UW_CAP, _UW_NOPS, _UW_SLOTS, _UW_MASK, _UW_PERM, _UW_SCRATCH, _UW_SCRATCH_BYTES, \
    _UW_STREAM = range(9)
_UPD_HEAD, _UPD_OP_WORDS = 16, 20
_UO_KIND, _UO_FLOAT, _UO_ESIZE, _UO_NVALID, _UO_NWVALID, _UO_SRC, _UO_VALID = range(7)
_UO_WVALID, _UO_ORDER, _UO_TABLE, _UO_VALID_TABLE, _UO_ORDER_TABLE = 9, 12, 13, 14, 15
_UO_LIMB_SRC, _UO_LIMB_TABLE = 16, 18


class SlotUpdatePack:
    """K12's argument words for an op list that recurs batch after batch,
    as the host table's does. What stays the same (kinds, the tables and
    their devices, dtypes and shapes, the counts of row planes, the
    scratch the passes keep a slot, whether a float ADD needs K5's sort)
    is checked and packed once, while the op list keeps the same tables
    (the same tensors: a table that grew is a new one) and kinds; each call
    then only checks the rows' planes and writes their pointers into the
    words in place."""

    def __init__(self):
        self.static = None
        self.words = None
        self.scratch = None
        self.sort = False
        self.device = None
        self.index = -1
        self.rows = ()
        self.refs = ()
        self.limbs = ()

    @staticmethod
    def _static(op: SlotUpdate):
        return (op.table, op.kind, op.valid_table, op.order_table, tuple(op.tables),
                (len(op.valids), len(op.wvalids), op.src is None, op.order is None,
                 len(op.srcs)))

    def _same(self, ops) -> bool:
        st = self.static
        if st is None or len(st) != len(ops):
            return False
        for op, (table, kind, vt, ot, tables, counts) in zip(ops, st):
            if op.table is not table or op.kind != kind or op.valid_table is not vt or \
                    op.order_table is not ot or counts != (
                        len(op.valids), len(op.wvalids), op.src is None, op.order is None,
                        len(op.srcs)):
                return False
            if (tables or op.tables) and (len(op.tables) != len(tables) or any(
                    x is not y for x, y in zip(op.tables, tables))):
                return False
        return True

    def _pack(self, ops) -> None:
        if len(ops) > _MAX_UPD_OPS:
            raise NotImplementedError("slot_update: more aggregates than one launch takes")
        t0 = ops[0].table
        cap, dev = int(t0.shape[0]), t0.device
        for op in ops:
            _check_table(op, cap)
            for x in [op.table, op.valid_table, op.order_table] + op.tables:
                if x is not None and (x.device != dev or not x.is_contiguous()):
                    raise ValueError(f"slot_update: a table on {x.device} (non-contiguous or "
                                     f"not on {dev})")
        words = (cuda_lib.ctypes.c_longlong * (_UPD_HEAD + _UPD_OP_WORDS * len(ops)))()
        words[_UW_CAP], words[_UW_NOPS] = cap, len(ops)
        rows = []
        scratch_words = scratch_bytes = 0
        for o, op in enumerate(ops):
            b = _UPD_HEAD + o * _UPD_OP_WORDS
            words[b + _UO_KIND] = op.kind
            words[b + _UO_FLOAT] = int(op.table.is_floating_point())
            words[b + _UO_ESIZE] = op.table.element_size()
            words[b + _UO_NVALID] = len(op.valids)
            words[b + _UO_NWVALID] = len(op.wvalids)
            words[b + _UO_TABLE] = op.table.data_ptr()
            for at, x in ((_UO_VALID_TABLE, op.valid_table), (_UO_ORDER_TABLE, op.order_table)):
                words[b + at] = 0 if x is None else x.data_ptr()
            for q, x in enumerate(op.tables):
                words[b + _UO_LIMB_TABLE + q] = x.data_ptr()
            rows.append((b,) + _row_dtypes(op))
            lex = op.kind in (UPD_LEXMIN, UPD_LEXMAX)
            scratch_words += 1 if op.kind == UPD_FIRST else 2 if lex else 0
            scratch_bytes += 1 if lex or op.kind == UPD_RENORM else 0
        # csrc/slot_update.cu's scratch: FIRST's winning row and LEX's two
        # keys a slot (int64), the marks of RENORM and LEX (a byte a slot,
        # each table 8-byte aligned)
        nbytes = scratch_words * cap * 8 + scratch_bytes * ((cap + 7) // 8 * 8)
        # zero now; each call's last pass leaves it zero again
        self.scratch = torch.zeros(nbytes, dtype=torch.uint8, device=dev) if nbytes else None
        words[_UW_SCRATCH] = self.scratch.data_ptr() if nbytes else 0
        words[_UW_SCRATCH_BYTES] = nbytes
        self.static = [self._static(op) for op in ops]
        self.words, self.rows, self.device = words, rows, dev
        self.index = t0.get_device()
        self.sort = any(op.folds for op in ops)
        self.limbs = cuda_lib.limb_keys("slot_update", [
            f"renorm{1 + len(op.tables)}" if op.kind == UPD_RENORM else _UPD_LIMB_NAMES[op.kind]
            for op in ops if op.kind >= UPD_ADD_LO32])

    def _row(self, p: torch.Tensor, n: int, dtype) -> int:
        """A row plane's pointer, after its check."""
        if p.dtype is not dtype:
            raise TypeError(f"slot_update: a row plane of {p.dtype}, expected {dtype}")
        if p.numel() != n or p.dim() != 1 or p.get_device() != self.index or \
                not p.is_contiguous():
            raise ValueError(f"slot_update: a row plane of {tuple(p.shape)} on {p.device}, "
                             f"expected ({n},) on {self.device}, contiguous")
        return p.data_ptr()

    def _refs(self, ops) -> None:
        """Every row plane the ops read: (op, attribute, index or -1, word,
        dtype), in op order."""
        for op, (_b, src_t, _o, limb_t) in zip(ops, self.rows):
            if src_t is None and op.src is not None:
                raise TypeError(f"slot_update: op kind {op.kind} takes no source")
            if limb_t is not None and len(op.srcs) != 2:
                raise TypeError("slot_update: a wide extreme takes two limb sources")
        refs = []
        for o, (op, (b, src_t, order_t, limb_t)) in enumerate(zip(ops, self.rows)):
            if src_t is not None:
                refs.append((o, "src", -1, b + _UO_SRC, src_t))
            refs += [(o, "valids", q, b + _UO_VALID + q, torch.bool)
                     for q in range(len(op.valids))]
            if order_t is not None:
                refs.append((o, "order", -1, b + _UO_ORDER, order_t))
            refs += [(o, "wvalids", q, b + _UO_WVALID + q, torch.bool)
                     for q in range(len(op.wvalids))]
            if limb_t is not None:
                refs += [(o, "srcs", q, b + _UO_LIMB_SRC + q, limb_t) for q in range(2)]
        self.refs = refs

    def bind(self, slots: torch.Tensor, mask: torch.Tensor, ops,
             num_rows: Optional[int] = None):
        """Pack the op list if it is not the packed one, check the batch's
        row planes and write their pointers; returns the words. Rows at or
        past ``num_rows`` (where given) do not exist: the kernels read only
        the rows below it."""
        if not self._same(ops):
            self._pack(ops)
            self._refs(ops)
        n = int(slots.shape[0])
        live = n if num_rows is None else int(num_rows)
        if not 0 <= live <= n:
            raise ValueError(f"slot_update: {live} rows of {n}")
        w, check = self.words, self._row
        w[_UW_N] = live
        w[_UW_SLOTS] = check(slots, n, torch.int64)
        w[_UW_MASK] = check(mask, n, torch.bool)
        for o, attr, q, word, dtype in self.refs:
            p = getattr(ops[o], attr)
            w[word] = check(p if q < 0 else p[q], n, dtype)
        return w

    def launch(self, slots: torch.Tensor, mask: torch.Tensor, ops,
               num_rows: Optional[int] = None) -> None:
        """:meth:`bind`, then K12 (after K5's sort where a float ADD
        folds)."""
        w = self.bind(slots, mask, ops, num_rows)
        if self.device.type != "cuda":
            raise ValueError(f"slot_update: tables on {self.device}, expected CUDA")
        perm = lexsort_indices([slots], w[_UW_N]) if self.sort else None
        w[_UW_PERM] = 0 if perm is None else perm.data_ptr()
        w[_UW_STREAM] = cuda_lib.stream_handle(self.index)
        err = cuda_lib.library().blz_slot_update(w)
        if err:
            self.static = None  # a pass may have left scratch words: pack anew
            cuda_lib.check(err, "slot_update")
        cuda_lib.LAUNCHES["slot_update"] += 1
        if self.limbs:
            cuda_lib.count_limb_launch("slot_update", (), self.limbs)


def slot_update_cuda(slots: torch.Tensor, mask: torch.Tensor, ops,
                     pack: Optional[SlotUpdatePack] = None,
                     num_rows: Optional[int] = None) -> None:
    """K12 on the card (csrc/slot_update.cu): the order-free ops as passes
    of warp-aggregated atomics, FIRST and the wide extremes
    with a tiebreak pass, then a pass a slot; a float ADD folds over the
    rows sorted by slot (K5 sorts them); same tables as
    :func:`slot_update_plain`. ``pack`` keeps the argument words of a
    caller that sends the same op list every batch; rows at or past
    ``num_rows`` (where given) do not exist and are not read."""
    if not ops:
        return
    (pack if pack is not None else SlotUpdatePack()).launch(slots, mask, ops, num_rows)


def slot_update(slots: torch.Tensor, mask: torch.Tensor, ops,
                pack: Optional[SlotUpdatePack] = None, num_rows: Optional[int] = None) -> None:
    """The reference's scatters of one batch into the host table's slot
    tables, in place: K12 on CUDA planes (``pack`` keeps its argument
    words between calls), the plain version on CPU ones. Rows at or past
    ``num_rows`` (where given) do not exist."""
    if slots.is_cuda:
        slot_update_cuda(slots, mask, ops, pack, num_rows)
    else:
        slot_update_plain(slots, mask, ops, num_rows)


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


def segment_cumsum(vals: np.ndarray, valid: np.ndarray,
                   seg_start: np.ndarray, carry_sum=0, carry_cnt: int = 0):
    """Inclusive per-row (sum, count) of ``vals`` masked by ``valid``,
    restarting at every True in ``seg_start``; head rows continue the carried
    accumulators. Works on numeric AND object (Decimal) planes: one global
    cumsum in row order with per-segment base subtraction
    (blaze_tpu/core/kernels.py:406, copied)."""
    masked = np.where(valid, vals, 0)
    cs = np.cumsum(masked)
    cc = np.cumsum(valid.astype(np.int64))
    si = seg_start_index(seg_start)
    prev = np.clip(si - 1, 0, None)
    out_s = cs - np.where(si >= 1, cs[prev], 0)
    out_c = cc - np.where(si >= 1, cc[prev], 0)
    head = si < 0
    if head.any():
        out_s[head] += carry_sum
        out_c[head] += carry_cnt
    return out_s, out_c


def segment_running_reduce(vals: np.ndarray, valid: np.ndarray,
                           seg_start: np.ndarray, is_min: bool, carry=None):
    """Per-row running min/max within segments (restarting at ``seg_start``),
    invalid rows transparent; ``carry`` (or None) is the extremum of the open
    head segment. log2(n) masked Hillis-Steele doubling passes with numpy's
    ``minimum``/``maximum`` (so NaN propagates); rows whose running count
    is 0 hold an identity sentinel (numeric) or None (object), which the
    caller nulls out by the paired count (blaze_tpu/core/kernels.py:427,
    copied)."""
    n = len(vals)
    si = seg_start_index(seg_start)
    begin = np.where(si >= 0, si, 0)
    if vals.dtype == object:
        def _comb2(a, b):
            if a is None:
                return b
            if b is None:
                return a
            return min(a, b) if is_min else max(a, b)
        comb = np.frompyfunc(_comb2, 2, 1)
        out = np.where(valid, vals, None)
    else:
        if np.issubdtype(vals.dtype, np.floating):
            sent = np.array(np.inf if is_min else -np.inf, dtype=vals.dtype)
        else:
            info = np.iinfo(vals.dtype)
            sent = np.array(info.max if is_min else info.min, dtype=vals.dtype)
        comb = np.minimum if is_min else np.maximum
        out = np.where(valid, vals, sent)
    idx = np.arange(n, dtype=np.int64)
    off = 1
    while off < n:
        ok = idx - off >= begin
        if not ok.any():
            break
        out = np.where(ok, comb(out, out[np.clip(idx - off, 0, None)]), out)
        off <<= 1
    head = si < 0
    if carry is not None and head.any():
        out[head] = comb(out[head], carry)
    return out


# -- K13: the segmented (sum, count) scan ------------------------------------------
#
# The reference's _seg_scan (blaze_tpu/core/kernels.py:469) takes its float
# prefix with jnp.cumsum, which XLA on the CPU lowers to a blocked scan:
# sequential inclusive prefixes inside 16-row blocks (the plane zero-padded
# to a multiple of 16), the block totals scanned the same way, recursively,
# and each block's exclusive prefix added to its rows. Both the twin and K13
# associate float sums in exactly that order, so they agree with the
# reference bit for bit; integer sums are exact (and wrap) in any order.

SCAN_BLOCK = 16


def _blocked_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of a 1-d plane in XLA's 16-block order. The
    in-block prefix is 15 elementwise adds, not ``torch.cumsum``: that
    accumulates float32 in double on the CPU and in another order on the
    card."""
    n = int(x.shape[0])
    if n <= 1:
        return x.clone()
    m = -(-n // SCAN_BLOCK)
    p = torch.zeros(m * SCAN_BLOCK, dtype=x.dtype, device=x.device)
    p[:n] = x
    p = p.view(m, SCAN_BLOCK)
    cols = [p[:, 0]]
    for j in range(1, SCAN_BLOCK):
        cols.append(cols[-1] + p[:, j])
    r = torch.stack(cols, dim=1)
    if m > 1:
        tot = _blocked_cumsum(r[:, -1].contiguous())
        excl = torch.cat([torch.zeros(1, dtype=x.dtype, device=x.device), tot[:-1]])
        r = r + excl[:, None]
    return r.reshape(-1)[:n]


def segment_scan_plain(data: torch.Tensor, validity: torch.Tensor,
                       exists: torch.Tensor, seg_start: torch.Tensor,
                       carry_sum, carry_cnt: int):
    """Plain PyTorch twin of K13, the same function as
    blaze_tpu/core/kernels.py:_seg_scan over capacity-long planes: per-row
    (sum, count) of the valid, existing rows, restarting at each True of
    ``seg_start``; rows before the first start continue the carry. Integer
    data sums in int64; float32 stays float32."""
    n = int(data.shape[0])
    dev = data.device
    si = torch.cummax(torch.where(seg_start, iota(n, dev),
                                  torch.full((), -1, dtype=torch.int64, device=dev)),
                      dim=0).values
    if not data.is_floating_point():
        data = data.to(torch.int64)
    valid = validity & exists
    zero = torch.zeros((), dtype=data.dtype, device=dev)
    cs = _blocked_cumsum(torch.where(valid, data, zero))
    cc = _blocked_cumsum(valid.to(torch.int64))
    prev = (si - 1).clamp(min=0)
    has_base = si >= 1
    out_s = cs - torch.where(has_base, cs[prev], zero)
    out_c = cc - torch.where(has_base, cc[prev], torch.zeros_like(cc[:1]))
    head = si < 0
    carry = float(carry_sum) if data.is_floating_point() else int(carry_sum)
    out_s = out_s + torch.where(head, torch.tensor(carry, dtype=data.dtype, device=dev), zero)
    out_c = out_c + torch.where(head, torch.tensor(int(carry_cnt), device=dev),
                                torch.zeros_like(cc[:1]))
    return out_s, out_c


# csrc/seg_scan.cu's data kinds
_SCAN_KINDS = {torch.int64: 0, torch.int32: 1, torch.int16: 2, torch.int8: 3,
               torch.float32: 4, torch.float64: 5}


def seg_scan_scratch_words(n: int) -> int:
    """Words of each level buffer csrc/seg_scan.cu needs for ``n`` rows: the
    block totals of every level above the rows (n/16, n/256, ... down to
    one)."""
    total = 0
    m = n
    while m > 1:
        m = -(-m // SCAN_BLOCK)
        total += m
    return max(total, 1)


def segment_scan_cuda(data: torch.Tensor, validity: torch.Tensor,
                      exists: torch.Tensor, seg_start: torch.Tensor,
                      carry_sum, carry_cnt: int):
    """K13 on the card (csrc/seg_scan.cu): same contract as
    :func:`segment_scan_plain`."""
    cuda_lib.require_cuda("segment_scan", data, validity, exists, seg_start)
    n = int(data.shape[0])
    kind = _SCAN_KINDS.get(data.dtype)
    if kind is None:
        raise TypeError(f"segment_scan: data dtype {data.dtype}")
    for name, t in (("validity", validity), ("exists", exists), ("seg_start", seg_start)):
        if t.dtype != torch.bool or t.shape != (n,):
            raise TypeError(f"segment_scan: {name} must be bool of shape ({n},)")
    if data.shape != (n,) or n < 1:
        raise ValueError(f"segment_scan: data shape {tuple(data.shape)}")
    sum_dt = data.dtype if data.is_floating_point() else torch.int64
    dev = data.device
    out_s = torch.empty(n, dtype=sum_dt, device=dev)
    out_c = torch.empty(n, dtype=torch.int64, device=dev)
    # cs, cc, si: the row-level prefixes; then each level's block totals
    rows = torch.empty((3, n), dtype=torch.int64, device=dev)
    levels = torch.empty((3, seg_scan_scratch_words(n)), dtype=torch.int64, device=dev)
    carry_f = float(carry_sum) if data.is_floating_point() else 0.0
    carry_i = 0 if data.is_floating_point() else int(carry_sum)
    err = cuda_lib.library().blz_segment_scan(
        data.data_ptr(), kind, validity.data_ptr(), exists.data_ptr(),
        seg_start.data_ptr(), n, carry_f, carry_i, int(carry_cnt),
        rows.data_ptr(), levels.data_ptr(), out_s.data_ptr(), out_c.data_ptr(),
        cuda_lib.stream_of(dev))
    cuda_lib.check(err, "segment_scan")
    cuda_lib.LAUNCHES["segment_scan"] += 1
    return out_s, out_c


def segment_scan(data: torch.Tensor, validity: torch.Tensor, exists: torch.Tensor,
                 seg_start: torch.Tensor, carry_sum, carry_cnt: int):
    """The segmented (sum, count) scan: K13 on CUDA planes, the plain
    version on CPU ones."""
    fn = segment_scan_cuda if data.is_cuda else segment_scan_plain
    return fn(data, validity, exists, seg_start, carry_sum, carry_cnt)


def segment_scan_planes(data: torch.Tensor, validity: torch.Tensor,
                        exists: torch.Tensor, seg_start: np.ndarray,
                        carry_sum, carry_cnt: int):
    """A device column's segmented (sum, count) scan in one launch
    (blaze_tpu/core/kernels.py:490): ``seg_start`` has the batch's n <=
    capacity rows and is padded here; padding rows have ``exists`` False,
    so they never perturb the prefixes below n. Returns numpy (sum, count)
    planes of the n rows, for the host's frame backfill."""
    cap = int(data.shape[0])
    n = len(seg_start)
    pad = np.zeros(cap, dtype=bool)
    pad[:n] = seg_start
    out_s, out_c = segment_scan(data, validity, exists,
                                torch.from_numpy(pad).to(data.device), carry_sum, carry_cnt)
    return out_s[:n].cpu().numpy(), out_c[:n].cpu().numpy()


# -- K17: the device mesh's all-to-all ----------------------------------------------
#
# blaze_tpu/parallel/mesh.py:215 _exchange_compact_step with the pack of
# MeshBatchExchange.run (:474-493): every plane of every source slot moved
# into the receive buffers of every destination slot in one launch
# (csrc/mesh.cu). Output position d * n * chunk + s * chunk + q is the q-th
# position of the chunk slot s sends to slot d; in exchange mode it is row
# k = rnd * scap + q % scap of reducer r = d * G + q // scap in slot s's
# stable order by reducer (``routes[s]``, K5b), live when k < counts[s, r];
# in tile mode (``counts`` None) it is row q, live when routes[s][q] == d.
# Dead positions are 0 in every plane (data 0, validity False).


def _mesh_geometry(n: int, chunk: int, counts: Optional[np.ndarray], G: int, scap: int):
    tile = counts is None
    if n <= 0 or chunk <= 0:
        raise ValueError(f"mesh_all_to_all: {n} slots, chunk {chunk}")
    if not tile and (counts.shape != (n, n * G) or chunk != G * scap or scap <= 0):
        raise ValueError(f"mesh_all_to_all: counts {counts.shape} for {n} slots, "
                         f"G={G}, scap={scap}, chunk={chunk}")
    return tile, n * n * chunk


def mesh_all_to_all_plain(slot_planes, routes, chunk: int, device, dtypes,
                          counts: Optional[np.ndarray] = None, G: int = 1, scap: int = 1,
                          rnd: int = 0):
    """Plain PyTorch twin of K17. ``slot_planes[s]`` holds source slot s's
    planes (None for an empty slot), in the order and of the ``dtypes``
    given; ``routes[s]`` its int64 order by reducer (exchange mode) or its
    int64 reducer id per row (tile mode, ``counts`` None). Returns (output
    planes of n * n * chunk rows, the live plane, the int64 live count each
    destination slot receives)."""
    n = len(slot_planes)
    tile, total = _mesh_geometry(n, chunk, counts, G, scap)
    # n * n * chunk positions: no cached iota (it would hold a plane of
    # every receive size for the process's life)
    pos = torch.arange(total, dtype=torch.int64, device=device)
    seg_len = n * chunk
    d = pos // seg_len
    s = (pos % seg_len) // chunk
    q = pos % chunk
    present = [i for i in range(n) if routes[i] is not None]
    live = torch.zeros(total, dtype=torch.bool, device=device)
    row = torch.zeros(total, dtype=torch.int64, device=device)
    if present:
        lens = torch.tensor([int(routes[i].shape[0]) if routes[i] is not None else 0
                             for i in range(n)], dtype=torch.int64)
        route_off = (torch.cumsum(lens, 0) - lens).to(device)
        route_cat = torch.cat([routes[i].to(torch.int64) for i in present])
        has = torch.tensor([routes[i] is not None for i in range(n)], device=device)[s]
        if tile:
            at = torch.where(has, route_off[s] + q, 0).clamp(max=route_cat.shape[0] - 1)
            live = has & (route_cat[at] == d)
            row = torch.where(live, q, 0)
        else:
            ct = torch.from_numpy(np.ascontiguousarray(counts, dtype=np.int64)).to(device)
            st = torch.cumsum(ct, 1) - ct
            r = d * G + q // scap
            k = rnd * scap + q % scap
            live = has & (k < ct[s, r])
            at = torch.where(live, route_off[s] + st[s, r] + k, 0)
            row = torch.where(live, route_cat[at], 0)
    outs = []
    for p, dt in enumerate(dtypes):
        if not present:
            outs.append(torch.zeros(total, dtype=dt, device=device))
            continue
        caps = torch.tensor([int(slot_planes[i][p].shape[0]) if slot_planes[i] is not None
                             else 0 for i in range(n)], dtype=torch.int64)
        off = (torch.cumsum(caps, 0) - caps).to(device)
        cat = torch.cat([slot_planes[i][p] for i in range(n) if slot_planes[i] is not None])
        at = torch.where(live, off[s] + row, 0).clamp(max=max(cat.shape[0] - 1, 0))
        outs.append(_zero_where(live, cat[at]) if cat.shape[0] else
                    torch.zeros(total, dtype=dt, device=device))
    counts_out = torch.bincount(d[live], minlength=n)[:n]
    return outs, live, counts_out


# csrc/mesh.cu blz_mesh_all_to_all's argument words: the header, then
# route[n], src[n * np] and dst[np] from _MW_PTRS
(_MW_N, _MW_NP, _MW_N8, _MW_N4, _MW_N2, _MW_N1, _MW_G, _MW_SCAP, _MW_ROUND, _MW_TILE,
 _MW_CHUNK, _MW_LIVE, _MW_COUNTS, _MW_DEV_TABLE, _MW_HOST_TABLE, _MW_STREAM,
 _MW_PTRS) = range(17)
# csrc/mesh.cu: the by-value pointer table's bounds, planes a launch
_MESH_MAX_SLOTS, _MESH_MAX_SRC, _MESH_MAX_PLANES, _MESH_SMEM_PLANES = 64, 256, 64, 256
_MESH_SIGS = threading.local()


def _mesh_signature(n: int, G: int, scap: int, chunk: int, tile: bool, dtypes):
    """K17's per-signature plan: the planes' order by element size (8, 4,
    2, 1 bytes; csrc/mesh.cu's groups), the count of each size, whether the
    pointers go by value, and the staged table's words. Checked once a
    (dtypes, n, G, scap, chunk, mode) signature, per thread."""
    sigs = getattr(_MESH_SIGS, "by_sig", None)
    if sigs is None:
        sigs = _MESH_SIGS.by_sig = {}
    key = (n, G, scap, chunk, tile, *dtypes)
    plan = sigs.get(key)
    if plan is not None:
        return plan
    sizes = [dt.itemsize for dt in dtypes]
    if any(z not in (1, 2, 4, 8) for z in sizes):
        raise TypeError(f"mesh_all_to_all: element sizes {sizes}")
    np_ = len(dtypes)
    order = sorted(range(np_), key=lambda p: -sizes[p])
    by_value = n <= _MESH_MAX_SLOTS and n * np_ <= _MESH_MAX_SRC and np_ <= _MESH_MAX_PLANES
    table = (0 if tile else 2 * n * n * G) + (0 if by_value else n + n * np_ + np_)
    plan = (order, [sizes.count(z) for z in (8, 4, 2, 1)], table)
    if len(sigs) >= 64:
        sigs.clear()
    sigs[key] = plan
    return plan


def _mesh_plane_error(sp, dtypes, p, dt, device):
    if p.dtype is not dt:
        raise TypeError(f"mesh_all_to_all: slot planes {[q.dtype for q in sp]}, "
                        f"expected {list(dtypes)}")
    raise ValueError(f"mesh_all_to_all: a plane {tuple(p.shape)} on {p.device}, expected a "
                     f"contiguous one-dimensional CUDA plane on {device}")


def mesh_all_to_all_cuda(slot_planes, routes, chunk: int, device, dtypes,
                         counts: Optional[np.ndarray] = None, G: int = 1, scap: int = 1,
                         rnd: int = 0):
    """K17 on the card (csrc/mesh.cu): same contract as
    :func:`mesh_all_to_all_plain`, one launch for every plane of every
    slot (a launch for each 256 planes past that). The output planes and the live plane are one allocation a dtype;
    the count matrix and its prefix go to the card through the library's
    pinned buffer (with the pointers, past the parameter limit) into a
    small int64 tensor whose tail is the returned receive counts, written
    by the kernel (exchange mode; zeroed here and counted by atomics in
    tile mode). The argument words go in a reused buffer."""
    n = len(slot_planes)
    tile, total = _mesh_geometry(n, chunk, counts, G, scap)
    if len(dtypes) > _MESH_SMEM_PLANES:  # a launch for each 256 planes
        parts = [mesh_all_to_all_cuda(
            [None if sp is None else sp[i:i + _MESH_SMEM_PLANES] for sp in slot_planes],
            routes, chunk, device, dtypes[i:i + _MESH_SMEM_PLANES], counts, G, scap, rnd)
            for i in range(0, len(dtypes), _MESH_SMEM_PLANES)]
        return [o for outs, _l, _c in parts for o in outs], parts[0][1], parts[0][2]
    order, by_size, table = _mesh_signature(n, G, scap, chunk, tile, dtypes)
    np_ = len(dtypes)
    device = torch.device(device)
    index = device.index if device.index is not None else \
        torch.cuda.current_device() if device.type == "cuda" else -1
    if index < 0:
        raise ValueError(f"mesh_all_to_all: outputs for {device}, expected CUDA")
    words = [n, np_, *by_size, G, scap, rnd, int(tile), chunk, 0, 0, 0, 0, 0]
    words += [0] * n
    for sp, rt in zip(slot_planes, routes):
        if (sp is None) != (rt is None):
            raise ValueError("mesh_all_to_all: a slot with planes and no route, or the reverse")
        if sp is None:
            words += [0] * np_
            continue
        if len(sp) != np_:
            raise TypeError(f"mesh_all_to_all: {len(sp)} slot planes, expected {np_}")
        # get_device() is -1 off the card: one check for the device and CUDA
        for p, dt in zip(sp, dtypes):
            if p.dtype is not dt or p.get_device() != index or p.dim() != 1 or \
                    not p.is_contiguous():
                _mesh_plane_error(sp, dtypes, p, dt, device)
        if rt.dtype is not torch.int64 or rt.get_device() != index or rt.dim() != 1 or \
                not rt.is_contiguous() or (tile and rt.shape[0] != chunk):
            raise ValueError(f"mesh_all_to_all: route {rt.dtype} of {tuple(rt.shape)} "
                             f"on {rt.device}, expected a contiguous int64 plane on {device}")
        if tile and any(p.shape[0] < chunk for p in sp):
            raise ValueError("mesh_all_to_all: a tile-mode plane shorter than the tile")
        words += [sp[p].data_ptr() for p in order]
    words[_MW_PTRS:_MW_PTRS + n] = [0 if r is None else r.data_ptr() for r in routes]
    outs, ptrs = _alloc_planes(list(dtypes) + [torch.bool], total, device)
    live = outs.pop()
    words += [ptrs[p] for p in order]
    tab = torch.empty(table + n, dtype=torch.int64, device=device)
    live_counts = tab[table:]
    host = None
    if not tile:
        ct = np.ascontiguousarray(counts, dtype=np.int64)
        host = np.concatenate([ct.ravel(), (np.cumsum(ct, 1) - ct).ravel()])
    else:
        live_counts.zero_()
    words[_MW_LIVE], words[_MW_COUNTS], words[_MW_DEV_TABLE] = \
        ptrs[-1], live_counts.data_ptr(), tab.data_ptr()
    words[_MW_HOST_TABLE] = 0 if host is None else host.ctypes.data
    words[_MW_STREAM] = cuda_lib.stream_handle(index)
    err = cuda_lib.library().blz_mesh_all_to_all(_words(words))
    cuda_lib.check(err, "mesh_all_to_all")
    cuda_lib.LAUNCHES["mesh_all_to_all"] += 1
    return outs, live, live_counts


def mesh_all_to_all(slot_planes, routes, chunk: int, device, dtypes,
                    counts: Optional[np.ndarray] = None, G: int = 1, scap: int = 1,
                    rnd: int = 0):
    """One round of the mesh's all-to-all: K17 on the card, the plain
    version on the CPU (by ``device``)."""
    fn = mesh_all_to_all_cuda if torch.device(device).type == "cuda" \
        else mesh_all_to_all_plain
    return fn(slot_planes, routes, chunk, torch.device(device), dtypes, counts, G, scap, rnd)
