"""The device mesh: exchanges and fused stages across n slots.

The counterpart of blaze_tpu/parallel/mesh.py. The JAX package runs its
mesh single-controller: one ``Session(mesh=...)`` drives every device of
a ``jax.sharding.Mesh`` from the driver, and its CI runs that mesh as 8
virtual devices in one CPU process. The port keeps that shape: a
``DeviceMesh`` is n slots, each bound to a torch device, driven from one
process. On the card every slot sits on the one H100 (the counterpart of
XLA's forced host device count); a mesh whose slots span several cards
raises (ROADMAP.md Queue 1 item 15: NCCL or peer copies, once a call gets
more than one card).

- ``exchange_and_aggregate`` / ``run_distributed_sum``: local sort and
  segment sum of the valid rows (K1, K5b, K10), Spark murmur3 routing
  (K2) into (n, capacity) masked tiles, the all-to-all (K17 in tile mode),
  re-aggregation of the received rows, and the psum of the row count.
- ``broadcast_join_sum`` / ``run_broadcast_join``: the replicated sorted
  build, a lower-bound probe (K9) and the payload take (K6).
- ``MeshBatchExchange``: the engine's exchange over the mesh. Per-(slot,
  reducer) segments compacted and moved by K17 in bounded rounds; each
  reducer's rows cut out of its slot's buffer with K7 (and put back in
  slot order with K6 after several rounds), device-resident or, past the
  session's budget, in host memory until their reducer reads them.
- ``ShardedFusedRunner``: k <= n same-shape batches of a fused stage in one
  stacked K11 launch (exprs/fused_triton.py).

Nothing here falls back: a kernel that fails to build or launch raises.
"""

from __future__ import annotations

import collections
import logging
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from blaze_tpu_torch.config import Config
from blaze_tpu_torch.core import kernels as K
from blaze_tpu_torch.core.batch import (ColumnarBatch, DeviceColumn, WideColumn,
                                        host_column_error)
from blaze_tpu_torch.exprs import spark_hash
from blaze_tpu_torch.ir import types as T
from blaze_tpu_torch.utils.device import resolve_device

_BIG = int(np.iinfo(np.int64).max)
log = logging.getLogger("blaze_tpu_torch.mesh")


class DeviceMesh:
    """n slots, each bound to a torch device (the one axis of the JAX
    package's 1-D ``Mesh``)."""

    def __init__(self, devices: Sequence[torch.device]):
        if not devices:
            raise ValueError("a device mesh needs at least one slot")
        self.devices = [torch.device(d) for d in devices]
        self.n = len(self.devices)
        if len(set(self.devices)) > 1:
            raise NotImplementedError(
                f"a mesh whose slots span several devices ({sorted(map(str, set(self.devices)))})"
                " is not ported: ROADMAP.md Queue 1 item 15 (NCCL or peer copies)")

    @property
    def device(self) -> torch.device:
        """The device every slot sits on."""
        return self.devices[0]

    def __repr__(self):
        return f"DeviceMesh({self.n} slots on {self.device})"


def visible_devices(device: torch.device) -> int:
    """Devices of ``device``'s kind a config-built mesh may span: the
    visible GPUs, or the one CPU."""
    return torch.cuda.device_count() if device.type == "cuda" else 1


def make_mesh(n_devices: Optional[int] = None,
              device: Optional[Union[str, torch.device]] = None) -> DeviceMesh:
    """``n_devices`` slots on ``device`` (default: the card, as
    ``resolve_device`` decides). ``None`` means one slot per visible device:
    one on a single card; on several cards that mesh spans them and raises."""
    dev = resolve_device(device)
    if n_devices is None:
        if dev.type == "cuda" and visible_devices(dev) > 1:
            return DeviceMesh([torch.device("cuda", i) for i in range(visible_devices(dev))])
        n_devices = 1
    return DeviceMesh([dev] * int(n_devices))


def pmod(hashes: torch.Tensor, n: int) -> torch.Tensor:
    """Spark pmod partition routing from int32 murmur3 hashes."""
    return torch.remainder(hashes.to(torch.int64), n)


# -- 18b: exchange_and_aggregate ----------------------------------------------------


def _segment_sums(keys, live, srcs, name):
    """Group the rows of ``keys`` where ``live`` holds: K1 moves them to the
    front (stable), K5 sorts them by key, K10 cuts equal runs, takes each
    run's key from its first row and sums each of ``srcs`` (None: counts
    the rows) per run. Returns (run keys, the sums) of len(keys) rows,
    zero past the runs. The JAX package gives every dead row key int64 max
    and folds them into one last run of zero sums, which is invalid (its
    key is int64 max); dropping them first gives the same planes, and
    spares K5 and K10 the dead rows."""
    cap = int(keys.shape[0])
    count, planes, _v = K.compact_planes([keys] + [x for x in srcs if x is not None], [],
                                         live)
    ckeys, rest = planes[0], iter(planes[1:])
    ops = [K.AggOp(K.OP_COUNT, None, []) if x is None else K.AggOp(K.OP_ADD, next(rest), [])
           for x in srcs]
    ones = torch.ones(cap, dtype=torch.bool, device=keys.device)
    exists = torch.arange(cap, device=keys.device) < count
    order, starts, nseg, ((uk,), _v) = K.segment_ids([ckeys], [ones], exists, count,
                                                     direct=False)
    emits = [K.AggEmit(K.EMIT_RAW, i, torch.int64) for i in range(len(ops))]
    sums, _first = K.segment_reduce(name, order, starts, nseg, count, ops, emits)
    return uk, sums


def _sorted_segment_agg(keys, vals, valid, num_segments: int):
    """Group by key with a device sort and segment sums (the JAX package's
    ``_sorted_segment_agg``: invalid rows take key int64 max and sort
    last). Returns (unique keys, sums, counts, valid) of ``num_segments``
    rows, which is the input's length; a segment is valid when it counts a
    row and its key is not int64 max."""
    if num_segments != keys.shape[0]:
        raise ValueError(f"_sorted_segment_agg: {num_segments} segments for "
                         f"{keys.shape[0]} rows")
    uk, (sums, counts) = _segment_sums(keys, valid, [vals, None], "seg_agg_partial")
    seg_valid = (counts > 0) & (uk != _BIG)
    return torch.where(seg_valid, uk, 0), sums, counts, seg_valid


def exchange_and_aggregate(mesh: DeviceMesh, capacity: int):
    """The SPMD step of a distributed group-by sum: ``step(keys, vals,
    valid)`` over (n * capacity,) int64 planes, slot s holding rows [s *
    capacity, (s + 1) * capacity), returns each slot's (unique keys, sums,
    counts, valid) of n * capacity rows, concatenated in slot order, and
    the psum of the valid rows."""
    n = mesh.n

    def step(keys, vals, valid):
        tiles, routes = [], []
        for s in range(n):
            sl = slice(s * capacity, (s + 1) * capacity)
            pk, ps, pc, pv = _sorted_segment_agg(keys[sl], vals[sl], valid[sl], capacity)
            # route each partial group to its reducer (Spark murmur3, seed
            # 42, pmod n); invalid groups go nowhere
            pid = spark_hash.murmur3_pmod([pk], [pv], ["i64"], capacity, n)
            routes.append(torch.where(pv, pid.to(torch.int64), n))
            tiles.append([pk, ps, pc])
        (rk, rs, rc), rm, _live = K.mesh_all_to_all(
            tiles, routes, capacity, mesh.device, [torch.int64] * 3)
        outs = [[], [], [], []]
        for d in range(n):
            sl = slice(d * n * capacity, (d + 1) * n * capacity)
            uk, (sums, counts) = _segment_sums(rk[sl], rm[sl], [rs[sl], rc[sl]],
                                               "seg_agg_merge")
            ok = (counts > 0) & (uk != _BIG)
            for o, x in zip(outs, (torch.where(ok, uk, 0), sums, counts, ok)):
                o.append(x)
        total_rows = valid.to(torch.int64).sum()
        return tuple(torch.cat(o) for o in outs) + (total_rows,)

    return step


def run_distributed_sum(keys: np.ndarray, vals: np.ndarray,
                        mesh: Optional[DeviceMesh] = None) -> dict:
    """Global group-by sum over the mesh: {key: (sum, count)} on the host."""
    mesh = mesh or make_mesh()
    n = mesh.n
    total = len(keys)
    per = -(-total // n)
    capacity = 1
    while capacity < per:
        capacity *= 2
    kbuf = np.zeros(n * capacity, dtype=np.int64)
    vbuf = np.zeros(n * capacity, dtype=np.int64)
    mbuf = np.zeros(n * capacity, dtype=bool)
    for d in range(n):
        lo, hi = d * per, min((d + 1) * per, total)
        if hi > lo:
            kbuf[d * capacity: d * capacity + (hi - lo)] = keys[lo:hi]
            vbuf[d * capacity: d * capacity + (hi - lo)] = vals[lo:hi]
            mbuf[d * capacity: d * capacity + (hi - lo)] = True
    dev = mesh.device
    uk, sums, counts, valid, total_rows = exchange_and_aggregate(mesh, capacity)(
        *(torch.from_numpy(x).to(dev) for x in (kbuf, vbuf, mbuf)))
    uk, sums, counts, valid = (x.cpu().numpy() for x in (uk, sums, counts, valid))
    if int(total_rows) != int(mbuf.sum()):
        raise AssertionError(f"psum of rows {int(total_rows)} != {int(mbuf.sum())}")
    out = {}
    for i in np.nonzero(valid)[0]:
        k = int(uk[i])
        s, c = out.get(k, (0, 0))
        out[k] = (s + int(sums[i]), c + int(counts[i]))
    return out


# -- 18c: broadcast_join_sum ---------------------------------------------------------


def broadcast_join_sum(mesh: DeviceMesh, capacity: int, build_capacity: int):
    """The SPMD broadcast-join step: ``step(probe_keys, probe_valid,
    build_keys, build_vals, build_n)``, the probe (n * capacity,) sharded by
    slot, the build (``build_capacity`` sorted keys padded with int64 max,
    payload) replicated; returns (hit, payload per probe row, psum of the
    hits). A probe row hits where the build's lower bound of its key holds
    the key among the first build_n rows (K9), and takes that row's payload
    (K6)."""
    n = mesh.n

    def step(probe_keys, probe_valid, build_keys, build_vals, build_n: int):
        if build_keys.shape[0] != build_capacity:
            raise ValueError(f"broadcast_join_sum: {build_keys.shape[0]} build rows, "
                             f"expected {build_capacity}")
        uniq = build_keys[:max(int(build_n), 1)]
        hits, payloads = [], []
        for s in range(n):
            sl = slice(s * capacity, (s + 1) * capacity)
            codes = K.probe_codes(uniq, int(build_n), probe_keys[sl], probe_valid[sl])
            hit = codes >= 0
            (pay,), _v = K.gather_planes([build_vals], [], codes.clamp(min=0), capacity,
                                         capacity, live=hit)
            hits.append(hit)
            payloads.append(pay)
        hit = torch.cat(hits)
        return hit, torch.cat(payloads), hit.to(torch.int64).sum()

    return step


def run_broadcast_join(probe_keys: np.ndarray, build_keys: np.ndarray,
                       build_vals: np.ndarray, mesh: Optional[DeviceMesh] = None):
    """Inner-join probe rows against a small replicated build side over the
    mesh; returns (payload per probe row or None, total matches)."""
    mesh = mesh or make_mesh()
    n = mesh.n
    total = len(probe_keys)
    per = -(-total // n)
    capacity = 1
    while capacity < per:
        capacity *= 2
    bcap = 1
    while bcap < max(len(build_keys), 1):
        bcap *= 2
    order = np.argsort(build_keys, kind="stable")
    bk = np.full(bcap, _BIG, dtype=np.int64)
    bv = np.zeros(bcap, dtype=np.int64)
    bk[:len(build_keys)] = np.asarray(build_keys)[order]
    bv[:len(build_keys)] = np.asarray(build_vals)[order]
    pk = np.zeros(n * capacity, dtype=np.int64)
    pm = np.zeros(n * capacity, dtype=bool)
    for d in range(n):
        lo, hi = d * per, min((d + 1) * per, total)
        if hi > lo:
            pk[d * capacity: d * capacity + (hi - lo)] = probe_keys[lo:hi]
            pm[d * capacity: d * capacity + (hi - lo)] = True
    dev = mesh.device
    hit, payload, tot = broadcast_join_sum(mesh, capacity, bcap)(
        *(torch.from_numpy(x).to(dev) for x in (pk, pm, bk, bv)), len(build_keys))
    hit, payload = hit.cpu().numpy(), payload.cpu().numpy()
    out = []
    for d in range(n):
        lo, hi = d * per, min((d + 1) * per, total)
        for i in range(hi - lo):
            j = d * capacity + i
            out.append(int(payload[j]) if hit[j] else None)
    return out, int(tot)


# -- 18a: the engine's exchange ------------------------------------------------------


def _exchange_compact_step(mesh: DeviceMesh, slot_planes, routes, dtypes, counts,
                           G: int, scap: int, rnd: int):
    """One round of the compacted all-to-all (K17): every slot's rows of
    round ``rnd`` moved into the receive buffers of the slots that hold
    their reducers. Returns (planes, live plane, live count a slot), n * n *
    G * scap rows each."""
    return K.mesh_all_to_all(slot_planes, routes, G * scap, mesh.device, dtypes, counts,
                             G, scap, rnd)


class HostBatch:
    """A reducer's rows in host memory: per column its numpy data planes
    (three for a decimal(19..38)) and validity, uploaded when the reducer
    reads them (the JAX package's ``HostBatch``)."""

    def __init__(self, schema: T.Schema, planes, num_rows: int):
        self.schema = schema
        self.planes = planes   # per column: ([data planes], validity)
        self.num_rows = num_rows

    def to_columnar(self, device, conf: Optional[Config] = None) -> ColumnarBatch:
        cap = (conf or Config()).capacity_for(self.num_rows)
        n = self.num_rows

        def up(x):
            buf = np.zeros(cap, dtype=x.dtype)
            buf[:n] = x
            return torch.from_numpy(buf).to(device)

        return ColumnarBatch(self.schema, _columns(self.schema, [
            ([up(d) for d in datas], up(valid)) for datas, valid in self.planes]), n)


def _columns(schema: T.Schema, groups) -> list:
    """Columns from per-column (data planes, validity): three data planes
    make a WideColumn."""
    return [WideColumn(f.dtype, *ds, v) if len(ds) == 3 else DeviceColumn(f.dtype, ds[0], v)
            for f, (ds, v) in zip(schema.fields, groups)]


def _column_planes(c) -> List[torch.Tensor]:
    """A column's planes as the exchange moves them: its data planes, then
    its validity once."""
    if isinstance(c, WideColumn):
        return c.planes() + [c.validity]
    return [c.data, c.validity]


class MeshBatchExchange:
    """Exchange ColumnarBatches over the mesh (the JAX package's
    ``MeshBatchExchange``). Every column moves as device planes: a
    decimal(19..38) as its three limb planes (the JAX package dictionary-
    encodes it on the host); a BINARY host column raises (item 6b).
    Partition ids come from the same Repartitioner as the in-process
    exchange, so a row lands on the same reducer either way."""

    def __init__(self, mesh: DeviceMesh):
        self.mesh = mesh
        self.n = mesh.n
        self.last_wire_bytes = 0
        self.last_wire_bytes_uncompacted = 0
        self.last_payload_bytes = 0
        self.last_device_resident = True
        self.last_rounds = 0
        self.last_recv_counts: List[torch.Tensor] = []

    def run(self, schema: T.Schema, shard_batches: List[Optional[ColumnarBatch]],
            shard_pids: List, num_reducers: int,
            device_resident_budget: Optional[int] = None,
            conf: Optional[Config] = None) -> List[Optional[Union[ColumnarBatch, HostBatch]]]:
        """``shard_batches[s]``: the batch slot s holds (or None);
        ``shard_pids[s]``: its rows' reducer ids (int32, a tensor or numpy).
        Returns per reducer a ColumnarBatch, a HostBatch past the resident
        budget, or None when it gets no row. Reducers are grouped G =
        ceil(R / n) a slot; each reducer's rows come in slot order, each
        slot's in its row order, whatever the slot count and rounds."""
        conf = conf or Config()
        n = self.n
        dev = self.mesh.device
        R = num_reducers
        G = -(-R // n)
        Rpad = G * n
        if len(shard_batches) != n or len(shard_pids) != n:
            raise ValueError(f"{len(shard_batches)} shard batches for {n} slots")
        for f in schema.fields:
            if isinstance(f.dtype, T.BinaryType):
                raise host_column_error(f"a mesh exchange of column {f.name!r}")
        live_slots = [s for s, b in enumerate(shard_batches) if b is not None and b.num_rows]
        pids = [None] * n
        for s in live_slots:
            p = shard_pids[s]
            p = torch.from_numpy(np.asarray(p)) if not isinstance(p, torch.Tensor) else p
            pids[s] = p.to(device=dev, dtype=torch.int64)[:shard_batches[s].num_rows]
        # counts first: the (n, Rpad) count matrix, pulled once
        counts = np.zeros((n, Rpad), np.int64)
        if live_slots:
            counted = torch.stack([torch.bincount(pids[s], minlength=Rpad)[:Rpad]
                                   for s in live_slots]).cpu().numpy()
            counts[live_slots] = counted
        maxc = int(counts.max()) if counts.size else 0

        # plane dtypes per column (wide: three limbs) and the slots' planes
        first = shard_batches[live_slots[0]] if live_slots else None
        col_dtypes = []
        for i, f in enumerate(schema.fields):
            if first is not None:
                col_dtypes.append([p.dtype for p in _column_planes(first.columns[i])[:-1]])
            else:
                col_dtypes.append([T.torch_dtype(f.dtype) or torch.int64]
                                  * (3 if T.is_wide_decimal(f.dtype) else 1))
        dtypes = [dt for cd in col_dtypes for dt in cd + [torch.bool]]
        slot_planes = [None] * n
        for s in live_slots:
            slot_planes[s] = [p for c in shard_batches[s].columns for p in _column_planes(c)]

        slot_bytes = 1 + sum(sum(dt.itemsize for dt in cd) + 1 for cd in col_dtypes)
        budget = int(conf.mesh_exchange_round_bytes)
        gran = 512
        while gran > 8 and Rpad * gran * slot_bytes > budget:
            gran //= 2
        if Rpad * gran * slot_bytes > budget:
            log.warning("mesh exchange: %d reducer segments at min granularity %d exceed "
                        "mesh_exchange_round_bytes=%d", Rpad, gran, budget)
        scap_need = max(gran, -(-maxc // gran) * gran)
        scap_cap = max(gran, (budget // (Rpad * slot_bytes)) // gran * gran)
        scap = min(scap_need, scap_cap)
        rounds = max(1, -(-maxc // scap))
        chunk = G * scap
        seg_len = Rpad * scap

        total_rows = int(counts.sum())
        self.last_payload_bytes = total_rows * slot_bytes * 2
        resident_budget = conf.mesh_device_resident_max_bytes \
            if device_resident_budget is None else device_resident_budget
        device_resident = self.last_payload_bytes <= resident_budget
        self.last_device_resident = device_resident
        self.last_rounds = rounds

        routes = [None] * n
        for s in live_slots:
            routes[s] = K.lexsort_indices([pids[s]], widths=[K.pid_width(Rpad)])
        red_cnt = counts.sum(axis=0)
        pieces: List[list] = [[] for _ in range(Rpad)]
        self.last_wire_bytes = 0
        self.last_recv_counts = []
        nd = len(dtypes)
        for t in range(rounds):
            outs, live, recv = _exchange_compact_step(self.mesh, slot_planes, routes, dtypes,
                                                      counts, G, scap, t)
            self.last_recv_counts.append(recv)
            self.last_wire_bytes += n * seg_len * (1 + sum(dt.itemsize for dt in dtypes))
            # each reducer's rows of this round: in slot d's buffer, a run
            # of c rows at every peer chunk's segment g (K7 over those runs)
            c_live = np.clip(counts - t * scap, 0, scap)        # (n, Rpad)
            for r in range(Rpad):
                if red_cnt[r] == 0 or not c_live[:, r].any():
                    continue
                d, g = divmod(r, G)
                srcs = [s for s in range(n) if c_live[s, r]]
                base = [d * n * chunk + s * chunk + g * scap for s in srcs]
                m = int(c_live[:, r].sum())
                datas, _v = K.concat_planes([[o[b:b + scap] for b in base] for o in outs], [],
                                            [int(c_live[s, r]) for s in srcs],
                                            conf.capacity_for(m))
                if not device_resident:
                    datas = [x[:m].cpu().numpy() for x in datas]
                pieces[r].append((datas, c_live[:, r]))

        cap = conf.capacity_for(max([b.num_rows for b in shard_batches if b is not None]
                                    or [1]))
        self.last_wire_bytes_uncompacted = n * n * cap * (
            1 + sum(dt.itemsize for dt in dtypes))

        def group(planes):
            """The exchange's flat plane list as (data planes, validity) a
            column."""
            out, i = [], 0
            for cd in col_dtypes:
                out.append((planes[i:i + len(cd)], planes[i + len(cd)]))
                i += len(cd) + 1
            return out

        results: List[Optional[Union[ColumnarBatch, HostBatch]]] = []
        for r in range(R):
            ps = pieces[r]
            cnt = int(sum(int(cl.sum()) for _, cl in ps))
            if cnt == 0:
                results.append(None)
                continue
            # each reducer's rows slot-major whatever the rounds: a skewed
            # extra round appends rows round-major, so they are put back
            perm = None
            if len(ps) > 1:
                key = np.concatenate([np.repeat(np.arange(n), cl) for _, cl in ps])
                p_ = np.argsort(key, kind="stable")
                if not np.array_equal(p_, np.arange(len(p_))):
                    perm = p_
            if device_resident:
                planes = ps[0][0]
                if len(ps) > 1:
                    sizes = [int(cl.sum()) for _, cl in ps]
                    planes, _v = K.concat_planes([[pc[0][p] for pc in ps] for p in range(nd)],
                                                 [], sizes, conf.capacity_for(cnt))
                    if perm is not None:
                        planes, _v = K.gather_planes(
                            planes, [], torch.from_numpy(perm).to(dev),
                            conf.capacity_for(cnt), cnt)
                results.append(ColumnarBatch(schema, _columns(schema, group(planes)), cnt))
            else:
                planes = [np.concatenate([pc[0][p] for pc in ps]) for p in range(nd)]
                if perm is not None:
                    planes = [x[perm] for x in planes]
                results.append(HostBatch(schema, group(planes), cnt))
        return results


# -- 18d: the sharded fused stage ----------------------------------------------------


class ShardedFusedRunner:
    """Runs a fused chain segment over k <= n consecutive same-shape
    batches at once: one stacked K11 launch (the stack index on the grid's
    second axis), then K1 per filtered group per batch, and one count sync
    for the stack (the JAX package runs the per-batch closure under
    ``shard_map``, one batch a device). Each batch's result is exactly the
    single-batch kernel's. ``counters`` (the session's) counts
    ``sharded_batches``."""

    def __init__(self, mesh: DeviceMesh, counters: Optional[collections.Counter] = None):
        self.mesh = mesh
        self.n = mesh.n
        self.counters = counters if counters is not None else collections.Counter()
        self.dispatches = 0

    def dispatch(self, kernel, batch_datas, batch_valids, batch_nrows):
        """``kernel``: the segment's ``FusedKernel``; per batch its planes
        and row count. Returns per batch (groups, counts), the counts as
        ints."""
        per_batch = K.fused_chain_stacked(kernel.in_schema, kernel.steps, batch_datas,
                                          batch_valids, batch_nrows, kernel=kernel)
        self.dispatches += 1
        self.counters["sharded_batches"] += len(batch_datas)
        return per_batch
