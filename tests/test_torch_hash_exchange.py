"""K2's plain twin on key planes at their own width, and K17's receive
counts from the count matrix, against the JAX package.

K2 (exprs/spark_hash.py): ``hash_words`` leaves a bool, int8, int16 or
int32 plane as it is (float32 and float64 as bit views), and the twin
hashes it as Spark's hashInt of the sign-extended value, so the hashes and
partition ids equal ``blaze_tpu/exprs/spark_hash.py hash_batch`` (its
``_hash_device_run`` with the per-column fold) and the pmod of its
HashPartitioner for every key type, with nulls, 1 to 5 columns and 1, 4, 7
and 200 partitions. K17 (core/kernels.py): the receive counts the kernel
writes, a plain function of the count matrix (chip_smoke.py
``mesh_recv_counts``), equal the twin's live counts, round by round.

Tolerance: none; planes are compared by their bytes.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from blaze_tpu.core.batch import DeviceColumn as JDeviceColumn
from blaze_tpu.exprs import spark_hash as JH
from blaze_tpu.ir import types as JT

from blaze_tpu_torch.core import kernels as K
from blaze_tpu_torch.core.batch import DeviceColumn
from blaze_tpu_torch.exprs import spark_hash as H
from blaze_tpu_torch.ir import types as T
from chip_smoke import K17_EDGE_CASES, MESH_CASES, mesh_case, mesh_recv_counts, mesh_run

torch.set_num_threads(1)

CPU = torch.device("cpu")

# key kind: (the JAX package's type, the port's, numpy dtype of the plane)
KEY_TYPES = {
    "bool": (JT.BOOL, T.BOOL, np.bool_),
    "i8": (JT.I8, T.I8, np.int8),
    "i16": (JT.I16, T.I16, np.int16),
    "i32": (JT.I32, T.I32, np.int32),
    "date": (JT.DATE, T.DATE, np.int32),
    "f32": (JT.F32, T.F32, np.float32),
    "i64": (JT.I64, T.I64, np.int64),
    "f64": (JT.F64, T.F64, np.float64),
    "dec18": (JT.DecimalType(18, 2), T.DecimalType(18, 2), np.int64),
}
# float edge values: both zeros, infinities and NaNs with payloads of both
# signs (hashed as their bits, not normalised)
F32_BITS = (0x00000000, 0x80000000, 0x7F800000, 0xFF800000, 0x7FC00000, 0xFFC00000,
            0x7FC00123, 0x7F800001)
F64_BITS = (0x0000000000000000, 0x8000000000000000, 0x7FF0000000000000,
            0xFFF0000000000000, 0x7FF8000000000000, 0xFFF8000000000000,
            0x7FF8000000000123, 0x7FF0000000000001)


def _values(kind, n, rng):
    dt = KEY_TYPES[kind][2]
    if kind == "bool":
        return rng.random(n) < 0.5
    if kind in ("f32", "f64"):
        bits = np.array(F32_BITS if kind == "f32" else F64_BITS,
                        np.uint32 if kind == "f32" else np.uint64).view(dt)
        x = (rng.standard_normal(n) * 1e3).astype(dt)
        pick = rng.random(n) < 0.3
        x[pick] = bits[rng.integers(0, len(bits), int(pick.sum()))]
        return x
    if kind == "dec18":
        return rng.integers(-(10 ** 18) + 1, 10 ** 18, n)
    if kind == "date":
        return rng.integers(-40_000, 40_000, n).astype(np.int32)
    info = np.iinfo(dt)
    x = rng.integers(info.min, info.max, n, dtype=dt, endpoint=True)
    x[:4] = (info.min, info.max, 0, -1)[:min(4, n)]
    return x


def _columns(kinds, cap, n, nulls, rng):
    """The same typed key columns for both packages (padding and nulls
    carry data 0)."""
    jcols, cols = [], []
    for kind in kinds:
        jdt, dt, npdt = KEY_TYPES[kind]
        d = np.zeros(cap, npdt)
        v = np.zeros(cap, bool)
        v[:n] = rng.random(n) >= nulls
        d[:n] = np.where(v[:n], _values(kind, n, rng), np.zeros(1, npdt))
        jcols.append(JDeviceColumn(jdt, jnp.asarray(d), jnp.asarray(v)))
        cols.append(DeviceColumn(dt, torch.from_numpy(d.copy()), torch.from_numpy(v)))
    return jcols, cols


K2_KEYS = [
    ("bool",), ("i8",), ("i16",), ("i32",), ("date",), ("f32",), ("i64",), ("f64",),
    ("dec18",),
    ("bool", "i8"),
    ("i16", "f32", "i64"),
    ("date", "dec18", "bool", "f64"),
    ("i8", "i16", "i32", "i64", "f64"),
]


@pytest.mark.parametrize("kinds", K2_KEYS, ids=["+".join(k) for k in K2_KEYS])
@pytest.mark.parametrize("nulls", [0.0, 0.25])
def test_k2_twin_native_planes_match_reference(kinds, nulls):
    rng = np.random.default_rng(len(kinds) * 100 + int(nulls * 4) + sum(map(ord, kinds[0])))
    cap, n = 1024, 1000
    jcols, cols = _columns(kinds, cap, n, nulls, rng)
    hkinds = [H.hash_kind(c.dtype) for c in cols]
    words = [H.hash_words(c.data, k) for c, k in zip(cols, hkinds)]
    for c, w in zip(cols, words):
        # read at its own width: nothing widened before the hash
        assert w.element_size() == c.data.element_size()
        if not c.data.is_floating_point():
            assert w.dtype == c.data.dtype
    valids = [c.validity for c in cols]
    want = JH.hash_batch(jcols, n, cap, seed=42)
    for nparts in (1, 4, 7, 200):
        h, pid = H.murmur3_pmod_plain(words, valids, hkinds, n, nparts)
        np.testing.assert_array_equal(h.numpy(), want)
        jp = (((want.astype(np.int64) % nparts) + nparts) % nparts).astype(np.int32)
        np.testing.assert_array_equal(pid.numpy(), jp)
        np.testing.assert_array_equal(H.partition_ids(cols, n, nparts).numpy(), jp)


@pytest.mark.parametrize("kind", ["i8", "i16"])
def test_k2_twin_byte_and_short_golden(kind):
    """Spark's golden vectors for a byte (the JAX package's
    tests/test_spark_hash.py): hashInt of the value, seed 42; a short hashes
    the same way."""
    vals = torch.tensor([1, 0, -1, 127, -128], dtype=getattr(torch, KEY_TYPES[kind][2].__name__))
    h, _ = H.murmur3_pmod_plain([vals], [torch.ones(5, dtype=torch.bool)], ["i32"], 5, 4)
    expect = np.array([0xDEA578E3, 0x379FAE8F, 0xA0590E3D, 0x43B4D8ED, 0x422A1365],
                      dtype=np.uint32).view(np.int32)
    np.testing.assert_array_equal(h.numpy(), expect)


def test_k2_bool_hashes_as_zero_and_one():
    b = torch.tensor([True, False, True])
    as_int = torch.tensor([1, 0, 1], dtype=torch.int32)
    v = torch.ones(3, dtype=torch.bool)
    for nparts in (1, 7):
        for x, y in zip(H.murmur3_pmod_plain([b], [v], ["i32"], 3, nparts),
                        H.murmur3_pmod_plain([as_int], [v], ["i32"], 3, nparts)):
            assert torch.equal(x, y)


def test_k2_cuda_wrapper_raises_off_the_card():
    w = torch.zeros(4, dtype=torch.int8)
    v = torch.ones(4, dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        H.murmur3_pmod_cuda([w], [v], ["i32"], 4, 4)


def test_xxhash_words_widen_only_narrow_planes():
    """K15 and its twin take a bool, int8 or int16 plane at its own width
    (nothing widens it before the launch): the twin over the narrow planes
    equals the twin over the same values widened to int32, and a 4- or
    8-byte plane hashes as it is."""
    planes = [torch.tensor([True, False]), torch.tensor([-1, 2], dtype=torch.int8),
              torch.tensor([-300, 7], dtype=torch.int16), torch.tensor([5, -6], dtype=torch.int32),
              torch.tensor([1, -1], dtype=torch.int64)]
    kinds = ["i32"] * 4 + ["i64"]
    v = torch.ones(2, dtype=torch.bool)
    wide = [p.to(torch.int32) if p.element_size() < 4 else p for p in planes]
    for c in range(len(planes)):
        assert torch.equal(H.xxhash64_rows_plain(planes[c:], [v] * (5 - c), kinds[c:], 2, 4),
                           H.xxhash64_rows_plain(wide[c:], [v] * (5 - c), kinds[c:], 2, 4))
    assert [h.dtype for h in (H.hash_words(p, k) for p, k in zip(planes, kinds))] == \
        [p.dtype for p in planes]


_COUNT_CASES = [c for c in MESH_CASES if c[2] is not None] + \
    [c for c, _off in K17_EDGE_CASES if c[2] is not None]


@pytest.mark.parametrize("spec", _COUNT_CASES, ids=[c[0] for c in _COUNT_CASES])
def test_k17_written_receive_counts_equal_twin(spec):
    """The receive counts K17 writes (a plain function of the count matrix:
    no memset, no atomics) equal the twin's live counts in every round, on
    multi-round, skewed and empty-slot cases."""
    case = mesh_case(spec, np.random.default_rng(sum(map(ord, spec[0]))))
    rounds = mesh_run(case, K.mesh_all_to_all_plain, CPU)
    assert len(rounds) == case["rounds"]
    for (_outs, live, recv), want in zip(rounds, mesh_recv_counts(case)):
        assert recv.tolist() == want, (recv.tolist(), want)
        assert sum(want) == int(live.sum())


@pytest.mark.parametrize("spec,offset", [e for e in K17_EDGE_CASES],
                         ids=[e[0][0] for e in K17_EDGE_CASES])
def test_k17_twin_views_at_offsets(spec, offset):
    """K17's edge cases with their slot planes as views at odd element
    offsets: the twin's planes, live plane and counts equal those of the
    same planes in their own allocations."""
    case = mesh_case(spec, np.random.default_rng(11))
    got = mesh_run(case, K.mesh_all_to_all_plain, CPU, offset)
    want = mesh_run(case, K.mesh_all_to_all_plain, CPU)
    for (go, gl, gc), (wo, wl, wc) in zip(got, want):
        for a, b in zip(go, wo):
            assert a.dtype == b.dtype and torch.equal(a.view(torch.uint8), b.view(torch.uint8))
        assert torch.equal(gl, wl) and torch.equal(gc, wc)
