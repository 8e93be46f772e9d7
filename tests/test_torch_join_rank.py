"""K18's rank routes (row 10) against the JAX package.

- The route decision (``ops/joins/keymap.rank_route``) is a function of a
  build's sorted unique canonical words alone: dense for one run of
  consecutive words, bitmap up to 256 words of range a key, search past
  that, for float words spread over their bit patterns and for nk = 0.
- The kernel's rank arithmetic in PyTorch (``keymap.rank_probe_plain``:
  the dense subtraction, the bitmap table's block mask and prefix count,
  the search) equals blaze_tpu/ops/joins/keymap.py:211
  ``sorted_probe_traced`` on every route: negative words, words at the
  int64 ends whose range passes 2^63, nk 0 and 1, a range at the 256 x nk
  limit and one past it, misses below, inside and above the range, and
  float keys with -0.0 and NaN payloads.
- K18's generated source parses for each route and tuple of routes, and a
  dense or bitmap join has no search loop in it.
- A q89-shaped fused plan (sparse item keys: the bitmap route) and a
  q17-shaped one (dense keys) equal ``blaze_tpu.Session`` on the CPU,
  with the routes their build maps give.

Tolerance: none. Ranks and masks compare exactly; plans by their values
(floats by their repr).
"""

import ast
import itertools
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from blaze_tpu.ops.joins import keymap as JKM

from blaze_tpu_torch.core import kernels as K
from blaze_tpu_torch.exprs import fused_triton as FT
from blaze_tpu_torch.ir import exprs as E
from blaze_tpu_torch.ir import types as T
from blaze_tpu_torch.ops.joins import keymap as KM
from chip_smoke import K18_CASES, k18_case, k18_spec
from tests import test_torch_fused_agg as FA
from tests.test_torch_window_agg import _canon

torch.set_num_threads(1)

I64_MIN, I64_MAX = -(1 << 63), (1 << 63) - 1


def _sparse(rng, nk, span, lo):
    """nk sorted unique words over exactly ``span`` words from ``lo``."""
    inner = rng.choice(np.arange(lo + 1, lo + span - 1), nk - 2, replace=False)
    return np.sort(np.r_[lo, lo + span - 1, inner]).astype(np.int64)


_F64 = np.array([0.0, -0.0, 1.5, -1.5, np.inf, -np.inf, 2.25, -1e300, 7.0]
                + list(np.array([0x7FF8000000000000, 0xFFF8000000000000,
                                 0x7FF8000000000123, 0x7FF0000000000001],
                                np.uint64).view(np.float64)))
_F32 = np.array([0.0, -0.0, 1.5, -1.5, np.inf, -np.inf, 2.25, -1e30, 7.0]
                + list(np.array([0x7FC00000, 0xFFC00000, 0x7FC00123, 0x7F800001],
                                np.uint32).view(np.float32)), np.float32)


def _words(case, rng):
    """(sorted unique canonical build words, probe data) of a case; the
    probe holds every word, misses below, inside and above the range and
    the int64 ends."""
    if case in ("f64", "f32"):
        pool = _F64 if case == "f64" else _F32
        keys = pool[rng.permutation(len(pool))[:7]]
        return np.unique(KM._canon_words(keys)), np.concatenate([pool, pool[::-1]])
    words = {
        "dense": np.arange(-40, 25, dtype=np.int64),
        "dense at the int64 top": np.array([I64_MAX - k for k in range(9, -1, -1)], np.int64),
        "dense at the int64 bottom": np.array([I64_MIN + k for k in range(10)], np.int64),
        "one key": np.array([-7], np.int64),
        "no key": np.zeros(0, np.int64),
        "bitmap, negative words": _sparse(rng, 50, 3000, -2000),
        "bitmap at 256 x nk": _sparse(rng, 30, 256 * 30, -100),
        "search one past 256 x nk": _sparse(rng, 30, 256 * 30 + 1, -100),
        "search over the int64 ends": np.array([I64_MIN, I64_MIN + 1, -3, 0, 5, I64_MAX - 1,
                                                I64_MAX], np.int64),
        "bitmap of one 64-word block": np.array([3, 9, 64 + 2], np.int64) - 64,
    }[case]
    lo = int(words[0]) if len(words) else 0
    hi = int(words[-1]) if len(words) else 0
    extra = [lo - 1, lo - 1000, hi + 1, hi + 1000, I64_MIN, I64_MAX, 0, -1, 1,
             (lo + hi) // 2]
    extra = [x for x in extra if I64_MIN <= x <= I64_MAX]
    inside = rng.integers(lo, hi + 1, 64) if len(words) and hi - lo < 1 << 62 else []
    probe = np.concatenate([words, np.array(extra, np.int64),
                            np.asarray(inside, np.int64)]).astype(np.int64)
    return words, probe[rng.permutation(len(probe))]


ROUTES = {"dense": "dense", "dense at the int64 top": "dense",
          "dense at the int64 bottom": "dense", "one key": "dense", "no key": "search",
          "bitmap, negative words": "bitmap", "bitmap at 256 x nk": "bitmap",
          "search one past 256 x nk": "search", "search over the int64 ends": "search",
          "bitmap of one 64-word block": "bitmap", "f64": "search", "f32": "search"}


@pytest.mark.parametrize("case", list(ROUTES))
def test_rank_matches_sorted_probe_traced(case):
    """The kernel's rank on the route the words give (and on the search,
    which takes any words) equals the reference's probe: the clipped rank
    of every row, its hit where the key is valid."""
    rng = np.random.default_rng(sum(map(ord, case)))
    words, probe = _words(case, rng)
    rank = KM.JoinRank(words)
    assert rank.route == ROUTES[case]
    nk = len(words)
    uniq = words if nk else np.zeros(1, np.int64)
    valid = rng.random(len(probe)) >= 0.2
    jc, jh = JKM.sorted_probe_traced(jnp.asarray(uniq), jnp.asarray(probe), jnp.asarray(valid),
                                     nk)
    w = KM.canon_words(torch.from_numpy(probe))
    for r in {rank.route, KM.RANK_SEARCH}:
        rank.route = r
        cidx, found = KM.rank_probe_plain(rank, torch.from_numpy(uniq), w)
        np.testing.assert_array_equal(cidx.numpy(), np.asarray(jc))
        np.testing.assert_array_equal((torch.from_numpy(valid) & found).numpy(),
                                      np.asarray(jh))


@pytest.mark.parametrize("words,route", [
    ([], "search"), ([5], "dense"), ([-3, -2, -1, 0], "dense"), ([1, 3], "bitmap"),
    ([0, 511], "bitmap"), ([0, 512], "search"), ([I64_MIN, I64_MAX], "search"),
    ([I64_MAX - 1, I64_MAX], "dense"), ([0, 1 << 40], "search"),
])
def test_rank_route_is_a_function_of_the_sorted_words(words, route):
    """The route from the words alone, in any container, and from a map
    built over keys whose canonical words they are."""
    arr = np.array(words, np.int64)
    assert KM.rank_route(arr) == route
    assert KM.rank_route(list(arr)) == route
    assert KM.JoinRank(arr).route == route
    assert KM.rank_route(np.unique(KM._canon_words(arr[::-1]))) == route


def test_bitmap_limits_are_constants():
    """The table limit: a range within 256 words a key whose table passes
    16 MiB searches."""
    nk = (KM.BITMAP_MAX_BYTES // 16) * 64 // KM.BITMAP_SPAN_PER_KEY + 1
    span = KM.BITMAP_MAX_BYTES // 16 * 64 + 64
    words = np.r_[np.arange(nk - 1), span - 1].astype(np.int64)
    assert span <= KM.BITMAP_SPAN_PER_KEY * nk
    assert KM.rank_route(words) == "search"
    assert KM.rank_route(words[:-1]) == "dense"


def test_bitmap_table_layout():
    """Each 64-word block's (mask, count before it), interleaved."""
    words = np.array([-64, -63, 0, 63, 64 + 5, 64 * 3], np.int64)
    table = KM.bitmap_table(words).reshape(-1, 2)
    assert table.shape == (5, 2)
    assert list(table[:, 0]) == [0b11, 1 - (1 << 63), 1 << 5, 0, 1]
    assert list(table[:, 1]) == [0, 2, 4, 5, 5]


_ROUTE_CASES = [c for c in K18_CASES if c[3] in ("join", "chain", "q89")]


@pytest.mark.parametrize("case", _ROUTE_CASES, ids=[c[0] for c in _ROUTE_CASES])
def test_generated_source_per_route(case):
    """K18's source for every tuple of routes parses; a dense or bitmap
    join reads no search loop and no sorted words, a bitmap join one pair
    of its table's words, a search join its S-step loop; a tuple of
    the wrong length is refused."""
    spec = k18_spec(k18_case(case, np.random.default_rng(1), E, T))
    kernel = FT.FusedAggKernel(spec)
    nj = len(spec.joins)
    for routes in itertools.product((KM.RANK_DENSE, KM.RANK_BITMAP, KM.RANK_SEARCH),
                                    repeat=nj):
        src = kernel.source_for(routes)
        ast.parse(src)
        for j, r in enumerate(routes):
            assert (f"tl.static_range(S{j})" in src) == (r == KM.RANK_SEARCH)
            assert (f"tl.load(u{j}_ptr" in src) == (r == KM.RANK_SEARCH)
            assert (f"tl.load(m{j}_ptr" in src) == (r == KM.RANK_BITMAP)
        assert src.count("tl.store(") == len(kernel.gen.stores)
        for x in set(re.findall(r"\b(xv?\d+)\b", src)):  # every input it reads, loaded
            assert f"    {x} = tl.load({x}_ptr + offs" in src, x
    with pytest.raises(ValueError):  # a route a join
        kernel.source_for(routes[:-1])


@pytest.mark.parametrize("query,routes", [("q89", ("bitmap", "dense", "dense")),
                                          ("q17", ("dense", "dense"))])
def test_routed_plans_match_jax(query, routes, tmp_path, monkeypatch):
    """q89 (its item build keeps ~1.8% of the items: the bitmap route; its
    dates and stores dense) and q17 (items and stores dense) through both
    Sessions, order included; every fused input gets its joins with the
    routes their build maps give."""
    plan, schemas, parts, batch, conf, _njoins = FA._path(query)
    want, _fused = FA._reference(plan, schemas, parts, tmp_path, None, batch, **conf)
    seen = {}
    fn = K.fused_agg_input_plain

    def recorded(spec, columns, num_rows, joins):
        key = tuple(j[3].route for j in joins)
        seen[key] = seen.get(key, 0) + 1
        return fn(spec, columns, num_rows, joins)

    monkeypatch.setattr(K, "fused_agg_input_plain", recorded)
    got, _counters, calls = FA._port(plan, parts, batch, None, **conf)
    assert _canon(got) == _canon(want)
    assert seen == {routes: calls} and calls > 0
