"""The port's expression evaluator against the JAX package's
``ExprEvaluator``: decimal comparison and arithmetic, integer arithmetic
and Spark null semantics (Kleene AND/OR, null-poisoned comparisons,
division by zero -> NULL).

Tolerance: exact — every value here is an integer, bool or int64-backed
decimal.
"""

import numpy as np
import pytest
import torch

from blaze_tpu.core.batch import ColumnarBatch as JBatch
from blaze_tpu.core.batch import DeviceColumn as JDeviceColumn
from blaze_tpu.exprs.compiler import ExprEvaluator as JEvaluator
from blaze_tpu.ir import exprs as JE
from blaze_tpu.ir import types as JT

from blaze_tpu_torch.core.batch import ColumnarBatch
from blaze_tpu_torch.exprs.compiler import ExprEvaluator
from blaze_tpu_torch.ir.carry import from_foreign

torch.set_num_threads(1)

CAP, N = 1024, 1000

SCHEMA = JT.Schema.of(
    ("d72", JT.DecimalType(7, 2)), ("d94", JT.DecimalType(9, 4)),
    ("i64", JT.I64), ("i32", JT.I32), ("b1", JT.BOOL), ("b2", JT.BOOL))


def _columns(seed):
    rng = np.random.default_rng(seed)
    cols = {
        "d72": rng.integers(-10 ** 6, 10 ** 6, N),
        "d94": rng.integers(-10 ** 8, 10 ** 8, N),
        "i64": rng.integers(-10 ** 12, 10 ** 12, N),
        "i32": rng.integers(-1000, 1000, N).astype(np.int32),
        "b1": rng.random(N) < 0.5,
        "b2": rng.random(N) < 0.5,
    }
    out = {}
    for name, d in cols.items():
        v = rng.random(N) >= 0.15
        if name == "i32":
            d[rng.random(N) < 0.1] = 0  # divisors of zero
        out[name] = (np.where(v, d, np.zeros((), d.dtype)), v)
    return out


def _jax_batch(cols):
    jcols = []
    for f in SCHEMA.fields:
        d, v = cols[f.name]
        jcols.append(JDeviceColumn.from_numpy(f.dtype, d, v, CAP))
    return JBatch(SCHEMA, jcols, N)


def _c(n):
    return JE.Column(n)


def _lit(v, dt):
    return JE.Literal(v, dt)


B = JE.BinaryOp
D72, D94 = JT.DecimalType(7, 2), JT.DecimalType(9, 4)

EXPRS = {
    "dec_gt_lit": JE.BinaryExpr(B.GT, _c("d72"), _lit("500.00", D72)),
    "dec_lteq_lit_scale": JE.BinaryExpr(B.LTEQ, _c("d72"), _lit("12.5", JT.DecimalType(5, 1))),
    "dec_eq_mixed_scale": JE.BinaryExpr(B.EQ, _c("d72"), _c("d94")),
    "dec_lt_mixed_scale": JE.BinaryExpr(B.LT, _c("d94"), _c("d72")),
    "dec_vs_int": JE.BinaryExpr(B.GTEQ, _c("d72"), _c("i32")),
    "dec_add": JE.BinaryExpr(B.ADD, _c("d72"), _c("d94"), JT.DecimalType(12, 4)),
    "dec_sub": JE.BinaryExpr(B.SUB, _c("d94"), _c("d72"), JT.DecimalType(12, 4)),
    "dec_mul": JE.BinaryExpr(B.MUL, _c("d72"), _c("d94"), JT.DecimalType(17, 6)),
    "dec_mul_round": JE.BinaryExpr(B.MUL, _c("d72"), _c("d94"), JT.DecimalType(17, 3)),
    "dec_div": JE.BinaryExpr(B.DIV, _c("d72"), _c("d94"), JT.DecimalType(18, 6)),
    "dec_div_int": JE.BinaryExpr(B.DIV, _c("d72"), _c("i32"), JT.DecimalType(18, 6)),
    "dec_mod": JE.BinaryExpr(B.MOD, _c("d94"), _c("d72"), JT.DecimalType(9, 4)),
    "dec_overflow": JE.BinaryExpr(B.MUL, _c("d94"), _c("d94"), JT.DecimalType(10, 8)),
    "dec_add_lit": JE.BinaryExpr(B.ADD, _c("d72"), _lit("0.05", JT.DecimalType(3, 2)),
                                 JT.DecimalType(8, 2)),
    "int_add": JE.BinaryExpr(B.ADD, _c("i64"), _c("i32")),
    "int_mul": JE.BinaryExpr(B.MUL, _c("i32"), _c("i32")),
    "int_div_zero": JE.BinaryExpr(B.DIV, _c("i64"), _c("i32")),
    "int_mod_zero": JE.BinaryExpr(B.MOD, _c("i64"), _c("i32")),
    "int_bits": JE.BinaryExpr(B.BIT_XOR, _c("i64"), _c("i32")),
    "int_shift": JE.BinaryExpr(B.SHIFT_LEFT, _c("i32"), _lit(3, JT.I32)),
    "and_kleene": JE.BinaryExpr(B.AND, _c("b1"), _c("b2")),
    "or_kleene": JE.BinaryExpr(B.OR, _c("b1"), _c("b2")),
    "not": JE.Not(JE.BinaryExpr(B.LT, _c("i64"), _lit(0, JT.I64))),
    "is_null": JE.IsNull(_c("d72")),
    "is_not_null": JE.IsNotNull(JE.BinaryExpr(B.ADD, _c("i64"), _c("i32"))),
    "null_literal_cmp": JE.BinaryExpr(B.EQ, _c("i64"), _lit(None, JT.I64)),
    "and_with_null_lit": JE.BinaryExpr(B.AND, _c("b1"), _lit(None, JT.BOOL)),
    "or_with_true_lit": JE.BinaryExpr(B.OR, _c("b1"), _lit(True, JT.BOOL)),
}


@pytest.mark.parametrize("name", sorted(EXPRS))
def test_expression_matches_jax(name):
    cols = _columns(seed=len(name))
    expr = EXPRS[name]
    jb = _jax_batch(cols)
    (jcol,) = JEvaluator([expr], SCHEMA).evaluate(jb)
    tb = ColumnarBatch.from_numpy(from_foreign(SCHEMA), cols, torch.device("cpu"),
                                  capacity=CAP)
    (tcol,) = ExprEvaluator([from_foreign(expr)], tb.schema).evaluate(tb)
    assert repr(from_foreign(jcol.dtype)) == repr(tcol.dtype)
    jv = np.asarray(jcol.validity)
    np.testing.assert_array_equal(jv, tcol.validity.numpy())
    jd = np.asarray(jcol.data)
    td = tcol.data.numpy()
    assert jd.dtype == td.dtype, (jd.dtype, td.dtype)
    # values must agree wherever they are valid (a null row's data plane
    # is not part of the contract of an evaluated expression)
    np.testing.assert_array_equal(jd[jv], td[jv])


def test_predicate_mask_matches_jax():
    cols = _columns(seed=5)
    preds = [EXPRS["dec_gt_lit"], EXPRS["or_kleene"]]
    jmask = JEvaluator(preds, SCHEMA).evaluate_predicate(_jax_batch(cols))
    tb = ColumnarBatch.from_numpy(from_foreign(SCHEMA), cols, torch.device("cpu"),
                                  capacity=CAP)
    tmask = ExprEvaluator([from_foreign(p) for p in preds], tb.schema) \
        .evaluate_predicate(tb)
    np.testing.assert_array_equal(np.asarray(jmask), tmask.numpy())


def test_unported_expression_raises():
    tb = ColumnarBatch.from_numpy(from_foreign(SCHEMA), _columns(1),
                                  torch.device("cpu"), capacity=CAP)
    expr = from_foreign(JE.Like(_c("d72"), "a%"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ExprEvaluator([expr], tb.schema).evaluate(tb)
