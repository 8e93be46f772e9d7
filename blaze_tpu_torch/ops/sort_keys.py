"""Sort-key normalisation (plain PyTorch).

As blaze_tpu/ops/sort_keys.py ``key_operands``: every sort key becomes a
(u8 rank, native value) operand pair, direction-adjusted, with nulls,
NaNs and padding rows folded into the rank (core/kernels.py
``sort_key_operands``). Keys must be device (fixed-width) values; the
host path for var-width keys is not ported (ROADMAP.md Queue 2).
"""

from __future__ import annotations

from typing import List

import torch

from blaze_tpu_torch.core import kernels as K
from blaze_tpu_torch.core.batch import ColumnarBatch
from blaze_tpu_torch.exprs.compiler import ExprEvaluator, broadcast
from blaze_tpu_torch.ir import exprs as E


def key_spec(sort_orders: List[E.SortOrder]) -> tuple:
    return tuple((so.ascending, so.nulls_first) for so in sort_orders)


def key_operands(batch: ColumnarBatch,
                 sort_orders: List[E.SortOrder]) -> List[torch.Tensor]:
    """[rank0, val0, rank1, val1, ...]; padding rows sort last."""
    ev = ExprEvaluator([so.child for so in sort_orders], batch.schema)
    datas, valids = [], []
    for so in sort_orders:
        d, v = broadcast(ev.eval(so.child, batch), batch)
        datas.append(d)
        valids.append(v)
    return K.sort_key_operands(datas, valids, batch.row_exists_mask(),
                               key_spec(sort_orders))
