"""Operator protocol and per-task execution context.

As in blaze_tpu/ops/base.py: an operator is a schema-carrying object whose
``execute(partition, ctx)`` returns a generator of ColumnarBatches (pull-
based streaming). The context carries the conf, the session's device and
the resource map (sources and exchange outputs). The JAX package's
metrics tree, tracer spans, memory manager and cancellation are not
ported yet (ROADMAP.md Queue 1 items 1 and 13).
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional

import torch

from blaze_tpu_torch.config import Config
from blaze_tpu_torch.core.batch import ColumnarBatch
from blaze_tpu_torch.ir import types as T


class ExecContext:
    """Per-task context handed to every operator."""

    def __init__(self, conf: Config, device: torch.device,
                 resources: Optional[Dict[str, Any]] = None):
        self.conf = conf
        self.device = device
        self.resources = resources if resources is not None else {}


class Operator:
    """Base operator: subclasses set ``schema`` and ``children`` and
    implement ``_execute``."""

    schema: T.Schema
    children: List["Operator"]

    def __init__(self, schema: T.Schema, children: List["Operator"]):
        self.schema = schema
        self.children = children

    @property
    def name(self) -> str:
        return type(self).__name__

    def num_partitions(self) -> int:
        if self.children:
            return self.children[0].num_partitions()
        return 1

    def execute(self, partition: int, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        return self._execute(partition, ctx)

    def _execute(self, partition: int, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        raise NotImplementedError

    def execute_child(self, i: int, partition: int,
                      ctx: ExecContext) -> Iterator[ColumnarBatch]:
        return self.children[i].execute(partition, ctx)

    def __repr__(self):
        return f"{self.name}({', '.join(repr(c) for c in self.children)})"
