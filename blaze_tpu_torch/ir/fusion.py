"""Whole-stage fusion pass: collapse chains of narrow operators into one
fused stage (a copy of blaze_tpu/ir/fusion.py, device-free).

Between blocking operators, a run of batch-local narrow operators —
projection, filter, rename, expand, with coalesce-batches as an in-stage
staging point — touches each row once and has no data-dependent control
flow. The pass rewrites maximal such chains into ``N.FusedStage`` nodes;
``ops/fused.py`` runs each segment of a stage as one generated Triton
kernel (K11, ``exprs/fused_triton.py``) per batch, which also compacts
each filtered output group.

Cost model, as in the JAX package:

- Boundaries are structural: blocking or exchange operators are never
  crossed.
- Only what provably runs on the device fuses: every expression must pass
  ``fusable_expr`` and every schema in the chain must be fixed-width.
- A chain is rewritten when its estimated eager dispatch count exceeds
  the fused one (one per segment) by at least one (the JAX package's
  ``fusion_min_saved_dispatches`` at its default; no plan sets another).
- A filter directly under an Agg stays unfused (the agg-filter guard: the
  JAX package absorbs it into its partial-agg kernel), so the chain may
  start only below it.

The pass runs once at the root of every operator build
(``runtime/executor.build_operator``) and is idempotent. The JAX
package's decision audit (``obs.attribution``) is not ported (ROADMAP.md
Queue 1 item 14).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import List, Tuple

from blaze_tpu_torch.ir import exprs as E
from blaze_tpu_torch.ir import nodes as N
from blaze_tpu_torch.ir import types as T


def fuse_plan(node: N.PlanNode, conf) -> N.PlanNode:
    """Rewrite maximal fusable chains in ``node``'s tree into FusedStage
    nodes. Returns the input tree itself when ``conf.fusion_enabled`` is
    off (the escape hatch: the built operator tree is then exactly the
    unfused one)."""
    if not getattr(conf, "fusion_enabled", False):
        return node
    return _fuse(node, allow_start=True)


def _fuse(node: N.PlanNode, allow_start: bool) -> N.PlanNode:
    if isinstance(node, N.FusedStage):  # idempotence
        child = _fuse(node.child, allow_start=True)
        if child is node.child:
            return node
        return dataclasses.replace(node, child=child)
    if allow_start and _op_fusable(node):
        chain = [node]  # outermost-first
        cur = node.child
        while _op_fusable(cur):
            chain.append(cur)
            cur = cur.child
        if _worth_fusing(chain):
            return N.FusedStage(child=_fuse(cur, allow_start=True),
                                ops=tuple(reversed(chain)))
        # the gain estimate is additive: a maximal chain not worth fusing
        # has no worthwhile subchain, so recurse past it
    return _recurse(node)


def _recurse(node: N.PlanNode) -> N.PlanNode:
    changed = False

    def fn(child):
        nonlocal changed
        allow = not (isinstance(node, N.Agg) and isinstance(child, N.Filter))
        out = _fuse(child, allow_start=allow)
        changed = changed or out is not child
        return out

    rebuilt = N.map_children(node, fn)
    # identity-preserving: a tree with nothing to fuse passes through
    return rebuilt if changed else node


def _all_device(schema: T.Schema) -> bool:
    return all(T.torch_dtype(f.dtype) is not None for f in schema.fields)


def _op_fusable(node: N.PlanNode) -> bool:
    """Can this node join a fused chain? Structural kind, expressions that
    run on the device, fixed-width schemas on both sides."""
    return _op_unfusable_reason(node) is None


def _contains_pyudf(expr) -> bool:
    if isinstance(expr, E.PyUDF):
        return True
    try:
        return any(_contains_pyudf(c) for c in expr.children())
    except Exception:
        return False


def _expr_break_reason(exprs) -> str:
    return "pyudf" if any(_contains_pyudf(e) for e in exprs) else "unfusable_expr"


def _op_unfusable_reason(node: N.PlanNode):
    """None when the node can join a fused chain, else why not."""
    from blaze_tpu_torch.exprs.compiler import fusable_expr

    if not isinstance(node, (N.Projection, N.Filter, N.RenameColumns,
                             N.CoalesceBatches, N.Expand)):
        return "blocking_op"
    try:
        in_schema = node.child.output_schema
        if not _all_device(in_schema):
            return "host_schema"
        if isinstance(node, N.Projection):
            if not _all_device(node.output_schema):
                return "host_schema"
            if not all(fusable_expr(e, in_schema) for e in node.exprs):
                return _expr_break_reason(node.exprs)
            return None
        if isinstance(node, N.Filter):
            if not all(fusable_expr(p, in_schema) for p in node.predicates):
                return _expr_break_reason(node.predicates)
            return None
        if isinstance(node, N.Expand):
            if not _all_device(node.schema):
                return "host_schema"
            flat = [e for proj in node.projections for e in proj]
            if not all(fusable_expr(e, in_schema) for e in flat):
                return _expr_break_reason(flat)
            return None
        return None  # rename / coalesce: structural only
    except Exception:
        return "schema_error"


# least number of eager dispatches a chain must save to be fused (a lone
# column-reference projection saves none and stays unfused)
_MIN_SAVED_DISPATCHES = 1


def _nontrivial(exprs) -> int:
    return sum(1 for e in exprs
               if not isinstance(e, (E.Column, E.BoundReference, E.Literal)))


def _estimated_eager_dispatches(chain: List[N.PlanNode]) -> int:
    """One dispatch per non-trivial expression plus one compaction per
    filter (an undercount of the eager ops; it only has to separate
    "saves work" from "saves nothing")."""
    est = 0
    for op in chain:
        if isinstance(op, N.Projection):
            est += _nontrivial(op.exprs)
        elif isinstance(op, N.Filter):
            est += _nontrivial(op.predicates) + 1
        elif isinstance(op, N.Expand):
            est += sum(_nontrivial(p) for p in op.projections)
    return est


def _fused_dispatches(chain: List[N.PlanNode]) -> int:
    """One fused dispatch per contiguous non-coalesce run."""
    segs = 0
    in_run = False
    for op in chain:
        if isinstance(op, N.CoalesceBatches):
            in_run = False
        elif not in_run:
            segs += 1
            in_run = True
    return segs


def _worth_fusing(chain: List[N.PlanNode]) -> bool:
    saved = _estimated_eager_dispatches(chain) - _fused_dispatches(chain)
    return saved >= _MIN_SAVED_DISPATCHES


# -- steps + fingerprint ------------------------------------------------------


def chain_steps(ops: Tuple[N.PlanNode, ...]) -> Tuple[tuple, ...]:
    """A FusedStage's ops (innermost-first) as steps: ("project", exprs,
    names) | ("filter", preds) | ("rename", names) | ("coalesce",
    batch_size) | ("expand", projections, schema)."""
    steps = []
    for op in ops:
        if isinstance(op, N.Projection):
            steps.append(("project", tuple(op.exprs), tuple(op.names)))
        elif isinstance(op, N.Filter):
            steps.append(("filter", tuple(op.predicates)))
        elif isinstance(op, N.RenameColumns):
            steps.append(("rename", tuple(op.renamed_names)))
        elif isinstance(op, N.CoalesceBatches):
            steps.append(("coalesce", op.batch_size))
        elif isinstance(op, N.Expand):
            steps.append(("expand", tuple(tuple(p) for p in op.projections), op.schema))
        else:
            raise TypeError(f"unfusable op in FusedStage: {type(op).__name__}")
    return tuple(steps)


def _schema_sig(schema: T.Schema) -> list:
    return [[f.name, repr(f.dtype)] for f in schema.fields]


def fused_fingerprint(input_schema: T.Schema, steps) -> str:
    """Stable identity of one fused segment: its input schema and steps
    with their serialised expressions. Keys the process-wide kernel cache
    (``ops/fused.py``) and names the generated source."""
    from blaze_tpu_torch.ir.serde import expr_to_json

    payload = [_schema_sig(input_schema)]
    for st in steps:
        kind = st[0]
        if kind == "project":
            payload.append([kind, [expr_to_json(e) for e in st[1]], list(st[2])])
        elif kind == "filter":
            payload.append([kind, [expr_to_json(p) for p in st[1]]])
        elif kind == "rename":
            payload.append([kind, list(st[1])])
        elif kind == "coalesce":
            payload.append([kind, st[1]])
        else:  # expand
            payload.append([kind, [[expr_to_json(e) for e in proj] for proj in st[1]],
                            _schema_sig(st[2])])
    blob = json.dumps(payload, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:24]
