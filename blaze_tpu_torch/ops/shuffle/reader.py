"""Sources of the slice: the in-memory FFI import and the exchange reader.

``FFIReaderExec`` is the counterpart of blaze_tpu/ops/shuffle/reader.py's
FFIReaderExec (the ConvertToNative import) over numpy instead of Arrow:
the resource is ``partition -> iterable`` of batches, each a mapping
``{column: data or (data, validity)}`` of numpy arrays (uploaded to the
session's device, one capacity bucket per batch), or a ready
``ColumnarBatch`` already on the device.

``BatchSourceExec`` serves the device-resident sub-batches an in-process
exchange staged for each reducer (runtime/session.py): the device tier,
where nothing is serialised.
"""

from __future__ import annotations

from blaze_tpu_torch.core.batch import ColumnarBatch
from blaze_tpu_torch.ir import types as T
from blaze_tpu_torch.ops.base import Operator


class FFIReaderExec(Operator):
    def __init__(self, schema: T.Schema, resource_id: str, num_partitions: int = 1):
        self.resource_id = resource_id
        self._num_partitions = num_partitions
        super().__init__(schema, [])

    def num_partitions(self):
        return self._num_partitions

    def _execute(self, partition, ctx):
        provider = ctx.resources[self.resource_id]
        items = provider(partition) if callable(provider) else provider
        for item in items:
            if isinstance(item, ColumnarBatch):
                if item.device != ctx.device:
                    raise ValueError(f"FFIReader batch on {item.device}, "
                                     f"session on {ctx.device}")
                yield item
            else:
                yield ColumnarBatch.from_numpy(self.schema, item, ctx.device,
                                               conf=ctx.conf)


class BatchSourceExec(Operator):
    """The resource is ``partition -> list of ColumnarBatch``."""

    def __init__(self, schema: T.Schema, resource_id: str, num_partitions: int = 1):
        self.resource_id = resource_id
        self._num_partitions = num_partitions
        super().__init__(schema, [])

    def num_partitions(self):
        return self._num_partitions

    def _execute(self, partition, ctx):
        yield from ctx.resources[self.resource_id](partition)
