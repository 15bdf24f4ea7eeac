"""PyTorch operators: host encoding, predicate masks, and the
time-bucket aggregate (a hand-written CUDA kernel with its plain
PyTorch version, ops/bucket_agg.py)."""

from horaedb_tpu_torch.ops.encode import (
    ColumnEncoding,
    DeviceBatch,
    decode_to_arrow,
    encode_batch,
    pad_capacity,
    to_device,
)
from horaedb_tpu_torch.ops.filter import (
    And,
    Eq,
    Ge,
    Gt,
    In,
    Le,
    Lt,
    Ne,
    Not,
    Or,
    TimeRangePred,
    eval_predicate,
)

__all__ = [
    "And", "ColumnEncoding", "DeviceBatch", "Eq", "Ge", "Gt", "In", "Le",
    "Lt", "Ne", "Not", "Or", "TimeRangePred", "decode_to_arrow",
    "encode_batch", "eval_predicate", "pad_capacity", "to_device",
]
