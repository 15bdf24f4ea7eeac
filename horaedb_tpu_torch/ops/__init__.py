"""PyTorch operators: host encoding, predicate masks, the time-bucket
aggregate (a hand-written CUDA kernel with its plain PyTorch version,
ops/bucket_agg.py) and top-k over group scores (ops/topk.py)."""

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
from horaedb_tpu_torch.ops.topk import (
    pair_add,
    pair_max_normalized,
    top_k_groups,
    two_sum,
)

__all__ = [
    "And", "ColumnEncoding", "DeviceBatch", "Eq", "Ge", "Gt", "In", "Le",
    "Lt", "Ne", "Not", "Or", "TimeRangePred", "decode_to_arrow",
    "encode_batch", "eval_predicate", "pad_capacity", "pair_add",
    "pair_max_normalized", "to_device", "top_k_groups", "two_sum",
]
