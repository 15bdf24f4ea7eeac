"""Common utilities shared by every layer (ref: src/common)."""

from horaedb_tpu_torch.common.error import Error, ensure
from horaedb_tpu_torch.common.size_ext import ReadableSize
from horaedb_tpu_torch.common.tasks import cancel_and_wait
from horaedb_tpu_torch.common.time_ext import ReadableDuration, now_ms

__all__ = ["Error", "ensure", "ReadableDuration", "ReadableSize",
           "cancel_and_wait", "now_ms"]
