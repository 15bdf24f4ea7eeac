"""PyTorch/CUDA port of horaedb_tpu.

A second package beside the JAX one, with the same layout (common/,
objstore/, storage/, ops/, metric_engine/).  Device code is PyTorch;
the time-bucket aggregate that the JAX package wrote as a Pallas TPU
kernel is a hand-written CUDA kernel here (csrc/bucket_agg.cu, bound
through ops/bucket_agg.py).  Entry points run on the CUDA device unless
the caller passes device="cpu", which the tests do.
"""
