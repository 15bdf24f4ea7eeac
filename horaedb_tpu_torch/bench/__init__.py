"""Benchmark suite of the PyTorch port: TSBS-style data generation, the
bench.py twin (configs 0 and 1: `python -m horaedb_tpu_torch.bench`)
and the BASELINE configs 2-10 (`python -m horaedb_tpu_torch.bench.suite
--config N`).  Every entry runs on the card unless the caller passes
device="cpu"."""
