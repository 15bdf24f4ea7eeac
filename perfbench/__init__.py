"""The benchmark of horaedb_tpu_torch: `python perfbench/run.py`."""
