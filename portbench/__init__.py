"""portbench: the benchmark of ntsm_tpu_torch (see portbench/run.py)."""
