"""The benchmark of demovlp_tpu_torch on NVIDIA H100 cards (run.py)."""
