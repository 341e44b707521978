"""The benchmark of isle_tpu_torch: see portbench/README.md."""
