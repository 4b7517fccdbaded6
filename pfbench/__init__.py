"""The benchmark of pfbwtf_tpu_torch on one CUDA card (``python3 -m
pfbench.run``). It imports neither jax nor pfbwtf_tpu; the reference under
``pfbench/reference`` imports nothing of the program either."""
