"""The benchmark of image_matching_tpu_torch, the PyTorch and CUDA port:
served encrypted queries against an encrypted gallery on one H100.

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once.  Nothing here
imports JAX or the JAX package.
"""
