"""The benchmark of the PyTorch and CUDA port (``pandepth_tpu_torch``):
``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``, driven by ``BENCHMARK.json``. It imports neither JAX nor
the JAX package, and runs the port only as processes of its own."""
