"""The benchmark of the PyTorch and CUDA port (``repro_torch``): one cell
of ``BENCHMARK.json`` a run, ``python bench/run.py --workload <cell> --seed
<n> --seconds <s> --trace <0|1>``.  Nothing here imports jax or the JAX
package; ``bench/reference/`` imports nothing of the port either."""
