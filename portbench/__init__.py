"""The benchmark of the PyTorch and CUDA port, ``edgestyle_tpu_torch``.

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` (see ``run.py``).
Nothing here imports JAX or the JAX package; ``reference/`` imports
nothing of the port either.
"""
