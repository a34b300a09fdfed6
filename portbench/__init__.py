"""The benchmark of the PyTorch/CUDA port, ``repro_torch``, on one H100.

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once (:mod:`.run`).
"""
