"""The benchmark of ``omnihd_scenes_tpu_torch`` on NVIDIA GPUs.

``python -m perfbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything that belongs to one configuration, traffic mix or
metric is a file of its own, found by the name the manifest gives
(``perfbench/manifest.py``).  The yardsticks (traffic generation, the
plain references, the roofline counts, the arithmetic of each metric)
live here, apart from the program they measure.
"""
