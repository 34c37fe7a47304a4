"""The port's benchmark: one cell of ``BENCHMARK.json`` a run.

``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout that holds
``kubeflow_tpu_torch``. Every piece is found by the name
``BENCHMARK.json`` gives it: ``configs/<config>.json``,
``traffic/<traffic>.json`` (whose ``driver`` names
``drivers/<driver>.py``), ``workloads/<cell>.json`` (the cell's
correctness limits) and ``metrics/<metric>.py`` (one reader per
per-layer metric). Nothing here imports JAX or the JAX package.
"""
