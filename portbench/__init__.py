"""The benchmark of ``repro_torch`` on one NVIDIA H100.

``python -m portbench.run --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints one JSON
line. A cell is found by name: its configuration in ``configs/`` (its data's
true features from ``datakinds/<kind>.py``), its traffic in ``traffic/``
(data read by the runner that the traffic's ``kind`` names,
``runners/<kind>.py``), its limits in ``limits/`` and each per-layer
metric's reader in ``metrics/`` (``<name>.py``, or the quantity's
``<name before its first dot>.py``). Nothing here imports
``jax`` or the JAX package ``repro``; the reference (``reference.py``)
imports nothing of ``repro_torch`` either.
"""
