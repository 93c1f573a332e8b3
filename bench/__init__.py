"""The benchmark of ``repro_torch``: the paper's DLB step on the card.

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything a cell is made of is found by name: its
configuration in ``configs/`` (which names its loop in ``loops/``, its
domain in ``domains/`` and its recorded level table in ``levels/``, whose
feature is in ``features/``), its traffic in ``traffic/`` (which names
its generator in ``generators/``), its limits in ``limits/`` and each
metric's reader in ``metrics/``.  The plain reference that decides
``correct`` is ``reference/``; it imports nothing of the program.
"""
