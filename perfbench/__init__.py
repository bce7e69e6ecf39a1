"""The benchmark of the PyTorch/CUDA port (``repro_torch``).

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one JSON
line.  Every configuration, architecture, traffic mix, cell and per-layer
metric lives in a file of its own under this folder and is found by its
name: ``configs/<config>.json``, ``arch/<family>.py`` (the family a
configuration names by ``"arch"``: shapes, weight layout, the engine's
config, counts) with its plain reference ``reference/<family>.py``,
``traffic/<mix>.json``, ``cells/<cell>.json``, ``metrics/<metric>.py``.
The yardstick (traffic generation, counts of operations and bytes, the
plain references, the comparison that decides ``correct``) lives here too,
and imports nothing of the program but its served engine and its configs.
"""
