"""The benchmark of ``magent_tpu_torch`` on the NVIDIA H100.

``python3 -m h100bench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything that belongs to one configuration, placement,
traffic mix, loop kind, per-layer metric or kernel lives in a file of its
own that the harness finds by name: ``configs/<config>.json``,
``layouts/<placement kind>.py``, ``traffic/<mix>.json``,
``kinds/<traffic kind>.py``, ``limits/<cell>.json``,
``metrics/<metric>.py`` and ``rooflines/<entry point>.py``.  The plain
reference that decides ``correct`` is ``reference/``; it imports nothing of
the program."""
