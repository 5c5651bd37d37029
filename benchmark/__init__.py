"""The benchmark of ``odtpu_torch``: cells, traffic, the plain reference
and the comparison that decides ``correct``. Run one cell with
``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout."""
