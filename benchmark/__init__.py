"""The benchmark of neurips2023_soc_torch on NVIDIA H100 cards.

`python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
from the root of a checkout runs one cell of BENCHMARK.json and prints one JSON
line. Everything that belongs to one configuration, cell, traffic mix or
per-layer metric is a file of its own, found by its name:

  configs/<config>.json     the configuration as it is run (the program's
                            config keys, plus source, reduced, assumed)
  workloads/<cell>.json     config, traffic, driver kind, chips, check limits
  traffic/<traffic>.json    the mix's parameters, read by traffic/<generator>.py
  drivers/<kind>.py         set-up, measured window and check of one kind
  metrics/<metric>.py       read(ctx) -> number or None, for a traced run
  work/                     operations and bytes from shapes
  reference/                the plain reference the check compares with
"""
