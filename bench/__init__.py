"""The benchmark of ``repro_torch`` (CRAFT on PyTorch and CUDA).

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once.  Everything
that belongs to one configuration, traffic mix, cell or per-layer metric
lives in a file of its own, found by its name:

* ``configs/<config>.json``   sizes, source and cuts of a configuration
* ``traffic/<mix>.json``      a traffic mix: the runner kind and its
  parameters, read by ``runners/<kind>.py``
* ``limits/<cell>.json``      the limits of the cell's output check
* ``metrics/<metric>.py``     one reader a per-layer metric
* ``reference/``              the plain reference (imports nothing of the
  program)
* ``counts/``                 operation and byte counts and the chip's peaks
"""
