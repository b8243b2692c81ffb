"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``run.py`` runs one cell of ``BENCHMARK.json`` once: it builds the cell's
model and server from ``--seed``, warms up every shape the cell's traffic
uses, serves the traffic for ``--seconds``, checks what the timed path served
against a plain float32 reference, and prints one JSON line.  Everything that
belongs to one configuration, traffic mix or metric is a file of its own,
found by its name:

* ``configs/<config>.json``: the model's published sizes, as run;
* ``traffic/<traffic>.json``: the mix's parameters, read by ``traffic.py``;
* ``limits/<cell>.json``: the correctness limits of one cell;
* ``e2e/<metric>.py`` and ``metrics/<metric>.py``: one reader per metric;
* ``families/<family>.py``: how the program's model of a family is built;
* ``reference/<family>.py``: the plain reference of a family.
"""
