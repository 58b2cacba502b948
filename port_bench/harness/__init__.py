"""The benchmark of the PyTorch port's world server (``port_bench/run.py``).

``cell.run_cell`` runs one cell: it makes the weights from the seed
(``weights.py``), builds the port's world behind its threaded ``/terrain``
API (``program.py``), warms it, drives the cell's traffic mix through HTTP
clients for the measured window (``load.py``), reads the per-layer spans and
the device trace in a traced run (``trace.py``), and judges the served tiles
against the plain reference of ``port_bench/reference`` (``check.py``).
Configurations, traffic mixes, cells and metric readers are files under
``port_bench/`` found by name (``registry.py``).
"""
