"""Benchmark of the PyTorch/CUDA codec engine (``dcvc_tpu_torch``).

Driven by data: ``BENCHMARK.json`` at the root names the cells; each cell
names a configuration (``configs/<config>.json``) and a traffic mix
(``traffic/<traffic>.json``, whose ``kind`` picks a driver in
``drivers/<kind>.py``); each metric is read by ``metrics/<metric>.py``; the
limits of a cell's correctness numbers are ``limits/<cell>.json``. The
plain reference, the FLOP and byte counts and the oracles live in
``reference/`` and import nothing of the program.
"""
