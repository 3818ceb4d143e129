"""The benchmark of the PyTorch and CUDA port of PLAR (``repro_torch``).

One run measures one cell (a deployment under one traffic mix) on the card:

    python3 plarbench/run.py --workload kdd99.batch --seed 7 --seconds 40 --trace 0

Everything a cell needs is found by name under this folder (``configs/``,
``traffic/``, ``workloads/``, ``metrics/``); ``reference/`` holds the plain
reference that decides ``correct``.  Nothing here imports JAX or the JAX
package.
"""
