"""The benchmark of ``repro_torch``, the PyTorch and CUDA port.

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card and
prints one JSON line.  Everything a cell needs is found by name:

* ``configs/<config>.json``  the deployment and its data generator;
* ``traffic/<cell>.json``    the client driver and its parameters;
* ``metrics/<metric>.py``    one reader per per-layer metric;
* ``drivers/`` and ``data/`` the modules those files name.

``reference/`` holds the plain NumPy and PyTorch answers a run is held
to.  Nothing here imports ``jax`` or the JAX package ``repro``.
"""
