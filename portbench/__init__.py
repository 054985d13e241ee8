"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on NVIDIA cards.

One run is ``python3 portbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout. Everything that
belongs to one configuration, traffic mix or metric sits in a file of its
own (``configs/``, ``traffic/``, ``metrics/``) that the harness finds by
the name ``BENCHMARK.json`` gives it; ``yardstick/`` holds what a change to
the program must not move: the generators, the plain reference, the byte
accounting, the table of peaks and the comparison that decides
``correct``. Nothing here imports JAX or the JAX package ``repro``.
"""
