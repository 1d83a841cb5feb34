"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` serves one cell of ``BENCHMARK.json`` on one H100 through
``repro_torch.serve.loop.Server`` and prints one JSON line.  Everything
that belongs to one configuration, traffic mix, cell or metric is a file
of its own under ``configs/``, ``traffic/``, ``cells/`` and ``metrics/``,
found by the name that ``BENCHMARK.json`` gives it; a model family's work
counts are in ``families/``, its plain reference in ``reference/``, and
the arrival processes and length distributions that traffic files name
in ``processes/`` and ``lengths/``.  Nothing here imports JAX or
the JAX package; ``reference/`` imports nothing of the port either.
"""
