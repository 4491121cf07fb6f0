"""The benchmark of ``aztec_tpu_torch``, the PyTorch + CUDA PLONK prover.

``python -m plonkbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of the root ``BENCHMARK.json`` once and prints
one JSON result line.  Configurations, traffic mixes and per-layer metrics
are files of their own (``configs/``, ``traffic/``, ``metrics/``), found by
the names in ``BENCHMARK.json``; ``reference/`` is the plain verifier that
decides ``correct``.
"""
