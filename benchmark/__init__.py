"""The benchmark of ``simplex_tpu_torch`` on NVIDIA H100 cards.

One run measures one cell of ``BENCHMARK.json``:

    python3 -m benchmark.run --workload NAME --seed N --seconds S --trace 0|1

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by the name ``BENCHMARK.json`` gives it:
``configs/<config>.json``, ``traffic/<traffic>.json``,
``metrics/<metric>.py``, ``limits/<workload>.json``; the kernels' byte
counts live under ``roofline/`` and the plain float64 reference and its
lower-precision control under ``reference/``. Nothing here imports JAX or
the JAX package; the reference imports nothing of the port.
"""
