"""The benchmark of ``forde_tpu_torch`` on NVIDIA H100 cards.

One run is one process:

    python3 -m h100bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It reads the cell from ``BENCHMARK.json`` at the root of the checkout and
finds everything else by name (``lookup``):

* ``configs/<config>.json``: the model's sizes as they are run;
* ``traffic/<traffic>.json``: the traffic mix, a data file whose ``driver``
  names the module of ``drivers/`` that runs it;
* ``metrics/<metric>.py``: one per-layer metric, a small reader of the
  traced run's spans, counters and device events;
* ``counts/``: operations and bytes of the kernels and of the model, and
  the card's peaks;
* ``reference/``: the plain PyTorch model that decides ``correct``.

Nothing here imports JAX or the JAX package; ``forde_tpu_torch``, the
system under test, is imported only by the drivers.
"""
