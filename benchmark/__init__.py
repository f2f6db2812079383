"""The benchmark of ``pilosa_tpu_torch``: analytic dashboards over a
bitmap index, driven through ``API.query`` by closed-loop clients.

One run is one cell of ``BENCHMARK.json`` (a configuration under a
traffic mix): ``python3 -m benchmark.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout.  A
configuration is ``configs/<name>.json`` with its data generator
``generators/<generator>.py``; a traffic mix is ``traffic/<name>.json``;
a per-layer metric is ``metrics/<name>.py``.  The harness finds each by
the name ``BENCHMARK.json`` gives, so a new one is a new file.

Nothing here imports ``jax`` or the JAX package; ``reference/`` imports
nothing of ``pilosa_tpu_torch`` either.
"""
