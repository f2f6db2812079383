"""Per-layer metric readers, one module per metric of ``BENCHMARK.json``'s
``per_layer``, found by its name.  Each has ``UNIT`` and ``read(ctx)``,
which returns the metric's value or None when it finds nothing to read.
``ctx`` holds the traced window's ``records`` (every request sent in
it), ``completed`` (those that returned), ``hist`` (each histogram
family of the executor's registry over the window: ``count``, ``sum``),
``trace`` (:func:`benchmark.trace.reduce`'s summary and ``window_s``)
and ``request_bytes`` (the least bytes of each returned request)."""
