"""Data generators, one module per configuration family, found by the
``generator`` name of a configuration file.  Each has
``prepare(cfg, rng) -> state``, which draws what the shards share and
allocates ``state["columns"]`` (one value per column for every field of
``cfg["fields"]``, ``state["n"]`` columns over at most ``cfg["shards"]``
shards of 2^20; a set field's value is its one row id), and
``fill(state, shard, rng)``, which draws one shard's columns from the
shard's own stream."""
