"""Small configurations for the benchmark's CPU tests: one shard of each
configuration (SSB at SF 0.2), the program on ``device="cpu"``."""

import pytest

from benchmark import harness


def small_config(name: str) -> dict:
    cfg = harness.load_config(name)
    cfg["shards"] = 1
    if "scale_factor" in cfg["generator_params"]:
        cfg["generator_params"]["scale_factor"] = 0.2
    cfg["executor"] = {}
    return cfg


@pytest.fixture
def small():
    return small_config

