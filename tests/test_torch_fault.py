"""The port's fault registry counts and its ``/internal/fault`` REST
surface against ``pilosa_tpu``'s, on the CPU.

The same requests go to a JAX server and a port server (each over its
own holder, each package's registry wired to its server's ``Stats``):
the list / arm / clear bodies, the 400 bodies of bad specs, the trigger
counts in the listing and the ``fault_triggered_total`` lines of
``/metrics`` are equal.  ``triggered_total`` / ``reset_triggered`` /
``set_stats`` count as the reference's.
"""

import json
import urllib.error
import urllib.request

import pytest

from pilosa_tpu import fault as jfault
from pilosa_tpu.api import API as JAPI
from pilosa_tpu.api import Server as JHttp
from pilosa_tpu.obs import Stats as JStats
from pilosa_tpu.store import Holder as JHolder
from pilosa_tpu_torch import fault as tfault
from pilosa_tpu_torch.api import API, Server
from pilosa_tpu_torch.api.client import Client
from pilosa_tpu_torch.exec import Executor
from pilosa_tpu_torch.obs import Stats
from pilosa_tpu_torch.store import Holder
from pilosa_tpu_torch.testing import share_cpu_threads

share_cpu_threads()

PKGS = ("jax", "torch")
FAULT = {"jax": jfault, "torch": tfault}


@pytest.fixture(autouse=True)
def _clean_registries():
    for mod in FAULT.values():
        mod.clear()
        mod.reset_triggered()
    yield
    for mod in FAULT.values():
        mod.clear()
        mod.reset_triggered()
        mod.set_stats(None)


@pytest.fixture
def servers(tmp_path):
    """One server per package, keyed by package: its base URL."""
    jh = JHolder(str(tmp_path / "j")).open()
    js = JHttp(JAPI(jh), "127.0.0.1", 0, stats=JStats()).start()
    th = Holder(str(tmp_path / "t")).open()
    tapi = API(th, Executor(th, device="cpu"))
    ts = Server(tapi, "127.0.0.1", 0, stats=Stats()).start()
    yield {"jax": f"http://127.0.0.1:{js.address[1]}",
           "torch": f"http://127.0.0.1:{ts.address[1]}"}
    js.close()
    jh.close()
    ts.close()
    tapi.executor.close()
    th.close()


def _req(base, method, path, obj=None):
    body = json.dumps(obj).encode() if obj is not None else None
    req = urllib.request.Request(base + path, data=body, method=method)
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _both(servers, method, path, obj=None):
    out = {pkg: _req(servers[pkg], method, path, obj) for pkg in PKGS}
    assert out["torch"] == out["jax"], (method, path, obj)
    return out["torch"]


def test_set_list_clear_roundtrip_bodies_equal(servers):
    st, body = _both(servers, "POST", "/internal/fault",
                     {"site": "client.send", "action": "partition",
                      "match": {"peer": "127.0.0.1:9"}, "times": 3})
    assert st == 200 and json.loads(body)["armed"]["site"] == "client.send"
    _both(servers, "POST", "/internal/fault",
          {"site": "sys.write", "action": "error",
           "args": {"errno": "ENOSPC"}, "prob": 0.5, "seed": 3})
    st, body = _both(servers, "GET", "/internal/fault")
    listing = json.loads(body)
    assert [f["site"] for f in listing["faults"]] == ["client.send",
                                                      "sys.write"]
    assert listing["triggered"] == []
    st, body = _both(servers, "POST", "/internal/fault/clear",
                     {"site": "client.send"})
    assert json.loads(body) == {"cleared": 1}
    st, body = _both(servers, "POST", "/internal/fault/clear")
    assert json.loads(body) == {"cleared": 1}
    assert json.loads(_both(servers, "GET", "/internal/fault")[1]) == {
        "faults": [], "triggered": []}


@pytest.mark.parametrize("spec", [
    {"site": "x"},
    {"action": "drop"},
    {"site": "x", "action": "bogus"},
    {"site": "x", "action": "drop", "prob": 1.5},
    {"site": "x", "action": "error", "args": {"errno": "ENOTANERRNO"}},
], ids=["no-action", "no-site", "bad-action", "bad-prob", "bad-errno"])
def test_bad_spec_is_400_with_equal_body(servers, spec):
    st, body = _both(servers, "POST", "/internal/fault", spec)
    assert st == 400 and json.loads(body)["error"]


def test_triggered_counts_surface_on_metrics_alike(servers):
    _both(servers, "POST", "/internal/fault",
          {"site": "server.response", "action": "drop_response",
           "nth": 1, "match": {"path": "/version"}})
    for pkg in PKGS:
        host, port = servers[pkg].rsplit(":", 1)
        # dropped once, retried (a GET)
        assert Client(host[len("http://"):], int(port)).version()
    st, body = _both(servers, "GET", "/internal/fault")
    assert json.loads(body)["triggered"] == [
        {"site": "server.response", "action": "drop_response",
         "count": 1}]
    lines = {}
    for pkg in PKGS:
        text = _req(servers[pkg], "GET", "/metrics")[1].decode()
        lines[pkg] = [ln for ln in text.splitlines()
                      if "fault_triggered_total" in ln]
    assert lines["torch"] == lines["jax"]
    assert 'fault_triggered_total{action="drop_response",' \
           'site="server.response"} 1' in lines["torch"]


def test_triggered_counter_and_stats_sink():
    stats = Stats()
    tfault.set_stats(stats)
    tfault.set_fault("s", "drop")
    tfault.fire("s")
    tfault.fire("s")
    tfault.fire("other")
    assert tfault.triggered_total() == {("s", "drop"): 2}
    counters = stats.snapshot()["counters"]["fault_triggered_total"]
    assert sum(counters.values()) == 2
    tfault.reset_triggered()
    assert tfault.triggered_total() == {}
    # a live node's counts are cumulative: clearing the failpoints keeps
    # them
    tfault.fire("s")
    tfault.clear()
    assert tfault.triggered_total() == {("s", "drop"): 1}
