"""The port's CLI and its config against ``pilosa_tpu.cli`` on the CPU.

- :class:`Config` has the reference's keys in the reference's order plus
  ``device``; the layering defaults ← TOML (with the ``[tls]`` table) ←
  ``PILOSA_*`` env ← flags resolves every key as the reference's does;
  unknown keys are refused;
- the served / refused / changed-default table: every refused key set
  off its default stops the server at boot naming itself, the served
  keys reach the executor, the API and the holder, and the keys whose
  defaults differ from the reference's are pinned;
- ``generate-config``, ``config``, ``import`` (ids, keys, values),
  ``export``, ``check`` on a clean and on a corrupt directory (both
  packages quarantine the fragment, print the same ``BAD`` line and
  exit 1),
  ``version``, and ``backup`` / ``restore`` failing as the reference's
  with nothing to reach (their round trips are in
  ``tests/test_torch_backup.py``);
- the ``server`` command in a subprocess with ``--device cpu``, closed by
  SIGTERM with exit code 0.
"""

import dataclasses
import json
import os
import shutil
import signal
import subprocess
import sys
import tomllib

import numpy as np
import pytest

from pilosa_tpu.cli import config as jconfig
from pilosa_tpu.cli import main as jmain
from pilosa_tpu.store import Holder as JHolder
from pilosa_tpu_torch.api.client import Client
from pilosa_tpu_torch.cli import config as tconfig
from pilosa_tpu_torch.cli import main as tmain
from pilosa_tpu_torch.server import PilosaTPUServer
from pilosa_tpu_torch.testing import share_cpu_threads

share_cpu_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SW = 1 << 20


def _keys(mod) -> list:
    return [f.name for f in dataclasses.fields(mod.Config)]


def test_keys_in_the_reference_order_plus_device():
    assert _keys(tconfig) == _keys(jconfig) + ["device"]
    assert tconfig.Config().device == ""


def test_changed_defaults_pinned():
    # every default is the reference's, the observability and storage
    # keys (a 1% trace sample, a 1 s slow log, a 32 MiB/s scrubber every
    # 600 s, the disk governor's floor and probe) included
    t, j = tconfig.Config(), jconfig.Config()
    changed = {k for k in _keys(jconfig) if getattr(t, k) != getattr(j, k)}
    assert changed == set()
    assert tconfig.CHANGED_DEFAULTS == {}
    for key in ("trace_sample_rate", "slow_query_threshold",
                "scrub_interval_seconds", "scrub_bytes_per_second",
                "disk_min_free_bytes", "disk_probe_seconds", "log_format",
                "stats_backend", "statsd_address", "diagnostics_interval"):
        assert key not in tconfig.REFUSED


def test_layering_equal(tmp_path):
    p = tmp_path / "c.toml"
    p.write_text('bind = "127.0.0.1:9999"\nplane-budget-bytes = 1000\n'
                 'query_timeout = 2.5\nfsync = true\n'
                 'seeds = ["a:1"]\n[tls]\ncertificate = "~/c.pem"\n'
                 'key = "k.pem"\nskip-verify = true\n')
    env = {"PILOSA_PLANE_BUDGET_BYTES": "2000", "PILOSA_SOLO_FASTLANE":
           "false", "PILOSA_SEEDS": "b:2, c:3", "PILOSA_VERBOSE": "yes",
           "PILOSA_DEVICE": "cpu"}
    over = {"query_timeout": 4.0, "bind": None, "verbose": None}
    t = tconfig.load(str(p), env=env, overrides=over)
    j = jconfig.load(str(p), env=env, overrides=over)
    same = [k for k in _keys(jconfig) if k not in tconfig.CHANGED_DEFAULTS]
    assert {k: getattr(t, k) for k in same} == \
        {k: getattr(j, k) for k in same}
    assert (t.plane_budget_bytes, t.query_timeout, t.seeds, t.device) == \
        (2000, 4.0, ["b:2", "c:3"], "cpu")
    assert t.tls_certificate == os.path.expanduser("~/c.pem")
    assert tconfig.tls_of(t).skip_verify
    assert tconfig.client_ssl_of(dataclasses.replace(
        t, tls_certificate="", tls_key="")) is not None  # skip_verify
    assert tconfig.client_ssl_of(tconfig.Config()) is None
    assert t.name == t.bind == "127.0.0.1:9999"


@pytest.mark.parametrize("text, match", [
    ("nope = 1\n", "unknown config key 'nope'"),
    ("[tls]\nnope = 1\n", r"unknown \[tls\] key 'nope'")])
def test_unknown_keys_refused(tmp_path, text, match):
    p = tmp_path / "c.toml"
    p.write_text(text)
    for mod in (tconfig, jconfig):
        with pytest.raises(ValueError, match=match):
            mod.load(str(p), env={})


def _off_default(key: str):
    v = getattr(tconfig.Config(), key)
    if isinstance(v, bool):
        return not v
    if isinstance(v, int):
        return v + 1
    if isinstance(v, float):
        return v + 1.5
    if isinstance(v, list):
        return ["peer:1"]
    return "json" if key == "log_format" else "other"


@pytest.mark.parametrize("key", sorted(tconfig.REFUSED))
def test_refused_key_stops_the_boot(tmp_path, key):
    cfg = tconfig.load(env={}, overrides={
        "data_dir": str(tmp_path / "d"), "device": "cpu",
        key: _off_default(key)})
    with pytest.raises(ValueError) as ei:
        PilosaTPUServer(cfg)
    assert f"config key {key} = " in str(ei.value)
    assert "not supported by this port" in str(ei.value)
    assert "ROADMAP" in str(ei.value)
    assert not os.path.exists(tmp_path / "d")


@pytest.mark.parametrize("cuda_devices", [1, 2, 8])
def test_mesh_over_several_cards_served(cuda_devices):
    """``mesh = true`` boots over any number of CUDA devices (the planes
    shard over them), and so does ``mesh = false``."""
    cfg = tconfig.Config()
    assert cfg.mesh
    tconfig.check_served(cfg, cuda_devices)
    tconfig.check_served(dataclasses.replace(cfg, mesh=False), cuda_devices)


def test_server_boots_on_the_cpu_with_a_given_placement(tmp_path):
    """A placement handed to the server reaches its executor: the planes
    block over it, answers are exact, and ``/status`` has the mesh
    block (none without a placement)."""
    from pilosa_tpu_torch.virtmesh import virtual_placement
    cfg = tconfig.load(env={}, overrides={
        "bind": "127.0.0.1:0", "data_dir": str(tmp_path / "d"),
        "device": "cpu"})
    srv = PilosaTPUServer(cfg, placement=virtual_placement(4, "cpu")).open()
    try:
        assert srv.executor.placement is srv.placement
        srv.api.create_index("i")
        srv.api.create_field("i", "f")
        srv.api.import_bits("i", "f", row_ids=[1, 1, 2],
                            col_ids=[3, SW + 4, 5 * SW + 6])
        assert srv.api.query("i", "Count(Row(f=1))")["results"] == [2]
        mesh = srv.api.status()["mesh"]
        assert mesh["devices"] == 4 and mesh["axis"] == "shard"
        assert mesh["paddedShards"] == 1  # shards 0, 1, 5 pad to 4
    finally:
        srv.close()
    plain = PilosaTPUServer(cfg).open()
    try:
        assert plain.executor.placement is None
        assert "mesh" not in plain.api.status()
    finally:
        plain.close()


def test_served_keys_reach_the_server(tmp_path):
    cfg = tconfig.load(env={}, overrides=dict(
        bind="127.0.0.1:0", data_dir=str(tmp_path / "d"), device="cpu",
        fsync=True, query_timeout=9.0, count_batch_window="0.004",
        plane_budget_bytes=123 << 20, delta_buffer_cells=1024,
        delta_compact_fraction=0.3, tree_fusion=False,
        dispatch_pipeline_depth=3, solo_fastlane=False,
        dispatch_watchdog_seconds=7.0, device_health_probe_seconds=2.0,
        plane_paging=True, plane_page_bytes=2 << 20,
        tenant_byte_quota=5 << 20, tenant_qps_quota=100.0,
        tenant_slot_quota=3, plane_sidecars=False,
        max_concurrent_queries=5, max_map_count=100, mesh=False,
        faults='[{"site": "exec.execute", "action": "delay", '
               '"args": {"seconds": 0.0}}]'))
    from pilosa_tpu_torch import fault
    from pilosa_tpu_torch.store import syswrap
    srv = PilosaTPUServer(cfg).open()
    try:
        ex = srv.executor
        assert str(ex.device) == "cpu" and srv.holder.fsync
        assert srv.api.query_timeout == 9.0
        b = ex.batcher
        assert (b.window_s, b.pipeline_depth, b.solo_fastlane,
                b.watchdog_s, b.governor.probe_after_s) == \
            (0.004, 3, False, 7.0, 2.0)
        p = ex.planes
        assert (p.budget, p.delta_cells, p.delta_compact_fraction,
                p.sidecars) == (123 << 20, 1024, 0.3, False)
        assert not ex.tree_fusion and ex.max_concurrent == 5
        assert ex.pager.page_bytes == 2 << 20
        assert ex.governor.byte_quota == 5 << 20
        assert (ex.qos.qps_quota, ex.qos.slot_quota) == (100.0, 3)
        assert syswrap.GLOBAL.max_maps == 100
        assert [f["site"] for f in fault.list_faults()] == ["exec.execute"]
        assert srv.grpc is None
    finally:
        srv.close()
        fault.clear()
        syswrap.GLOBAL.max_maps = syswrap.default_max_maps()


def test_generate_config_equal_but_the_changed_defaults(capsys):
    assert tmain.main(["generate-config"]) == 0
    port = capsys.readouterr().out.splitlines()
    assert jmain.main(["generate-config"]) == 0
    ref = capsys.readouterr().out.splitlines()
    changed = {k.replace("_", "-") for k in tconfig.CHANGED_DEFAULTS}
    assert port[-1] == 'device = ""'
    assert [ln for ln in port[:-1] if ln.split(" = ")[0] not in changed] \
        == [ln for ln in ref if ln.split(" = ")[0] not in changed]
    data = tomllib.loads("\n".join(port))
    assert {k.replace("-", "_"): v for k, v in data.items()} == \
        tconfig.Config().effective()


def test_config_command_prints_the_effective_config(capsys, monkeypatch,
                                                    tmp_path):
    monkeypatch.delenv("PILOSA_DEVICE", raising=False)
    assert tmain.main(["config", "--data-dir", str(tmp_path)]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got["device"] == "" and got["data_dir"] == str(tmp_path)
    assert list(got) == _keys(tconfig)


def test_version_and_refused_commands(capsys, tmp_path):
    """``version``, and ``backup`` / ``restore`` served (no longer
    refused): with nothing to reach or restore they fail as the
    reference's do, with its exit code and its first stderr words."""
    assert tmain.main(["version"]) == 0
    assert capsys.readouterr().out == "0.1.0\n"
    from pilosa_tpu_torch.testing import free_ports
    dead = ["--bind", f"127.0.0.1:{free_ports(1)[0]}"]
    missing = str(tmp_path / "nothing")
    for argv, head in ((["backup", *dead, "-o", str(tmp_path / "a")],
                        "backup failed: "),
                       (["restore", *dead, missing],
                        f"restore failed: no archive at {missing!r}")):
        errs = []
        for mod in (tmain, jmain):
            assert mod.main(argv) == 1
            errs.append(capsys.readouterr().err)
        assert all(e.startswith(head) for e in errs), errs
        assert "not supported by this port" not in errs[0]


@pytest.fixture
def server(tmp_path):
    cfg = tconfig.load(env={}, overrides={
        "bind": "127.0.0.1:0", "data_dir": str(tmp_path / "srv"),
        "device": "cpu"})
    srv = PilosaTPUServer(cfg).open()
    yield srv
    srv.close()


def _oracle_csv(pairs: np.ndarray) -> str:
    """``row,col`` lines as the export writes them: shard by shard, rows
    ascending, columns ascending."""
    pairs = np.unique(pairs, axis=0)
    shard = pairs[:, 1] // SW
    order = np.lexsort((pairs[:, 1], pairs[:, 0], shard))
    return "".join(f"{r},{c}\n" for r, c in pairs[order].tolist())


def test_import_export_commands(server, tmp_path, capsys):
    bind = ["--bind", f"127.0.0.1:{server.port}"]
    rng = np.random.default_rng(8)
    pairs = np.stack([rng.integers(0, 5, 3000),
                      rng.integers(0, 3 * SW, 3000)], axis=1)
    src = tmp_path / "p.csv"
    src.write_text("# rows, columns\n" + "".join(
        f"{r},{c}\n" for r, c in pairs.tolist()))
    assert tmain.main(["import", *bind, "--create", "-i", "c", "-f", "f",
                       "--batch-size", "700", str(src)]) == 0
    assert "imported (changed" in capsys.readouterr().err
    out = tmp_path / "out.csv"
    assert tmain.main(["export", *bind, "-i", "c", "-f", "f", "-o",
                       str(out)]) == 0
    assert out.read_text() == _oracle_csv(pairs)
    # keyed rows and columns, then values
    ksrc = tmp_path / "k.csv"
    ksrc.write_text("a,x\nb,y\na,z\n")
    assert tmain.main(["import", *bind, "--create", "--keys", "-i", "k",
                       "-f", "f", str(ksrc)]) == 0
    vsrc = tmp_path / "v.csv"
    vsrc.write_text("x,5\ny,-3\n")
    assert tmain.main(["import", *bind, "--create", "--value", "-i", "k",
                       "-f", "n", str(vsrc)]) == 0
    assert tmain.main(["export", *bind, "-i", "k", "-f", "f"]) == 0
    assert capsys.readouterr().out == "a,x\na,z\nb,y\n"
    assert tmain.main(["export", *bind, "-i", "k", "-f", "n"]) == 0
    assert capsys.readouterr().out == "x,5\ny,-3\n"
    c = Client("127.0.0.1", server.port)
    assert c.query("k", "Sum(field=n)") == [{"value": 2, "count": 2}]
    assert tmain.main(["import", *bind, "-i", "nope", "-f", "f",
                       str(src)]) == 1


def test_check_clean_and_corrupt(tmp_path, capsys):
    root = str(tmp_path / "d")
    h = JHolder(root).open()
    h.create_index("i").create_field("f").import_bits(
        np.array([1, 2], np.uint64), np.array([3, SW + 4], np.uint64))
    h.close()
    assert tmain.main(["check", "--data-dir", root]) == 0
    out = capsys.readouterr().out
    assert "ok i/f/standard/1: 1 bits, 1 rows, op_n=0" in out
    assert out.endswith("all fragments ok\n")
    snap = os.path.join(root, "i", "f", "views", "standard", "fragments",
                        "1")
    blob = bytearray(open(snap, "rb").read())
    blob[-1] ^= 0xFF
    open(snap, "wb").write(bytes(blob))
    jroot = str(tmp_path / "j")
    shutil.copytree(root, jroot)
    assert tmain.main(["check", "--data-dir", root]) == 1
    out = capsys.readouterr().out
    assert f"BAD {snap}: quarantined (snapshot) frame length/crc " \
        "mismatch (disk corruption)" in out
    assert out.endswith("1 problems\n")
    assert jmain.main(["check", "--data-dir", jroot]) == 1
    assert capsys.readouterr().out == out.replace(root, jroot)


def test_server_command_in_a_subprocess(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PILOSA_")}
    proc = subprocess.Popen(
        [sys.executable, "-m", "pilosa_tpu_torch.cli", "server", "--bind",
         "127.0.0.1:0", "--data-dir", str(tmp_path / "d"), "--device",
         "cpu"], cwd=REPO, env=env, stderr=subprocess.PIPE, text=True)
    try:
        port = None
        for _ in range(50):
            line = proc.stderr.readline()
            if "listening on http://127.0.0.1:" in line:
                port = int(line.split("127.0.0.1:")[1].split()[0])
                assert "device=cpu" in line
                break
        assert port is not None
        c = Client("127.0.0.1", port)
        c.create_index("i")
        c.create_field("i", "f")
        assert c.query("i", "Set(3, f=1)Count(Row(f=1))") == [True, 1]
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
        proc.stderr.close()
    assert os.path.exists(tmp_path / "d" / "i" / "f" / "views" / "standard"
                          / "fragments" / "0")
