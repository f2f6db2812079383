"""The port's main path, end to end, against the JAX package.

One data directory, written as real fragment snapshots plus op-logs,
answers a query list through the JAX ``API`` over ``Executor(...,
plane_paging=False, kernel_tier="pallas")`` (Pallas kernels in interpret
mode) and through the port's ``API`` on the CPU, both in two
configurations: "off" (``count_batch_window="off", tree_fusion=False``,
each request alone) and "default" (the adaptive cross-request batcher,
whole-tree compilation and the plan cache).  The JSON must be equal, in
process and over REST.  Also here: the import hygiene of the port, its
refusal to run without a card unless the CPU is asked for, and the calls
on keyed data that the first slices refused, now equal to the JAX
package's answers (``tests/test_torch_keys.py`` covers keys in full).
"""

import ast
import json
import os
import pathlib
import shutil
import subprocess
import sys
import urllib.request

import numpy as np
import pytest
import torch

from pilosa_tpu.api import API as JAPI
from pilosa_tpu.api import Server as JServer
from pilosa_tpu.exec import Executor as JExecutor
from pilosa_tpu.store import Holder as JHolder
from pilosa_tpu.store import roaring as jroaring
from pilosa_tpu_torch.api import API as TAPI
from pilosa_tpu_torch.api import ApiError
from pilosa_tpu_torch.api import Server as TServer
from pilosa_tpu_torch.exec import Executor as TExecutor
from pilosa_tpu_torch.store import Holder as THolder
from pilosa_tpu_torch.testing import share_cpu_threads

share_cpu_threads()

REPO = pathlib.Path(__file__).resolve().parent.parent
SHARDS, ROWS, W = 3, 8, 32768
SW = 1 << 20

COUNTS = "".join(f"Count(Row(f={r}))" for r in range(ROWS))
READS = [
    COUNTS,                                   # whole-plane row_counts
    "Count(Row(f=1))Count(Row(f=6))",         # selected-row gather
    "Count(Row(f=2))Count(Row(f=2))",
    "Count(Row(f=3))Count(Row(f=99))",        # an absent row
    ("Count(Intersect(Row(f=1), Row(g=0)))"
     "Count(Union(Row(f=1), Row(g=1)))"
     "Count(Difference(Row(f=2), Row(g=0)))"
     "Count(Xor(Row(f=3), Row(g=1)))"),       # compound -> count
    "Count(Intersect(Row(f=1), Union(Row(g=0), Not(Row(g=1)))))",
    "Count(Row(f=5))",
    "Count(Not(Row(f=1)))",
    "Count(All())",
    "Count(Union())",
    "Row(h=0)",
    "Union(Row(h=0), Row(h=1))",
    "Intersect(Row(h=0), Row(f=1))",
    "Difference(Row(h=1), Row(h=0))",
    "TopN(f, n=3)",
    "TopN(f)",
    "TopN(f, n=100)",
    "TopN(f, Row(g=0), n=5)",
    "TopN(f, Intersect(Row(g=0), Row(g=1)), n=4)",
    "TopN(f, ids=[1, 2, 3], n=2)",
    "TopN(h, n=2)",
    "TopN(h, Row(g=1))",
    "Count(Row(f=4))Row(h=1)Count(Row(f=0))",
    "All(limit=2)",                           # All pages its columns
    "All(offset=1)",
    "All(limit=1, offset=1)",
]
WRITES = [
    "Set(5, h=3)",
    "Count(Row(h=3))",
    "Set(5, h=3)",
    f"Set({2 * SW + 17}, f=2)",
    COUNTS,
    "TopN(f, n=3)",
    "Clear(5, h=3)",
    "Clear(5, h=3)",
    "Count(Row(h=3))Count(Row(h=0))",
    "Count(All())",
    "Row(h=3)",
]


def _write_index(root: str) -> None:
    """Index ``i``: field f (8 rows, ~25% dense) and g (2 rows, ~50%) as
    dense snapshots, h (3 sparse rows) through the write path, and the
    existence row, all over 3 shards."""
    rng = np.random.default_rng(7)
    h = JHolder(root).open()
    idx = h.create_index("i")
    for name in ("f", "g", "h"):
        idx.create_field(name)
    cols = rng.choice(SHARDS * SW, 600, replace=False).astype(np.uint64)
    idx.field("h").import_bits(rng.integers(0, 3, 600).astype(np.uint64),
                               cols)
    h.close()
    f = (rng.integers(0, 1 << 32, (SHARDS, ROWS, W), dtype=np.uint32)
         & rng.integers(0, 1 << 32, (SHARDS, ROWS, W), dtype=np.uint32))
    f[:, 7] = 0                                # a row with no bits
    g = rng.integers(0, 1 << 32, (SHARDS, 2, W), dtype=np.uint32)
    ex = rng.integers(0, 1 << 32, (SHARDS, 1, W), dtype=np.uint32) \
        | rng.integers(0, 1 << 32, (SHARDS, 1, W), dtype=np.uint32)
    for name, arr in (("f", f), ("g", g), ("_exists", ex)):
        d = os.path.join(root, "i", name, "views", "standard", "fragments")
        os.makedirs(d, exist_ok=True)
        for s in range(SHARDS):
            blob = jroaring.serialize_dense(arr[s])
            with open(os.path.join(d, str(s)), "wb") as fh:
                fh.write(blob)


# executor keywords of each configuration (the same in both packages)
CONFIGS = {"off": {"count_batch_window": "off", "tree_fusion": False},
           "default": {}}


def _jax_api(root: str, monkeypatch, config: str = "off"):
    monkeypatch.setenv("PILOSA_PALLAS_INTERPRET", "1")
    holder = JHolder(root).open()
    ex = JExecutor(holder, plane_paging=False, kernel_tier="pallas",
                   **CONFIGS[config])
    assert ex.fused.effective_tier == "pallas-interpret"
    return holder, JAPI(holder, ex)


def _port_api(root: str, config: str = "default"):
    holder = THolder(root).open()
    return holder, TAPI(holder, TExecutor(holder, device="cpu",
                                          **CONFIGS[config]))


@pytest.fixture(scope="module")
def index_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("slice") / "data")
    _write_index(root)
    return root


@pytest.fixture(scope="module", params=list(CONFIGS))
def apis(index_dir, request):
    """(JAX API, port API, configuration name), both packages in the
    same configuration."""
    mp = pytest.MonkeyPatch()
    jh, japi = _jax_api(index_dir, mp, request.param)
    th, tapi = _port_api(index_dir, request.param)
    yield japi, tapi, request.param
    tapi.executor.close()
    th.close()
    jh.close()
    mp.undo()


@pytest.mark.parametrize("pql", READS)
def test_same_json(apis, pql):
    japi, tapi, _ = apis
    want = japi.query("i", pql)["results"]
    got = tapi.query("i", pql)
    assert json.dumps(got) == json.dumps({"results": want})


def test_read_paths_reach_each_family(apis, monkeypatch):
    """The query list drives the whole-plane and selected-row families of
    the port, and the generic count family ("off") or the whole-tree
    family ("default") for compound Counts (counted by wrapping the
    families)."""
    _, tapi, config = apis
    fused = tapi.executor.fused
    compound = "run_count_batch" if config == "off" else "run_tree_counts"
    seen = []
    for name in ("run_rowcounts_batch", "run_selected_counts", compound):
        fn = getattr(fused, name)
        monkeypatch.setattr(fused, name,
                            lambda *a, _f=fn, _n=name, **k:
                            (seen.append(_n), _f(*a, **k))[1])
    for pql in READS[:5]:
        tapi.query("i", pql)
    assert {"run_rowcounts_batch", "run_selected_counts",
            compound} <= set(seen)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_writes_same_json(index_dir, tmp_path, monkeypatch, config):
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    shutil.copytree(index_dir, jdir)
    shutil.copytree(index_dir, tdir)
    jh, japi = _jax_api(jdir, monkeypatch, config)
    th, tapi = _port_api(tdir, config)
    try:
        for pql in WRITES:
            want = japi.query("i", pql)["results"]
            assert tapi.query("i", pql) == {"results": want}, pql
    finally:
        th.close()
        jh.close()
    # each package reopens what the other wrote: same answers again
    jh, japi = _jax_api(tdir, monkeypatch, config)
    th, tapi = _port_api(jdir, config)
    try:
        for pql in (COUNTS, "Row(h=3)", "Count(All())", "TopN(h)"):
            assert tapi.query("i", pql) == \
                {"results": japi.query("i", pql)["results"]}
    finally:
        th.close()
        jh.close()


@pytest.mark.parametrize("config", list(CONFIGS))
def test_range_on_fields_named_like_options(tmp_path, monkeypatch, config):
    """``Range(n=1)`` and ``Range(limit=1)`` name the fields ``n`` and
    ``limit`` (only ``from`` and ``to`` are ``Range`` options), as in the
    JAX package."""
    root = str(tmp_path / "data")
    h = JHolder(root).open()
    idx = h.create_index("i")
    for name in ("n", "limit"):
        idx.create_field(name).import_bits(
            np.array([1, 1, 2], np.uint64),
            np.array([3, SW + 4, 5], np.uint64))
    h.close()
    jh, japi = _jax_api(root, monkeypatch, config)
    th, tapi = _port_api(root, config)
    try:
        for pql in ("Count(Range(n=1))", "Count(Range(limit=1))",
                    "Range(limit=2)", "Count(Range(n=1))Count(Range(n=2))"):
            want = japi.query("i", pql)["results"]
            assert tapi.query("i", pql) == {"results": want}, pql
        assert want == [2, 1]
    finally:
        tapi.executor.close()
        th.close()
        jh.close()


def test_keyed_calls_equal(tmp_path, monkeypatch):
    """The calls the first slices refused on a keyed field or index (TopN
    on a keyed field, bitmap results on a keyed index, import-roaring into
    either) answer what ``pilosa_tpu`` answers, each package on its own
    copy, and leave the same fragment bytes."""
    monkeypatch.setenv("PILOSA_PALLAS_INTERPRET", "1")
    outs, files = [], []
    for name in ("jax", "port"):
        root = str(tmp_path / name)
        if name == "jax":
            holder = JHolder(root).open()
            api = JAPI(holder, JExecutor(holder, plane_paging=False,
                                         kernel_tier="pallas"))
        else:
            holder = THolder(root).open()
            api = TAPI(holder, TExecutor(holder, device="cpu"))
        out = []
        try:
            api.create_index("k", {"keys": True})
            api.create_field("k", "f")
            api.create_index("u")
            api.create_field("u", "kf", {"keys": True})
            api.create_field("u", "f")
            api.import_bits("u", "kf", row_keys=["x", "y", "x"],
                            col_ids=[3, 4, 5])
            api.import_bits("k", "f", row_ids=[1, 1, 2],
                            col_keys=["c1", "c2", "c3"])
            blob = jroaring.serialize(np.array([1, 5], np.uint64))
            for index, field in (("k", "f"), ("u", "kf"), ("u", "f")):
                out.append(api.import_roaring(index, field, 0, blob))
            for index, pql in (("u", "TopN(kf)"),
                               ("k", "Row(f=2)"), ("k", "All()"),
                               ("k", "Union(Row(f=2), Row(f=0))"),
                               ("k", 'ConstRow(columns=["c2"])'),
                               ("k", "Count(Row(f=1))")):
                try:
                    out.append(api.query(index, pql)["results"])
                except Exception as e:  # noqa: BLE001 — compared below
                    out.append(("error", type(e).__name__, str(e)))
        finally:
            if name == "jax":
                api.executor.translate.close()
            else:
                api.executor.close()
            holder.close()
        outs.append(json.dumps(out))
        files.append({os.path.relpath(os.path.join(d, f), root):
                      open(os.path.join(d, f), "rb").read()
                      for d, _, fs in os.walk(root) for f in fs
                      if "sqlite" not in f and f != ".meta"})
    assert outs[1] == outs[0]
    assert files[1] == files[0]


def test_errors_are_400(apis):
    _, tapi, _ = apis
    for pql in ("Count(Row(nope=1))", "Count(", "Row(f=1, g=2)",
                "Sum(field=f)"):
        with pytest.raises(ApiError) as e:
            tapi.query("i", pql)
        assert e.value.status == 400
    with pytest.raises(ApiError) as e:
        tapi.query("missing", "Count(Row(f=1))")
    assert e.value.status == 404


def _post(base: str, path: str, body: bytes) -> dict:
    req = urllib.request.Request(base + path, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def _get(base: str, path: str) -> dict:
    with urllib.request.urlopen(base + path, timeout=60) as resp:
        return json.loads(resp.read())


def test_rest_same_json(apis):
    japi, tapi, _ = apis
    js = JServer(japi, "127.0.0.1", 0).start()
    ts = TServer(tapi, "127.0.0.1", 0).start()
    try:
        jb = "http://%s:%d" % js.address
        tb = "http://%s:%d" % ts.address
        for pql in (COUNTS, READS[4], "TopN(f, Row(g=0), n=5)", "Row(h=0)"):
            assert _post(tb, "/index/i/query", pql.encode()) \
                == _post(jb, "/index/i/query", pql.encode())
        assert _get(tb, "/schema") == _get(jb, "/schema")
        status = _get(tb, "/status")
        assert status["device"] == "cpu" and status["state"] == "NORMAL"
    finally:
        ts.close()
        js.close()


def test_rest_schema_writes(tmp_path):
    holder = THolder(str(tmp_path)).open()
    server = TServer(TAPI(holder, TExecutor(holder, device="cpu")),
                     "127.0.0.1", 0).start()
    try:
        base = "http://%s:%d" % server.address
        assert _post(base, "/index/x", b"{}") == {"success": True}
        assert _post(base, "/index/x/field/f", b'{"options": {}}') \
            == {"success": True}
        assert _post(base, "/index/x/query", b"Set(3, f=1)Count(Row(f=1))") \
            == {"results": [True, 1]}
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base, "/index/x", b"{}")
        assert e.value.code == 409
    finally:
        server.close()
        holder.close()


def test_server_cli(index_dir):
    proc = subprocess.Popen(
        [sys.executable, "-m", "pilosa_tpu_torch.server", "--data-dir",
         index_dir, "--bind", "127.0.0.1:0", "--device", "cpu"],
        cwd=REPO, stdout=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert "(cpu)" in line, line
        addr = line.split(" on ")[1].split(" ")[0]
        got = _post(f"http://{addr}", "/index/i/query",
                    b"Count(Row(f=1))")
        assert isinstance(got["results"][0], int)
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def test_executor_without_card_raises(index_dir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    holder = THolder(index_dir).open()
    try:
        with pytest.raises(RuntimeError, match="CUDA"):
            TExecutor(holder)
    finally:
        holder.close()


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_import_hygiene():
    files = sorted((REPO / "pilosa_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 15
    bad = [(str(p.relative_to(REPO)), m) for p in files for m in _imports(p)
           if m.split(".")[0] in ("jax", "jaxlib", "pilosa_tpu")]
    assert not bad


def test_import_leaves_jax_unloaded():
    code = ("import sys, pilosa_tpu_torch.server, pilosa_tpu_torch.api, "
            "pilosa_tpu_torch.engine.cuda_kernels, "
            "pilosa_tpu_torch.cli.main, pilosa_tpu_torch.api.client, "
            "pilosa_tpu_torch.api.tls, pilosa_tpu_torch.api.grpc; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'pilosa_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_concurrent_queries_agree(apis, index_dir):
    """More client threads than cores over one fresh executor (shared
    plane cache, row cache and fragments, planes built under
    contention): every answer equals the serial one."""
    import threading
    queries = [COUNTS, READS[1], READS[4], "TopN(f, Row(g=0), n=5)"]
    want = {q: apis[1].query("i", q) for q in queries}
    holder, tapi = _port_api(index_dir, apis[2])
    errors = []

    def client(k):
        try:
            for j in range(6):
                q = queries[(k + j) % len(queries)]
                if tapi.query("i", q) != want[q]:
                    errors.append(q)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(2 * (os.cpu_count() or 4))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
        tapi.executor.close()
        holder.close()
    assert not errors
