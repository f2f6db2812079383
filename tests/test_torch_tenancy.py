"""The port's tenancy package against ``pilosa_tpu.tenancy``.

- Eviction order: the LRU with no governor, the governor's keep-score
  over recency, leased entries skipped, ``target_bytes``, reasons counted,
  one tenant's eviction, held against the JAX cache fed the same inserts,
  touches and telemetry, with ``time.monotonic`` patched in both governors.
- Paged Counts over a plane past the budget (cases of
  ``tests/test_tenancy.py``): cold, warm, a write into a resident page, a
  write into a page that is not resident, a byte quota that denies every
  page (the oracle answers), and a quota that admits a query's first
  page and denies the rest; in the "off" and default configurations, the
  answers and ``tenancy_status()`` (less the page-in seconds) equal to the
  reference's.
- QoS: the qps bucket, the slot quota, a disabled QoS, the executor's
  admission before its slot, and the REST 503 with ``Retry-After`` and the
  ``tenantThrottled`` body in both packages.
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from pilosa_tpu.api import API as JAPI
from pilosa_tpu.api import Server as JServer
from pilosa_tpu.exec import Executor as JExecutor
from pilosa_tpu.exec.planes import PlaneCache as JPlaneCache
from pilosa_tpu.store import Holder as JHolder
from pilosa_tpu.tenancy import ResidencyGovernor as JGovernor
from pilosa_tpu.tenancy import TenantQos as JQos
from pilosa_tpu.tenancy import TenantThrottledError as JThrottled
from pilosa_tpu.tenancy import governor as jgovernor
from pilosa_tpu_torch.api import API as TAPI
from pilosa_tpu_torch.api import Server as TServer
from pilosa_tpu_torch.exec import Executor as TExecutor
from pilosa_tpu_torch.exec.planes import PlaneCache as TPlaneCache
from pilosa_tpu_torch.store import Holder as THolder
from pilosa_tpu_torch.tenancy import ResidencyGovernor as TGovernor
from pilosa_tpu_torch.tenancy import TenantQos as TQos
from pilosa_tpu_torch.tenancy import TenantThrottledError as TThrottled
from pilosa_tpu_torch.tenancy import governor as tgovernor
from pilosa_tpu_torch.testing import share_cpu_threads

share_cpu_threads()

SW = 1 << 20
CONFIGS = {"off": {"count_batch_window": "off", "tree_fusion": False},
           "default": {}}

# -- eviction order ---------------------------------------------------------


class _Fake:
    def __init__(self, nbytes=1024):
        self.plane = np.zeros(max(1, nbytes // 4), dtype=np.uint32)
        self.delta = None


K1 = ("plane", "a", "f", "standard", (0,))
K2 = ("plane", "a", "g", "standard", (0,))
K3 = ("plane", "b", "f", "standard", (0,))
K4 = ("page", "b", "h", "standard", (1, 2))


def _caches(governed: bool, budget=1 << 30):
    jg, tg = (JGovernor(), TGovernor()) if governed else (None, None)
    jc = JPlaneCache(place=lambda h: h, budget_bytes=budget, governor=jg)
    tc = TPlaneCache("cpu", budget_bytes=budget, governor=tg)
    return (jc, jg), (tc, tg)


def _both(pair, fn):
    return [fn(c, g) for c, g in pair]


@pytest.fixture
def clock(monkeypatch):
    """One patched ``time.monotonic`` for both governors."""
    now = [1000.0]
    monkeypatch.setattr(jgovernor.time, "monotonic", lambda: now[0])
    monkeypatch.setattr(tgovernor.time, "monotonic", lambda: now[0])
    return now


def test_lru_order_without_governor():
    pair = _caches(False)
    for c, _ in pair:
        for k in (K1, K2, K3, K4):
            c._insert_entry(k, (0,), _Fake(), 1024)
    pair[0][0]._touch(K1)
    with pair[1][0]._lock:
        pair[1][0]._touch(K1)
    orders = _both(pair, lambda c, g: c._eviction_order(set()))
    assert orders[0] == orders[1] == [K2, K3, K4, K1]


def test_governor_sequence_equal(clock):
    """The same telemetry, in the same order, over the decay boundary:
    keep-scores and eviction orders equal the JAX governor's."""
    pair = _caches(True)
    sizes = {K1: 4096, K2: 1024, K3: 2048, K4: 8192}
    for c, _ in pair:
        for k in (K1, K2, K3, K4):
            c._insert_entry(k, (0,), _Fake(sizes[k]), sizes[k])
    steps = [("hit", K2), ("hit", K2), ("build", K2, 2.0), ("hit", K1),
             ("tick", 60.0), ("hit", K3), ("build", K4, 0.0005),
             ("hit", K4), ("tick", 70.0), ("hit", K1), ("hit", K1),
             ("build", K1, 0.25), ("tick", 130.0), ("hit", K3),
             ("evict", K2)]
    for step in steps:
        if step[0] == "tick":
            clock[0] += step[1]
        for c, g in pair:
            if step[0] == "hit":
                with c._lock:
                    c._touch(step[1])
            elif step[0] == "build":
                g.note_build(step[1], step[2])
            elif step[0] == "evict":
                with c._lock:
                    if step[1] in c._entries:
                        c._evict_entry(step[1], "test")
        scores = _both(pair, lambda c, g: [g.keep_score(k, sizes[k])
                                           for k in (K1, K2, K3, K4)])
        assert scores[0] == scores[1], step
        orders = _both(pair, lambda c, g: c._eviction_order(set()))
        assert orders[0] == orders[1], step
    assert pair[1][0].evictions == pair[0][0].evictions == 1


def test_leases_target_and_tenant_equal():
    for what in ("lease", "target", "tenant", "reasons"):
        pair = _caches(False)
        for c, _ in pair:
            for k in (K1, K2, K3):
                c._insert_entry(k, (0,), _Fake(), 1024)
        out = []
        for c, _ in pair:
            if what == "lease":
                c.begin_query()
                c._lease(K1)
                freed = c.evict_unpinned()
                c.end_query()
            elif what == "target":
                freed = c.evict_unpinned(target_bytes=1)
            elif what == "tenant":
                freed = c.evict_tenant("a", need_bytes=1 << 30)
            else:
                freed = c.evict_unpinned(reason="oom")
            out.append((freed, sorted(c._entries), c.evictions,
                        dict(c._evictions_by_reason), c.tenant_bytes("a"),
                        c.tenant_bytes("b")))
        assert out[0] == out[1], what


def test_budget_pass_skips_leased_entries():
    """A query's own entries stay while it runs: the cache may pass its
    budget (the reference's behaviour)."""
    pair = _caches(False, budget=3000)
    out = []
    for c, _ in pair:
        c.begin_query()
        for k in (K1, K2, K3):
            c._insert_entry(k, (0,), _Fake(), 1024, lease=True)
        over = (sorted(c._entries), c._bytes)
        c.end_query()
        c._insert_entry(K4, (0,), _Fake(), 1024)
        out.append((over, sorted(c._entries), c._bytes, c.evictions))
    assert out[0] == out[1]
    assert out[1][0][1] == 3072 and out[1][3] == 2


# -- paged Counts -----------------------------------------------------------


def _fill_pql(n_shards: int, n_rows: int, per_row: int = 3):
    pql, want = [], [0] * n_rows
    for s in range(n_shards):
        for r in range(n_rows):
            for o in range(per_row):
                pql.append(f"Set({s * SW + o * 11 + r}, f={r})")
                want[r] += 1
    return " ".join(pql), want


def _counts_pql(n_rows: int) -> str:
    return "".join(f"Count(Row(f={r}))" for r in range(n_rows))


def _strip(st: dict) -> dict:
    st = json.loads(json.dumps(st))
    st.pop("pageInSeconds", None)
    return st


def _pair(tmp_path, config, **kw):
    """A JAX and a port executor over their own copies of one empty index
    ``t1`` (field ``f``), written by the same requests."""
    out = []
    for pkg, H, E, extra in (("j", JHolder, JExecutor,
                              {"kernel_tier": "pallas"}),
                             ("t", THolder, TExecutor, {"device": "cpu"})):
        holder = H(str(tmp_path / pkg)).open()
        holder.create_index("t1").create_field("f")
        out.append((holder, E(holder, **CONFIGS[config], **extra, **kw)))
    return out


def _close(pair):
    (jh, je), (th, te) = pair
    je.translate.close()
    jh.close()
    te.close()
    th.close()


def _same(pair, pql: str):
    (_, je), (_, te) = pair
    want = je.execute("t1", pql)
    got = te.execute("t1", pql)
    assert got == want, pql
    return got


def _same_status(pair):
    (_, je), (_, te) = pair
    got, want = _strip(te.tenancy_status()), _strip(je.tenancy_status())
    assert got == want
    return got


PAGED = {"plane_budget": 1200 * 1024, "plane_page_bytes": 1 << 20}


@pytest.mark.parametrize("config", ["off", "default"])
def test_paged_cold_warm_and_writes_equal(tmp_path, monkeypatch, config):
    monkeypatch.setenv("PILOSA_PALLAS_INTERPRET", "1")
    pair = _pair(tmp_path, config, **PAGED)
    try:
        fill, want = _fill_pql(3, 4)
        _same(pair, fill)
        q = _counts_pql(4)
        assert _same(pair, q) == want                  # cold: page-ins
        st = _same_status(pair)
        assert st["paging"] and st["pageIns"] >= 2
        assert pair[1][1].planes.builds == 0
        for _ in range(3):                             # warm: page hits
            assert _same(pair, q) == want
        st = _same_status(pair)
        assert st["tenants"]["t1"]["pageHits"] >= 1
        # a write into a resident page absorbs
        _same(pair, "Set(77777, f=2)")
        want[2] += 1
        assert _same(pair, q) == want
        assert _same(pair, "Count(Row(f=2))") == [want[2]]
        # a write into a page that is not resident
        for _, ex in pair:
            ex.planes.evict_unpinned(reason="test")
        assert _same_status(pair)["residentPages"] == 0
        _same(pair, f"Set({2 * SW + 99999}, f=0) Set({SW + 55555}, f=1)")
        want[0] += 1
        want[1] += 1
        assert _same(pair, q) == want
        st = _same_status(pair)
        assert st["evictionsByReason"]["test"] >= 1
        assert pair[1][1].planes.builds == 0
    finally:
        _close(pair)


@pytest.mark.parametrize("config", ["off", "default"])
@pytest.mark.parametrize("quota", [64 * 1024, 700 * 1024])
def test_quota_denial_served_by_the_oracle(tmp_path, monkeypatch, config,
                                           quota):
    """64 KiB: no page fits, the oracle answers every page.  700 KiB: a
    page is a shard (~512 KiB), so the query's first page is admitted and
    leased, and the quota denies the rest."""
    monkeypatch.setenv("PILOSA_PALLAS_INTERPRET", "1")
    pair = _pair(tmp_path, config, tenant_byte_quota=quota, **PAGED)
    try:
        fill, want = _fill_pql(3, 4)
        _same(pair, fill)
        for _ in range(2):
            assert _same(pair, _counts_pql(4)) == want
        st = _same_status(pair)
        assert st["quotaDenials"] >= 1 and st["oracleServes"] >= 1
        assert st["tenants"]["t1"]["residentBytes"] <= quota
        assert st["tenantByteQuota"] == quota
        if quota > 512 * 1024:
            assert st["pageIns"] >= 1
    finally:
        _close(pair)


def test_under_budget_plane_never_pages(tmp_path, monkeypatch):
    monkeypatch.setenv("PILOSA_PALLAS_INTERPRET", "1")
    pair = _pair(tmp_path, "off")
    try:
        fill, want = _fill_pql(3, 4)
        _same(pair, fill)
        assert _same(pair, _counts_pql(4)) == want
        st = _same_status(pair)
        assert st["pageIns"] == 0 and st["residentPages"] == 0
        assert pair[1][1].planes.builds >= 1
    finally:
        _close(pair)


def test_paging_off_and_device_seconds_refused(tmp_path):
    holder = THolder(str(tmp_path)).open()
    holder.create_index("t1").create_field("f")
    ex = TExecutor(holder, device="cpu", plane_paging=False, **PAGED)
    try:
        fill, want = _fill_pql(3, 4)
        ex.execute("t1", fill)
        assert ex.execute("t1", _counts_pql(4)) == want
        st = ex.tenancy_status()
        assert st["paging"] is False and "pageIns" not in st
    finally:
        ex.close()
    # the device-seconds quota is served now (it reads the cost ledger);
    # the shed itself is held against the reference in
    # test_torch_tracing.py
    ex = TExecutor(holder, device="cpu", tenant_device_seconds_quota=1.0)
    try:
        assert ex.qos.enabled
        assert ex.tenancy_status()["qos"]["deviceSecondsQuota"] == 1.0
    finally:
        ex.close()
    holder.close()


def test_pager_partition_and_oracle_equal(tmp_path, monkeypatch):
    monkeypatch.setenv("PILOSA_PALLAS_INTERPRET", "1")
    pair = _pair(tmp_path, "off", **PAGED)
    try:
        fill, want = _fill_pql(3, 4)
        _same(pair, fill)
        out = []
        for holder, ex in pair:
            field = holder.index("t1").field("f")
            pages = ex.pager.partition(field, "standard", (0, 1, 2))
            single = ex.pager.partition(field, "standard", (0,))
            got = ex.pager.oracle_counts(field, "standard", (0, 1, 2),
                                         [0, 1, None, 2, 3, 99])
            out.append((pages, single, got))
        assert out[0] == out[1]
        assert out[1][2] == [want[0], want[1], 0, want[2], want[3], 0]
    finally:
        _close(pair)


# -- QoS --------------------------------------------------------------------


def test_qos_units_equal(monkeypatch):
    now = [50.0]
    import pilosa_tpu.tenancy.qos as jq
    import pilosa_tpu_torch.tenancy.qos as tq
    monkeypatch.setattr(jq.time, "monotonic", lambda: now[0])
    monkeypatch.setattr(tq.time, "monotonic", lambda: now[0])
    seqs = []
    for Q, Err in ((JQos, JThrottled), (TQos, TThrottled)):
        log = []
        qps = Q(qps_quota=2.0)
        slots = Q(slot_quota=2)
        off = Q()
        for step in range(8):
            for name, q, tenant in (("qps", qps, "a"), ("qps", qps, "b"),
                                    ("slots", slots, "a")):
                try:
                    q.admit(tenant)
                    log.append((name, tenant, "ok"))
                except Err as e:
                    log.append((name, tenant, e.kind, e.quota,
                                round(e.retry_after, 6)))
            if step % 3 == 2:
                slots.release("a")
            now[0] += 0.3
            off.admit("a")
            off.release("a")
        log.append((qps.payload(), slots.payload(), off.enabled,
                    off.payload()["shedTotal"], qps.sheds("a")))
        seqs.append(log)
    assert seqs[0] == seqs[1]


def test_executor_sheds_before_its_slot(tmp_path):
    holder = THolder(str(tmp_path)).open()
    holder.create_index("a").create_field("f")
    ex = TExecutor(holder, device="cpu", tenant_qps_quota=1.0)
    try:
        assert ex.execute("a", "Count(Row(f=1))") == [0]
        with pytest.raises(TThrottled) as ei:
            ex.execute("a", "Count(Row(f=1))")
        assert ei.value.kind == "qps" and ei.value.tenant == "a"
        # the shed took no slot: every slot is free
        assert ex._exec_slots._value == ex.max_concurrent
        st = ex.tenancy_status()
        assert st["qos"]["sheds"] == {"a": 1}
        assert st["tenants"]["a"]["sheds"] == 1
    finally:
        ex.close()
        holder.close()


def _post(port: int, index: str):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/index/{index}"
                                 "/query", data=b"Count(Row(f=1))",
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, None, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Retry-After"), json.loads(e.read())


def test_rest_shed_is_a_structured_503_in_both(tmp_path):
    answers = []
    for pkg, H, E, A, S, kw in (
            ("j", JHolder, JExecutor, JAPI, JServer,
             {"plane_paging": False}),
            ("t", THolder, TExecutor, TAPI, TServer, {"device": "cpu"})):
        holder = H(str(tmp_path / pkg)).open()
        holder.create_index("a").create_field("f")
        holder.create_index("b").create_field("f")
        ex = E(holder, tenant_slot_quota=1, **kw)
        server = S(A(holder, ex), "127.0.0.1", 0).start()
        port = server.address[1]
        try:
            ex.qos.admit("a")   # tenant a's only slot, held
            shed = _post(port, "a")
            other = _post(port, "b")
            ex.qos.release("a")
            after = _post(port, "a")
            status = _strip(ex.tenancy_status())
            answers.append((shed, other, after, status["qos"],
                            status["tenants"]["a"]["sheds"]))
        finally:
            server.close()
            ex.translate.close()
            holder.close()
    assert answers[0] == answers[1]
    (code, retry, body), other, after = answers[1][:3]
    assert code == 503 and retry is not None and int(retry) >= 1
    assert body["tenantThrottled"] == {"tenant": "a", "quota": 1,
                                       "kind": "slots"}
    assert other[0] == 200 and after[0] == 200


def test_status_tenancy_block(tmp_path):
    holder = THolder(str(tmp_path)).open()
    holder.create_index("t1").create_field("f")
    ex = TExecutor(holder, device="cpu", **PAGED)
    api = TAPI(holder, ex)
    try:
        fill, want = _fill_pql(3, 4)
        ex.execute("t1", fill)
        assert ex.execute("t1", _counts_pql(4)) == want
        ten = api.status()["tenancy"]
        assert ten["paging"] is True
        for k in ("qos", "evictionsByReason", "pageBytes", "residentPages",
                  "pageIns", "pageInSeconds", "oracleServes",
                  "quotaDenials"):
            assert k in ten, k
        t1 = ten["tenants"]["t1"]
        for k in ("residentBytes", "residentPages", "pageHits",
                  "pageMisses", "hitRatio", "pageIns", "sheds"):
            assert k in t1, k
        assert t1["residentPages"] >= 1
    finally:
        ex.close()
        holder.close()


def test_governor_decay_and_prune_equal(clock):
    jg, tg = JGovernor(decay_seconds=10.0), TGovernor(decay_seconds=10.0)
    keys = [("plane", "a", f"f{i}", "standard", (0,)) for i in range(6)]
    for step in range(40):
        k = keys[(step * 7) % 6]
        for g in (jg, tg):
            g.note_hit(k)
            if step % 5 == 0:
                g.note_build(k, step / 10)
        clock[0] += 1.7
        assert ([jg.keep_score(k, 4096) for k in keys]
                == [tg.keep_score(k, 4096) for k in keys])
    assert jg.admit_bytes(0, 1) and tg.admit_bytes(0, 1)
    q = (JGovernor(byte_quota=100), TGovernor(byte_quota=100))
    assert [g.admit_bytes(40, 60) for g in q] == [True, True]
    assert [g.admit_bytes(50, 60) for g in q] == [False, False]
