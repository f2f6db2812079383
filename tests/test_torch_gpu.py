"""The hand-written CUDA kernels against their plain PyTorch versions, and
the delta-overlay merge and fold, the word overlays, the whole-tree
programs (Shift and Limit among them), the time-range scan over an
overlay, the BSI and GroupBy paths, the Extract gathers, a mutex import
over a resident plane, keyed requests and a small concurrent burst
through the default executor on the card against the same calls on the
CPU; and the robustness paths on the card: a real device OOM recovered by
stage 1, a window quarantined while its kernels still run, and the
``distinct`` batcher kind; and the plane build's builder pool on the card
against the serial CPU build, a build from ``.dense`` images against the
cold one, and a page-in from images against one from snapshots; and a
deleted field's device bytes freed, and the CLI's server on the card;
and the instruments on the card: the bandwidth gauge within the HBM peak
under a burst, a profiled request's kernel time within its ledger
seconds within its wall, and a ``/debug/profile`` capture naming the
hand kernels; and a 3-node cluster on the card answering as the same
cluster on the CPU, and its backup restored into a node on the CPU
answering as the card did; and meshed executors on the card (four blocks
of one card, and over every visible card) against their CPU twins; and
the ``parallel.spmd`` programs across two NCCL processes on disjoint
cards against the same processes over gloo.
Marked ``gpu``: without a CUDA device every test skips
(``test_mesh_across_cards`` and ``test_spmd_across_processes`` without
two cards).  The file
imports nothing of JAX, so on a machine without it run it as

    python -m pytest --noconftest tests/test_torch_gpu.py -q
"""

import numpy as np
import pytest
import torch

from pilosa_tpu_torch.engine import cuda_kernels
from pilosa_tpu_torch.engine import kernels as tk
from pilosa_tpu_torch.exec.planes import _apply_plane_cells
from pilosa_tpu_torch.ingest import delta
from pilosa_tpu_torch.testing import share_cpu_threads

share_cpu_threads()

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")
    return torch.device("cuda", 0)


def _words(seed: int, shape, dev) -> torch.Tensor:
    """~25% dense int32 words with 0x80000000 and 0xFFFFFFFF planted."""
    rng = np.random.default_rng(seed)
    w = (rng.integers(0, 1 << 32, size=shape, dtype=np.uint32)
         & rng.integers(0, 1 << 32, size=shape, dtype=np.uint32))
    w[..., 0] = 0x80000000
    w[..., -1] = 0xFFFFFFFF
    return torch.from_numpy(w.view(np.int32)).to(dev)


@pytest.mark.parametrize("s,r,w", [(954, 32, 32768), (13, 5, 1000),
                                   (13, 5, 1001), (3, 1, 3)])
def test_kernels_equal_plain(dev, s, r, w):
    plane = _words(s * r + w, (s, r, w), dev)
    filt = _words(w, (s, w), dev)
    col = plane[:, 0].contiguous()
    idx = torch.tensor([r - 1, 0, r - 1], dtype=torch.int32)  # repeats
    pairs = [
        (cuda_kernels.row_counts(plane), tk.row_counts_plain(plane)),
        (cuda_kernels.row_counts(plane, filt),
         tk.row_counts_plain(plane, filt)),
        (cuda_kernels.selected_row_counts(plane, idx),
         tk.selected_row_counts_plain(plane, idx)),
        (cuda_kernels.count(filt), tk.count_plain(filt)),
        (cuda_kernels.intersect_count(filt, col),
         tk.intersect_count_plain(filt, col)),
    ]
    for got, want in pairs:
        assert torch.equal(got, want)


def test_routing_launches_on_cuda_tensors(dev):
    plane = _words(1, (4, 8, 256), dev)
    cuda_kernels.reset_launches()
    tk.row_counts(plane)
    tk.selected_row_counts(plane, torch.tensor([1, 1], dtype=torch.int32))
    tk.count(plane[:, 0].contiguous())
    tk.intersect_count(plane[:, 0].contiguous(), plane[:, 1].contiguous())
    assert cuda_kernels.LAUNCHES == dict.fromkeys(cuda_kernels.LAUNCHES, 1)


def test_wrappers_refuse_bad_input(dev):
    plane = torch.zeros((2, 4, 8), dtype=torch.int32, device=dev)
    with pytest.raises(IndexError):
        cuda_kernels.selected_row_counts(
            plane, torch.tensor([4], dtype=torch.int32))
    with pytest.raises(TypeError):
        cuda_kernels.count(plane[:, 0].to(torch.int64))
    with pytest.raises(ValueError):
        cuda_kernels.count(plane[:, :, 0])  # not contiguous
    with pytest.raises(ValueError):
        cuda_kernels.row_counts(plane, torch.zeros((2, 7), dtype=torch.int32,
                                                   device=dev))


def _overlay(seed: int, s: int, r: int, w: int, n: int, c_pad: int):
    """``n`` live cells (sign-bit and all-ones values among them) padded
    to ``c_pad`` lanes with the out-of-range flat row ``s * r``."""
    rng = np.random.default_rng(seed)
    cells = rng.choice(s * r * w, n, replace=False)
    rows = np.full(c_pad, s * r, np.int32)
    words = np.zeros(c_pad, np.int32)
    vals = np.zeros(c_pad, np.uint32)
    rows[:n], words[:n] = cells // w, cells % w
    vals[:n] = rng.integers(0, 1 << 32, n, dtype=np.uint32)
    vals[0], vals[1] = 0x80000000, 0xFFFFFFFF
    return [torch.from_numpy(a.view(np.int32)) for a in (rows, words, vals)]


@pytest.mark.parametrize("s,r,w", [(13, 5, 1001), (40, 32, 32768)])
def test_delta_merge_equal_cpu(dev, s, r, w):
    plane = _words(s + r, (s, r, w), "cpu")
    filt = _words(w + 1, (s, w), "cpu")
    cells = _overlay(s, s, r, w, 37, 64)
    slots = torch.tensor([r - 1, 0, 0, r - 1], dtype=torch.int32)
    on = [t.to(dev) for t in (plane, filt, *cells)]
    for f_cpu, f_dev in ((None, None), (filt, on[1])):
        for red in (True, False):
            want = delta.adjusted_row_counts(plane, *cells, f_cpu,
                                             reduce_shards=red)
            got = delta.adjusted_row_counts(on[0], *on[2:], f_dev,
                                            reduce_shards=red)
            assert torch.equal(got.cpu(), want)
    want = delta.adjusted_selected_counts(plane, slots, *cells)
    got = delta.adjusted_selected_counts(on[0], slots, *on[2:])
    assert torch.equal(got.cpu(), want)


def test_apply_plane_cells_equal_cpu(dev):
    s, r, w = 13, 5, 1001
    plane = _words(3, (s, r, w), "cpu")
    rng = np.random.default_rng(9)
    flat = rng.choice(s * r * w, 300, replace=False)
    vals = rng.integers(0, 1 << 32, 300, dtype=np.uint32)
    resets = [4, s * r - 1]
    reset_vals = rng.integers(0, 1 << 32, (2, w), dtype=np.uint32)
    args = (flat // w, flat % w, vals, resets, reset_vals)
    want = _apply_plane_cells(plane, *args)
    on = plane.to(dev)
    got = _apply_plane_cells(on, *args)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(on.cpu(), plane)    # out of place on the card too


def test_overlay_helpers_equal_cpu(dev):
    s, r, w = 13, 8, 1001
    plane = _words(21, (s, r, w), "cpu")
    cells = _overlay(22, s, r, w, 60, 64)
    on = [t.to(dev) for t in (plane, *cells)]
    idx = torch.tensor([5, 0, 7, 0], dtype=torch.int64)   # a repeated slot
    want = delta.overlay_gathered_rows(plane.index_select(1, idx), idx,
                                       *cells, r)
    got = delta.overlay_gathered_rows(on[0].index_select(1, idx.to(dev)),
                                      idx.to(dev), *on[1:], r)
    assert torch.equal(got.cpu(), want)
    for slot in (0, 3, r - 1):
        want = delta.overlay_row(plane[:, slot], slot, *cells, r)
        got = delta.overlay_row(on[0][:, slot], slot, *on[1:], r)
        assert torch.equal(got.cpu(), want)
    assert torch.equal(on[0].cpu(), plane)       # the plane is untouched


@pytest.mark.parametrize("with_delta", [False, True])
def test_tree_counts_equal_cpu(dev, with_delta):
    """Solo and windowed tree programs on the card against the CPU; the
    popcount of every folded tree is one ``count`` launch."""
    from pilosa_tpu_torch.exec.fused import FusedCache
    from pilosa_tpu_torch.ingest.delta import DeltaOverlay
    s, r, w = 40, 16, 32768
    plane = _words(31, (s, r, w), "cpu")
    extras = (_words(32, (s, w), "cpu"),)
    d_cpu = d_dev = None
    if with_delta:
        cells = _overlay(33, s, r, w, 300, 512)
        d_cpu = DeltaOverlay(*cells, n=300, bits=0)
        d_dev = DeltaOverlay(*(c.to(dev) for c in cells), n=300, bits=0)
    P, X, Z = tk.TREE_PUSH, tk.TREE_PUSHX, tk.TREE_ZERO
    AND, OR, ANDNOT, XOR = (tk.TREE_AND, tk.TREE_OR, tk.TREE_ANDNOT,
                            tk.TREE_XOR)
    slots = (3, 9, 0)
    progs = (((P, 0), (P, 1), (OR, 0), (X, 0), (AND, 0)),
             ((P, 2), (P, 0), (ANDNOT, 0), (Z, 0), (XOR, 0)),
             ((P, 1),))
    fused = FusedCache()
    plane_dev, extras_dev = plane.to(dev), tuple(e.to(dev) for e in extras)
    for window in (progs[:1], progs[2:], progs):
        want = fused.run_tree_counts(plane, slots, window, extras, d_cpu)
        cuda_kernels.reset_launches()
        got = fused.run_tree_counts(plane_dev, slots, window, extras_dev,
                                    d_dev)
        assert torch.equal(got.cpu(), want)
        assert cuda_kernels.LAUNCHES["count"] == len(window)
    want = fused.run_tree_words(plane, slots, progs[2], extras, d_cpu)
    got = fused.run_tree_words(plane_dev, slots, progs[2], extras_dev, d_dev)
    assert got.is_contiguous() and torch.equal(got.cpu(), want)


def test_time_range_scan_over_overlay_equal_cpu(dev):
    """The time plane's lane OR with its (row, bucket) overlay, cells that
    set and cells that clear, on the card against the CPU."""
    from pilosa_tpu_torch.exec.fused import FusedCache
    from pilosa_tpu_torch.ingest.delta import DeltaOverlay
    s, rb, w = 40, 128, 4096
    plane = _words(41, (s, rb, w), "cpu")
    rows, words, vals = _overlay(42, s, rb, w, 700, 1024)
    vals[::3] = 0                       # clears: the cell replaces its word
    d_cpu = DeltaOverlay(rows, words, vals, n=700, bits=0)
    d_dev = DeltaOverlay(rows.to(dev), words.to(dev), vals.to(dev), n=700,
                         bits=0)
    on = plane.to(dev)
    for start, length in ((0, 1), (7, 28), (100, 28), (0, rb), (37, 2)):
        for d_c, d_d in ((None, None), (d_cpu, d_dev)):
            want = FusedCache.run_time_range(plane, start, length, d_c)
            got = FusedCache.run_time_range(on, start, length, d_d)
            assert torch.equal(got.cpu(), want), (start, length)
    assert torch.equal(on.cpu(), plane)        # the plane is untouched


def test_shift_limit_counts_through_count_kernel(dev):
    """Shift and Limit trees on the card: their words equal the CPU's and
    each tree's popcount is one ``count`` launch, and each ``Limit`` one
    more (its per-shard bases, ``engine.kernels.rank_limit``)."""
    from pilosa_tpu_torch.exec.fused import FusedCache
    s, r, w = 40, 8, 32768
    plane = _words(51, (s, r, w), "cpu")
    P, SH, LIM = tk.TREE_PUSH, tk.TREE_SHIFT, tk.TREE_LIMIT
    progs = (((P, 0), (SH, 1)), ((P, 1), (SH, 33)),
             ((P, 2), (LIM, (5, 1000))), ((P, 0), (LIM, (0, -1))),
             ((P, 1), (LIM, (10 ** 6, 3 * 10 ** 6))),
             ((P, 2), (SH, 7), (LIM, (3, 17))))
    slots = (2, 5, 7)
    fused = FusedCache()
    on = plane.to(dev)
    for prog in progs:
        want = fused.run_tree_counts(plane, slots, (prog,))
        cuda_kernels.reset_launches()
        got = fused.run_tree_counts(on, slots, (prog,))
        assert torch.equal(got.cpu(), want), prog
        limits = sum(1 for op, _ in prog if op == LIM)
        assert cuda_kernels.LAUNCHES["count"] == 1 + limits, prog
        assert torch.equal(
            fused.run_tree_words(on, slots, prog).cpu(),
            fused.run_tree_words(plane, slots, prog)), prog
    got = fused.run_tree_counts(on, slots, progs)       # one window
    assert torch.equal(got.cpu(), fused.run_tree_counts(plane, slots, progs))


def test_concurrent_burst_equal_cpu(dev, tmp_path):
    """A small concurrent burst through the default executor on the card
    gives the CPU executor's answers."""
    import threading

    from pilosa_tpu_torch.api import API
    from pilosa_tpu_torch.exec import Executor
    from pilosa_tpu_torch.store import Holder
    rng = np.random.default_rng(5)
    holder = Holder(str(tmp_path)).open()
    idx = holder.create_index("i")
    for name, rows in (("f", 8), ("g", 2)):
        idx.create_field(name)
        cols = rng.choice(6 << 20, 40000, replace=False).astype(np.uint64)
        idx.field(name).import_bits(
            rng.integers(0, rows, len(cols)).astype(np.uint64), cols)
        idx.note_columns(cols)
    mix = ["".join(f"Count(Row(f={r}))" for r in range(8)),
           "Count(Row(f=1))Count(Row(f=6))", "TopN(f, Row(g=0), n=5)",
           "Count(Intersect(Row(f=1), Union(Row(f=2), Row(f=5)), Row(g=0)))"
           "Count(Difference(Union(Row(f=1), Row(f=2)), Row(f=3)))"
           "Count(Xor(Row(f=4), Row(f=7)))Count(Not(Row(f=0)))"]
    cpu = API(holder, Executor(holder, device="cpu",
                               count_batch_window="off"))
    want = {q: cpu.query("i", q) for q in mix}
    api = API(holder, Executor(holder, device=dev))
    errors = []

    def client(k):
        try:
            for j in range(4):
                q = mix[(k + j) % len(mix)]
                if api.query("i", q) != want[q]:
                    errors.append(q)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))

    try:
        threads = [threading.Thread(target=client, args=(k,), daemon=True)
                   for k in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors[:3]
    finally:
        api.executor.close()
        holder.close()


@pytest.mark.parametrize("s,r,w", [(954, 22, 32768), (2048, 22, 1),
                                   (5, 22, 1)])
def test_row_counts_bsi_shapes_equal_plain(dev, s, r, w):
    """``row_counts`` with a filter at the BSI path's shapes: the bit
    plane of Sum's ``bit_counts`` and the overlay's mini plane."""
    plane = _words(s + r + w, (s, r, w), dev)
    filt = _words(w + 3, (s, w), dev)
    assert torch.equal(cuda_kernels.row_counts(plane, filt),
                       tk.row_counts_plain(plane, filt))


def _bsi_plane(seed: int, s: int, depth: int, w: int) -> np.ndarray:
    """uint32[s, depth + 2, w]: ~60% of columns hold a value."""
    rng = np.random.default_rng(seed)
    vals = rng.integers(-(1 << depth) + 1, 1 << depth, (s, w * 32))
    exists = rng.random((s, w * 32)) < 0.6
    vals = np.where(exists, vals, 0)

    def pack(bits):
        return np.packbits(bits, axis=-1, bitorder="little").view(np.uint32)

    rows = [pack(exists), pack(vals < 0)]
    rows += [pack((np.abs(vals) >> b) & 1 == 1) for b in range(depth)]
    return np.stack(rows, axis=1)


def test_bsi_functions_equal_cpu(dev):
    """Every BSI function on the card equals the same call on the CPU,
    the overlay's base+delta split included."""
    from pilosa_tpu_torch.engine import bsi
    from pilosa_tpu_torch.exec.fused import FusedCache
    host = _bsi_plane(61, 40, 13, 1024)
    plane = torch.from_numpy(host.view(np.int32))
    filt = _words(62, (40, 1024), "cpu")
    mirror = delta.DeltaMirror(1 << 16)
    rng = np.random.default_rng(63)
    cells = {(int(s) * 15 + int(r), int(w)): int(v) for s, r, w, v in zip(
        rng.integers(0, 40, 300), rng.integers(0, 15, 300),
        rng.integers(0, 1024, 300),
        rng.integers(0, 1 << 32, 300, dtype=np.uint32))}
    mirror.absorb(cells)
    fused = FusedCache()
    masks = bsi.predicate_masks(1234, 13)
    for d in (None, "overlay"):
        ov = {x: mirror.build_bsi_overlay(x, 15, 40) if d else None
              for x in ("cpu", dev)}
        on = {"cpu": (plane, filt), dev: (plane.to(dev), filt.to(dev))}
        out = {}
        for x, (p, f) in on.items():
            out[x] = [
                fused.run_sum_plane_batch(p, (False, True), (f,), ov[x]),
                fused.run_minmax_plane_batch(p, (False, True), (f,), ov[x]),
                fused.run_range_batch(
                    p, ((("gt",), False), (("ge", "lt"), True)),
                    (masks, False, masks, True, masks, False, f), ov[x])]
            if d is None:
                out[x] += [bsi.distinct_presence(p, f)[0],
                           fused.run_percentile(p, f, 99.9)[0]]
        for got, want in zip(out[dev], out["cpu"]):
            assert torch.equal(got.cpu(), want)


def test_bsi_requests_equal_cpu(dev, tmp_path):
    """The BSI requests of chip_smoke's phase 5, through the default
    executor on the card and the "off" one on the CPU, before and after
    a value import absorbed into the overlay."""
    from pilosa_tpu_torch.api import API
    from pilosa_tpu_torch.exec import Executor
    from pilosa_tpu_torch.store import FieldOptions, Holder
    rng = np.random.default_rng(64)
    holder = Holder(str(tmp_path)).open()
    idx = holder.create_index("i")
    for name, rows in (("f", 8), ("g", 2)):
        idx.create_field(name)
        cols = rng.choice(6 << 20, 40000, replace=False).astype(np.uint64)
        idx.field(name).import_bits(
            rng.integers(0, rows, len(cols)).astype(np.uint64), cols)
    idx.create_field("amount", FieldOptions(type="int", min=-1_000_000,
                                            max=1_000_000))
    cols = rng.choice(6 << 20, 200000, replace=False).astype(np.uint64)
    idx.field("amount").import_values(
        cols, rng.integers(-1_000_000, 1_000_001, len(cols)).tolist())
    mix = ["Sum(field=amount)", "Sum(Row(g=0), field=amount)",
           "Min(field=amount)", "Max(Row(g=1), field=amount)",
           "Count(Row(amount > 250000))", "Count(Row(-1000 < amount < 1000))",
           "Count(Intersect(Row(f=1), Row(amount >= 0)))",
           "TopN(f, Row(amount > 900000), n=5)",
           "Percentile(field=amount, nth=99)",
           "Distinct(Row(amount > 999000), field=amount)"]
    cpu = API(holder, Executor(holder, device="cpu",
                               count_batch_window="off", tree_fusion=False))
    api = API(holder, Executor(holder, device=dev))
    try:
        for q in mix:
            assert api.query("i", q) == cpu.query("i", q), q
        more = rng.choice(6 << 20, 1000, replace=False).tolist()
        api.import_values("i", "amount", col_ids=more,
                          values=rng.integers(-1_000_000, 1_000_001,
                                              1000).tolist())
        builds = api.executor.planes.builds
        for q in mix[:6]:
            assert api.query("i", q) == cpu.query("i", q), q
        assert api.executor.planes.builds == builds
    finally:
        api.executor.close()
        holder.close()


@pytest.mark.parametrize("agg", [None, "sum", "minmax"])
@pytest.mark.parametrize("with_delta", [False, True])
def test_groupby_out_equal_cpu(dev, agg, with_delta):
    """One GroupBy block on the card equals the same block on the CPU,
    through the row_counts kernel (and count for Min/Max)."""
    from pilosa_tpu_torch.exec import groupby as gb
    s, w = 7, 2048
    prefix = _words(71, (s, 4, w), "cpu")
    last = _words(72, (s, 8, w), "cpu")
    filt = _words(73, (s, w), "cpu")
    plane = torch.from_numpy(_bsi_plane(74, s, 13, w).view(np.int32))
    combos = np.array([[0], [2], [3], [3]], np.int32)
    mirror = delta.DeltaMirror(1 << 16)
    rng = np.random.default_rng(75)
    mirror.absorb({(int(a) * 15 + int(r), int(c)): int(v)
                   for a, r, c, v in zip(
                       rng.integers(0, s, 50), rng.integers(0, 15, 50),
                       rng.integers(0, w, 50),
                       rng.integers(0, 1 << 32, 50, dtype=np.uint32))})
    out = {}
    cuda_kernels.reset_launches()
    for x in ("cpu", dev):
        ov = mirror.build_bsi_overlay(x, 15, s) if with_delta else None
        out[x] = gb.groupby_out(
            (prefix.to(x),), combos, last.to(x), filt.to(x),
            plane.to(x) if agg else None, agg, agg_delta=ov)
    assert cuda_kernels.LAUNCHES["row_counts"] > 0
    if agg == "minmax":
        assert cuda_kernels.LAUNCHES["count"] > 0
    for key, want in out["cpu"].items():
        assert torch.equal(out[dev][key].cpu(), want), key


def test_groupby_requests_equal_cpu(dev, tmp_path):
    """The GroupBy requests of chip_smoke's phase 6 through the default
    executor on the card and the "off" one on the CPU, before and after a
    set import (rows planes refresh) and a value import (the BSI
    overlay); the card's path launches row_counts and count."""
    from pilosa_tpu_torch.api import API
    from pilosa_tpu_torch.exec import Executor
    from pilosa_tpu_torch.store import FieldOptions, Holder
    rng = np.random.default_rng(76)
    holder = Holder(str(tmp_path)).open()
    idx = holder.create_index("i")
    for name, rows in (("f", 32), ("g", 4)):
        idx.create_field(name)
        cols = rng.choice(6 << 20, 80000, replace=False).astype(np.uint64)
        idx.field(name).import_bits(
            rng.integers(0, rows, len(cols)).astype(np.uint64), cols)
    idx.create_field("amount", FieldOptions(type="int", min=-1_000_000,
                                            max=1_000_000))
    cols = rng.choice(6 << 20, 200000, replace=False).astype(np.uint64)
    idx.field("amount").import_values(
        cols, rng.integers(-1_000_000, 1_000_001, len(cols)).tolist())
    mix = ["GroupBy(Rows(f, limit=4), Rows(f, previous=3, limit=4))",
           "GroupBy(Rows(g), Rows(f))",
           "GroupBy(Rows(f), aggregate=Sum(field=amount))",
           "GroupBy(Rows(g), filter=Row(f=1), aggregate=Max(field=amount))",
           "GroupBy(Rows(g), Rows(f), having=Condition(count > 600), "
           "limit=20, previous=[0, 3])"]
    cpu = API(holder, Executor(holder, device="cpu",
                               count_batch_window="off", tree_fusion=False))
    api = API(holder, Executor(holder, device=dev))
    try:
        cuda_kernels.reset_launches()
        for q in mix:
            assert api.query("i", q) == cpu.query("i", q), q
        assert cuda_kernels.LAUNCHES["row_counts"] > 0
        assert cuda_kernels.LAUNCHES["count"] > 0
        builds = api.executor.planes.builds
        api.import_bits("i", "f", row_ids=rng.integers(0, 32, 500).tolist(),
                        col_ids=rng.choice(6 << 20, 500,
                                           replace=False).tolist())
        api.import_values("i", "amount",
                          col_ids=rng.choice(6 << 20, 300,
                                             replace=False).tolist(),
                          values=rng.integers(-1_000_000, 1_000_001,
                                              300).tolist())
        for q in mix:
            assert api.query("i", q) == cpu.query("i", q), q
        assert api.executor.planes.builds == builds
    finally:
        api.executor.close()
        holder.close()


def test_column_bits_equal_cpu(dev):
    """The Extract gathers on the card equal their CPU results, with the
    sign bit set in the probed words."""
    plane = _words(91, (7, 22, 1000), dev)
    rng = np.random.default_rng(91)
    word_idx = torch.from_numpy(rng.integers(0, 1000, 50))
    bit_idx = torch.from_numpy(rng.integers(0, 32, 50))
    word_idx[:2] = torch.tensor([0, 999])
    bit_idx[:2] = 31
    want = tk.column_bits(plane.cpu(), word_idx, bit_idx)
    got = tk.column_bits(plane, word_idx.to(dev), bit_idx.to(dev))
    assert torch.equal(got.cpu(), want)
    gw = torch.from_numpy(rng.integers(0, 1000, (7, 40)))
    gb = torch.from_numpy(rng.integers(0, 32, (7, 40)))
    want = tk.column_bits_grouped(plane.cpu(), gw, gb, torch.arange(7))
    got = tk.column_bits_grouped(plane, gw.to(dev), gb.to(dev),
                                 torch.arange(7, device=dev))
    assert torch.equal(got.cpu(), want)
    shards = torch.tensor([6, 0, 3])
    want = tk.column_bits_grouped(plane.cpu(), gw[:3], gb[:3], shards)
    got = tk.column_bits_grouped(plane, gw[:3].to(dev), gb[:3].to(dev),
                                 shards.to(dev))
    assert torch.equal(got.cpu(), want)


def test_mutex_import_over_resident_plane_equal_cpu(dev, tmp_path):
    """A mutex import over a resident plane on the card: absorbed into
    the overlay (no build), the old rows' Counts drop, and every answer
    equals the "off" executor's on the CPU."""
    from pilosa_tpu_torch.api import API
    from pilosa_tpu_torch.exec import Executor
    from pilosa_tpu_torch.store import FieldOptions, Holder
    rng = np.random.default_rng(77)
    holder = Holder(str(tmp_path)).open()
    idx = holder.create_index("i")
    idx.create_field("m", FieldOptions(type="mutex"))
    idx.create_field("b", FieldOptions(type="bool"))
    cols = rng.choice(6 << 20, 200000, replace=False).astype(np.uint64)
    idx.field("m").import_bits(rng.integers(0, 16, len(cols)).astype(
        np.uint64), cols)
    idx.field("b").import_bits(rng.integers(0, 2, len(cols)).astype(
        np.uint64), cols)
    counts = "".join(f"Count(Row(m={r}))" for r in range(16))
    mix = [counts, "Count(Row(m=1))Count(Row(m=6))",
           "TopN(m, Row(b=true), n=5)", "GroupBy(Rows(m), Rows(b))",
           "Extract(Limit(Row(m=3), limit=50), Rows(m), Rows(b))"]
    cpu = API(holder, Executor(holder, device="cpu",
                               count_batch_window="off", tree_fusion=False))
    api = API(holder, Executor(holder, device=dev))
    try:
        for q in mix:
            assert api.query("i", q) == cpu.query("i", q), q
        planes = api.executor.planes
        builds, absorbs = planes.builds, planes.delta_absorbs
        before = api.query("i", counts)["results"]
        api.import_bits("i", "m", row_ids=rng.integers(0, 16, 4096).tolist(),
                        col_ids=cols[:4096].tolist())
        after = api.query("i", counts)
        assert (planes.builds, planes.delta_absorbs) == (builds,
                                                         absorbs + 1)
        assert after["results"] != before
        for q in mix:
            assert api.query("i", q) == cpu.query("i", q), q
    finally:
        api.executor.close()
        holder.close()


def test_keyed_requests_over_resident_plane_equal_cpu(dev, tmp_path):
    """Keyed TopN, GroupBy and Counts over a resident keyed plane on the
    card equal the "off" executor's answers on the CPU (one translate
    store shared), before and after a keyed import that the plane absorbs
    into its overlay."""
    from pilosa_tpu_torch.api import API
    from pilosa_tpu_torch.exec import Executor
    from pilosa_tpu_torch.store import FieldOptions, Holder
    rng = np.random.default_rng(78)
    holder = Holder(str(tmp_path)).open()
    idx = holder.create_index("i")
    idx.create_field("seg", FieldOptions(keys=True))
    idx.create_field("g")
    api = API(holder, Executor(holder, device=dev))
    cpu = API(holder, Executor(holder, device="cpu",
                               count_batch_window="off", tree_fusion=False,
                               translate=api.executor.translate))
    keys = [f"seg-{r:02d}" for r in range(1, 32)]
    cols = rng.choice(6 << 20, 200000, replace=False)
    api.import_bits("i", "seg", row_keys=[keys[r] for r in
                                          rng.integers(0, 31, len(cols))],
                    col_ids=cols.tolist())
    api.import_bits("i", "g", row_ids=rng.integers(0, 2, len(cols)).tolist(),
                    col_ids=cols.tolist())
    counts = "".join(f'Count(Row(seg="{k}"))' for k in keys[:8])
    mix = [counts, 'Count(Row(seg="seg-05"))', 'Count(Row(seg="nope"))',
           'Count(Intersect(Row(seg="seg-05"), Row(g=1)))',
           "TopN(seg, Row(g=0), n=5)", "TopN(seg, n=3)",
           'Rows(seg, like="seg-0%")', "GroupBy(Rows(seg, limit=4), Rows(g))"]
    try:
        for q in mix:
            assert api.query("i", q) == cpu.query("i", q), q
        planes = api.executor.planes
        builds, absorbs = planes.builds, planes.delta_absorbs
        before = api.query("i", counts)["results"]
        api.import_bits("i", "seg",
                        row_keys=[keys[r] for r in
                                  rng.integers(0, 8, 4096)],
                        col_ids=rng.choice(6 << 20, 4096,
                                           replace=False).tolist())
        after = api.query("i", counts)
        assert (planes.builds, planes.delta_absorbs) == (builds,
                                                         absorbs + 1)
        assert after["results"] != before
        for q in mix:
            assert api.query("i", q) == cpu.query("i", q), q
    finally:
        api.executor.close()
        holder.close()


# -- fields past the plane budget --------------------------------------------


def _sparse_csr(seed: int, n_rows: int, s: int):
    """CSR arrays over ``s`` shards with tie-heavy row sizes and lane-31
    bits (a negative int32 mask)."""
    rng = np.random.default_rng(seed)
    sizes = rng.choice([0, 1, 2, 2, 3, 3, 3], n_rows)
    n = int(sizes.sum())
    word_idx = rng.integers(0, s * 32768, n).astype(np.int32)
    lane = rng.integers(0, 32, n)
    lane[::7] = 31
    mask = (np.uint32(1) << lane.astype(np.uint32)).view(np.int32)
    r_pad = 1 << max(0, (n_rows - 1).bit_length())
    row_ptr = np.full(r_pad + 1, n, np.int32)
    row_ptr[:n_rows + 1] = np.concatenate([[0], np.cumsum(sizes)])
    n_pad = 1 << max(0, (n - 1).bit_length())
    wi = np.zeros(n_pad, np.int32)
    mk = np.zeros(n_pad, np.int32)
    wi[:n], mk[:n] = word_idx, mask
    return wi, mk, row_ptr


def test_sparse_counts_and_topk_equal_cpu(dev):
    from pilosa_tpu_torch.engine import sparse
    s = 6
    wi, mk, rp = _sparse_csr(3, 100_000, s)
    fw = _words(9, (s, 32768), torch.device("cpu"))
    cpu = [torch.from_numpy(a) for a in (wi, mk, rp)]
    gpu = [t.to(dev) for t in cpu]
    want = sparse.sparse_row_counts(fw, *cpu)
    got = sparse.sparse_row_counts(fw.to(dev), *gpu)
    assert got.dtype == torch.int32
    assert torch.equal(got.cpu(), want)
    for k in (1, 5, 64, 4096):
        wv, ws = sparse.topn_sparse(fw, *cpu, k)
        gv, gs = sparse.topn_sparse(fw.to(dev), *gpu, k)
        assert torch.equal(gv.cpu(), wv) and torch.equal(gs.cpu(), ws)
        # ties in ascending slot order
        v, sl = wv.numpy(), ws.numpy()
        assert all(v[i] > v[i + 1] or sl[i] < sl[i + 1]
                   for i in range(len(v) - 1))


def _budget_holder(path: str):
    from pilosa_tpu_torch.store import Holder
    rng = np.random.default_rng(11)
    holder = Holder(path).open()
    idx = holder.create_index("i")
    for name, rows in (("f", 40), ("g", 2)):
        idx.create_field(name)
        cols = rng.choice(5 << 20, 60000, replace=False).astype(np.uint64)
        idx.field(name).import_bits(
            rng.integers(0, rows, len(cols)).astype(np.uint64), cols)
    return holder


def test_background_built_plane_equals_sync_build(dev, tmp_path):
    from pilosa_tpu_torch.exec.planes import PlaneCache
    holder = _budget_holder(str(tmp_path))
    f = holder.index("i").field("f")
    shards = tuple(range(5))
    try:
        cache = PlaneCache(dev)
        cache.SYNC_BUILD_MAX = 1 << 20
        assert cache.field_plane_nowait("i", f, "standard", shards) is None
        cache.wait_builds()
        assert cache.build_failures == 0 and cache.builds == 1
        ps = cache.field_plane_nowait("i", f, "standard", shards)
        sync = PlaneCache("cpu").field_plane("i", f, "standard", shards)
        assert ps.plane.device.type == dev.type
        assert torch.equal(ps.plane.cpu(), sync.plane)
        assert np.array_equal(ps.row_ids, sync.row_ids)
    finally:
        holder.close()


@pytest.mark.parametrize("budget", [256 << 10, 6 << 20])
def test_streamed_sparse_and_paged_equal_cpu(dev, tmp_path, budget):
    """Past f's 40 MiB plane: a 256 KiB budget streams its filtered TopNs
    (the ~0.5 MiB sparse form does not fit either), 6 MiB serves them
    sparse; Counts go in pages on both."""
    from pilosa_tpu_torch.api import API
    from pilosa_tpu_torch.exec import Executor
    holder = _budget_holder(str(tmp_path))
    qs = ["TopN(f, Row(g=0), n=5)", "TopN(f, Row(g=1), tanimoto=20, n=9)",
          "TopN(f, Row(g=0), _rowCounts=1)", "TopN(f, n=4)",
          "".join(f"Count(Row(f={r}))" for r in range(40)),
          "Count(Row(f=3))Count(Row(f=7))", "Count(Row(f=9))"]
    cpu = API(holder, Executor(holder, device="cpu", plane_budget=budget))
    want = [cpu.query("i", q) for q in qs]
    ex = Executor(holder, device=dev, plane_budget=budget,
                  plane_page_bytes=1 << 20)
    api = API(holder, ex)
    try:
        for _ in range(2):
            assert [api.query("i", q) for q in qs] == want
        served = ex.serving_stats()["topnServed"]
        path = "streamed" if budget < (1 << 20) else "sparse"
        assert served[path] == 6 and served["host"] == 2, served
        assert ex.tenancy_status()["pageIns"] >= 2
    finally:
        ex.close()
        cpu.executor.close()
        holder.close()


def _robust_holder(root: str, f_rows: int, extra: int):
    """Index ``i``: ``f`` with ``f_rows`` rows and ``h`` with ``extra``
    rows over 6 shards (every row set somewhere), and ``g`` with 2."""
    from pilosa_tpu_torch.store import Holder
    rng = np.random.default_rng(11)
    holder = Holder(root).open()
    idx = holder.create_index("i")
    for name, rows in (("f", f_rows), ("h", extra), ("g", 2)):
        idx.create_field(name)
        cols = rng.choice(6 << 20, 20 * rows + 4000,
                          replace=False).astype(np.uint64)
        idx.field(name).import_bits(
            (np.arange(len(cols)) % rows).astype(np.uint64), cols)
    return holder


def _ballast(need: int) -> list:
    """Device tensors that leave less than ``need / 2`` allocatable: the
    free memory in one piece, then ``need / 2`` pieces until one fails
    (taking the allocator's cached blocks of that size too)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    step = max(need // 2, 2 << 20)
    free = torch.cuda.mem_get_info()[0]
    pieces = []
    if free > 2 * step:
        pieces.append(torch.empty(free - step, dtype=torch.uint8,
                                  device="cuda"))
    while True:
        try:
            pieces.append(torch.empty(step, dtype=torch.uint8,
                                      device="cuda"))
        except torch.OutOfMemoryError:
            break
    torch.cuda.empty_cache()
    return pieces


def test_real_device_oom_recovered_by_stage_one(dev, tmp_path):
    """A real ``torch.cuda.OutOfMemoryError``: with ``f``'s plane resident
    and a ballast that leaves half of ``h``'s plane free, the Count over
    ``h`` raises inside, stage 1 evicts the unleased planes and the retry
    answers the CPU's answer."""
    from pilosa_tpu_torch.api import API
    from pilosa_tpu_torch.exec import Executor
    from pilosa_tpu_torch.exec.executor import _is_device_oom
    holder = _robust_holder(str(tmp_path), 256, 16)
    qf = "".join(f"Count(Row(f={r}))" for r in range(0, 256, 4))
    qh = "".join(f"Count(Row(h={r}))" for r in range(16))
    cpu = API(holder, Executor(holder, device="cpu"))
    want = {q: cpu.query("i", q) for q in (qf, qh)}
    ex = Executor(holder, device=dev)
    ex.planes.SYNC_BUILD_MAX = 1 << 40
    api = API(holder, ex)
    ballast = None
    try:
        assert api.query("i", qf) == want[qf]
        shards = tuple(range(6))
        h_bytes = ex.planes.plane_bytes(holder.index("i").field("h"),
                                        "standard", shards)
        assert ex.planes.stats()["bytes"] >= 4 * h_bytes
        ballast = _ballast(h_bytes)
        with pytest.raises(torch.cuda.OutOfMemoryError) as ei:
            torch.empty(h_bytes, dtype=torch.uint8, device=dev)
        assert _is_device_oom(ei.value)
        del ei
        assert api.query("i", qh) == want[qh]
        st = ex.serving_stats()
        assert st["deviceOomRetries"] == 1
        assert st["deviceOomExclusiveRetries"] == 0
        assert "out of memory" in st["lastDeviceOom"]["error"].lower()
        assert st["lastDeviceOom"]["evictedBytes"] >= 4 * h_bytes
    finally:
        del ballast
        ex.close()
        cpu.executor.close()
        holder.close()
        torch.cuda.empty_cache()


def test_quarantined_window_in_flight(dev, tmp_path):
    """A window still running on the card when the watchdog quarantines
    it: its caller gets the ``readback`` stall at once, its operands and
    pinned buffer stay held (``_limbo``) until its event completes, its
    late answer is dropped, and the next window answers exactly."""
    import time

    from pilosa_tpu_torch.exec import Executor
    from pilosa_tpu_torch.exec.errors import PipelineStalledError
    holder = _robust_holder(str(tmp_path), 8, 2)
    shards = tuple(range(6))
    cpu = Executor(holder, device="cpu", count_batch_window="off")
    want = cpu.execute("i", "".join(f"Count(Row(f={r}))" for r in range(8)))
    ex = Executor(holder, device=dev, count_batch_window=0.002,
                  solo_fastlane=False, dispatch_watchdog_seconds=5.0,
                  device_health_probe_seconds=0.1)
    b = ex.batcher
    try:
        ps = ex.planes.field_plane("i", holder.index("i").field("f"),
                                   "standard", shards)
        assert b.submit_rowcounts(ps.plane)[:8].tolist() == want
        b.watchdog_s = 0.01
        time.sleep(1.2)  # the monitor's last long tick ends
        torch.cuda._sleep(2_000_000_000)  # the stream stalls ~1 s
        h = b.enqueue_rowcounts(ps.plane)
        with pytest.raises(PipelineStalledError) as ei:
            b.wait(h)
        assert ei.value.stage == "readback"
        held = list(b._limbo.values())
        assert len(held) == 1
        w = held[0]
        assert not w.event.query() and w.packed is not None
        assert w.host is not None and w.pending
        torch.cuda.synchronize()
        end = time.monotonic() + 10
        while b._limbo and time.monotonic() < end:
            time.sleep(0.02)
        assert not b._limbo
        assert h.result is None and isinstance(h.error, PipelineStalledError)
        b.watchdog_s = 5.0
        end = time.monotonic() + 10
        while time.monotonic() < end:
            assert b.submit_rowcounts(ps.plane)[:8].tolist() == want
            if b.governor.state == "healthy":
                break
            time.sleep(0.05)
        assert b.governor.state == "healthy"
    finally:
        ex.close()
        holder.close()


def test_distinct_window_equal_cpu(dev, tmp_path):
    """Concurrent Distincts through the card's batcher share presence
    scans and answer the CPU's values."""
    import threading

    from pilosa_tpu_torch.exec import Executor
    from pilosa_tpu_torch.store import FieldOptions
    holder = _robust_holder(str(tmp_path), 8, 2)
    idx = holder.index("i")
    idx.create_field("v", FieldOptions(type="int", min=-1_000_000,
                                       max=1_000_000))
    rng = np.random.default_rng(13)
    cols = rng.choice(6 << 20, 300000, replace=False).astype(np.uint64)
    idx.field("v").import_values(
        cols, rng.integers(-1_000_000, 1_000_001, len(cols)).tolist())
    qs = ["Distinct(field=v)", "Distinct(Row(f=1), field=v)"]
    cpu = Executor(holder, device="cpu", count_batch_window="off")
    want = {q: cpu.execute("i", q)[0].values for q in qs}
    ex = Executor(holder, device=dev, count_batch_window=0.05)
    got, errors = [], []
    start = threading.Barrier(8)

    def client(k):
        try:
            start.wait(30)
            q = qs[k % 2]
            got.append(ex.execute("i", q)[0].values == want[q])
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))

    try:
        threads = [threading.Thread(target=client, args=(k,), daemon=True)
                   for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not errors, errors[:3]
        assert got == [True] * 8
        st = ex.serving_stats()
        assert 2 <= st["distinctScans"] < 8 and st["distinctWindows"] >= 1
    finally:
        ex.close()
        holder.close()


def _sidecar_holder(root: str):
    """Index ``i``: ``f`` with 24 rows of every container kind over 6
    shards, written to snapshots and then a little more to the op-logs."""
    from pilosa_tpu_torch.store import Holder
    rng = np.random.default_rng(23)
    holder = Holder(root).open()
    f = holder.create_index("i").create_field("f")
    for s in range(6):
        base = s << 20
        f.import_bits(np.full(9000, 1, np.uint64),
                      (base + np.arange(5000, 14000)).astype(np.uint64))
        f.import_bits(rng.integers(0, 24, 30000).astype(np.uint64),
                      (base + rng.integers(0, 1 << 20, 30000))
                      .astype(np.uint64))
    for frag in f.standard_view().fragments.values():
        frag.snapshot()
    f.import_bits(rng.integers(0, 24, 500).astype(np.uint64),
                  rng.integers(0, 6 << 20, 500).astype(np.uint64))
    return holder


def _serial_cpu_plane(field, shards):
    """The plain build: one fragment after another on this thread, from
    the snapshots, no sidecars."""
    from pilosa_tpu_torch.exec.planes import PlaneCache
    cache = PlaneCache("cpu", sidecars=False)
    cache.BUILD_WORKERS = 1
    return cache._build_plane(field, "standard", shards)


def test_pool_build_on_card_equals_serial_cpu_build(dev, tmp_path):
    from pilosa_tpu_torch.exec.planes import PlaneCache
    holder = _sidecar_holder(str(tmp_path))
    f = holder.index("i").field("f")
    shards = tuple(range(6))
    try:
        cache = PlaneCache(dev)
        cache.SYNC_BUILD_MAX = 0           # writes images
        cache.BUILD_CHUNK_BYTES = 1        # one shard a chunk: both buffers
        ps = cache._build_plane(f, "standard", shards)
        want = _serial_cpu_plane(f, shards)
        assert ps.plane.device.type == "cuda"
        assert torch.equal(ps.plane.cpu(), want.plane)
        assert cache.warm_misses == 6 and cache.warm_hits == 0
    finally:
        holder.close()


def test_warm_build_on_card_equals_cold(dev, tmp_path):
    from pilosa_tpu_torch.exec.planes import PlaneCache
    holder = _sidecar_holder(str(tmp_path))
    f = holder.index("i").field("f")
    shards = tuple(range(6))
    try:
        cold_cache = PlaneCache(dev)
        cold_cache.SYNC_BUILD_MAX = 0
        cold = cold_cache._build_plane(f, "standard", shards)
        warm_cache = PlaneCache(dev)
        warm = warm_cache._build_plane(f, "standard", shards)
        assert warm_cache.warm_hits == 6 and warm_cache.warm_misses == 0
        assert torch.equal(warm.plane, cold.plane)
        assert torch.equal(
            tk.row_counts(warm.plane),
            tk.row_counts_plain(_serial_cpu_plane(f, shards).plane)
            .to(dev))
    finally:
        holder.close()


def test_page_in_from_images_equals_from_snapshots(dev, tmp_path):
    from pilosa_tpu_torch.exec import Executor
    holder = _sidecar_holder(str(tmp_path))
    q = "".join(f"Count(Row(f={r}))" for r in range(24))
    paged = {"plane_budget": 3 << 20, "plane_page_bytes": 1 << 20}
    try:
        cold = Executor(holder, device=dev, plane_sidecars=False, **paged)
        want = cold.execute("i", q)
        assert cold.tenancy_status()["pageIns"] >= 2
        cold.close()
        ex = Executor(holder, device=dev, **paged)
        assert ex.execute("i", q) == want      # page-ins write images
        assert ex.planes.warm_misses == 6
        ex.planes.evict_unpinned(reason="test")
        assert ex.execute("i", q) == want      # page-ins read them
        assert ex.planes.warm_hits == 6
        cpu = Executor(holder, device="cpu", plane_sidecars=False, **paged)
        assert cpu.execute("i", q) == want
        cpu.close()
        ex.close()
    finally:
        holder.close()


def test_crash_restart_reads_images_warm_and_imports_durably(dev, tmp_path):
    """Phase 12's crash restart at 32 shards: a holder that served and
    took writes is left unclosed; ``Holder(fsync=True)`` reopens the
    directory, the first 32-Count builds ``f`` from its images (every
    fragment a warm hit), and a set and a mutex import each fsync every
    op-log they touched once; every answer equals the numpy oracle."""
    import json
    import os
    import urllib.request

    from pilosa_tpu_torch.api import API, Server
    from pilosa_tpu_torch.exec import Executor
    from pilosa_tpu_torch.store import FieldOptions, Holder, roaring
    from pilosa_tpu_torch.store import oplog as toplog
    shards, rows = 32, 32
    rng = np.random.default_rng(12)
    words = (rng.integers(0, 1 << 32, (shards, rows, 32768), np.uint32)
             & rng.integers(0, 1 << 32, (shards, rows, 32768), np.uint32))
    root = str(tmp_path / "d")
    h = Holder(root).open()
    idx = h.create_index("bench", track_existence=False)
    f = idx.create_field("f")
    idx.create_field("m", FieldOptions(type="mutex"))
    frag_dir = f"{root}/bench/f/views/standard/fragments"
    os.makedirs(frag_dir, exist_ok=True)
    h.close()
    for s in range(shards):
        with open(f"{frag_dir}/{s}", "wb") as fh:
            fh.write(roaring.serialize_dense(words[s]))
    counts = np.bitwise_count(words).sum(axis=(0, 2)).astype(np.int64)
    q32 = "".join(f"Count(Row(f={r}))" for r in range(rows))

    h = Holder(root).open()
    ex = Executor(h, device=dev)
    ex.planes.SYNC_BUILD_MAX = 0   # f's build writes its images
    assert ex.execute("bench", q32) == counts.tolist()
    ex.planes.wait_builds()
    assert ex.execute("bench", q32) == counts.tolist()
    # a write after the images: that fragment's stamp moves on
    cols = rng.choice(shards << 20, 64, replace=False).astype(np.uint64)
    r = rng.integers(0, rows, 64).astype(np.uint64)
    before = h.index("bench").field("f").standard_view()
    was = np.array([bool(before.fragment(int(c) >> 20).rows_contain(
        [int(rr)], np.array([int(c) & 0xFFFFF], np.uint32))[0, 0])
        for rr, c in zip(r, cols)])
    h.index("bench").field("f").import_bits(r, cols)
    np.add.at(counts, r[~was].astype(np.intp), 1)
    # fragments whose op-log grew: only a changed bit appends a record
    touched = len(set((cols[~was] >> np.uint64(20)).tolist()))
    ex.close()
    del h, ex                      # not closed: a killed process

    h2 = Holder(root, fsync=True).open()
    ex2 = Executor(h2, device=dev)
    ex2.planes.SYNC_BUILD_MAX = 0
    server = Server(API(h2, ex2), "127.0.0.1", 0).start()
    base = "http://%s:%d" % server.address
    seen = []
    real = os.fsync

    def counted(fd):
        seen.append(fd)
        return real(fd)

    try:
        assert ex2.execute("bench", q32) == counts.tolist()
        ex2.planes.wait_builds()
        st = ex2.planes.stats()
        assert st["warmHits"] == shards - touched
        assert st["warmMisses"] == touched
        assert ex2.execute("bench", q32) == counts.tolist()
        toplog.os.fsync = counted
        cols = rng.choice(shards << 20, 4096, replace=False)
        r = rng.integers(0, rows, 4096)
        body = json.dumps({"rowIDs": r.tolist(),
                           "columnIDs": cols.tolist()}).encode()
        req = urllib.request.Request(base + "/index/bench/field/f/import",
                                     data=body, method="POST")
        with urllib.request.urlopen(req, timeout=120) as resp:
            changed = json.loads(resp.read())["changed"]
        assert len(seen) == len(set((cols >> 20).tolist()))
        ans = ex2.execute("bench", q32)
        assert sum(ans) == int(counts.sum()) + changed
        seen.clear()
        mcols = rng.choice(shards << 20, 2048, replace=False)
        for rows_m in (rng.integers(0, 4, 2048), rng.integers(4, 8, 2048)):
            body = json.dumps({"rowIDs": rows_m.tolist(),
                               "columnIDs": mcols.tolist()}).encode()
            req = urllib.request.Request(
                base + "/index/bench/field/m/import", data=body,
                method="POST")
            with urllib.request.urlopen(req, timeout=120) as resp:
                json.loads(resp.read())
        # two imports, each one fsync per touched log
        assert len(seen) == 2 * len(set((mcols >> 20).tolist()))
        want = np.bincount(rows_m, minlength=8).tolist()
        assert ex2.execute("bench", "".join(
            f"Count(Row(m={k}))" for k in range(8))) == want
    finally:
        toplog.os.fsync = real
        server.close()
        ex2.close()
        h2.close()


# -- the single-node API and the CLI -----------------------------------------


def test_delete_field_frees_its_plane_and_recreated_serves(dev, tmp_path):
    """A field's resident plane on the card: deleting the field drops
    every plane of its index and frees their device bytes; the field
    recreated and written answers what the CPU answers."""
    import gc

    from pilosa_tpu_torch.api import API
    from pilosa_tpu_torch.exec import Executor
    holder = _budget_holder(str(tmp_path / "d"))
    api = API(holder, Executor(holder, device=dev))
    planes = api.executor.planes
    try:
        q = "".join(f"Count(Row(f={r}))" for r in range(8))
        want = api.query("i", q)
        planes.wait_builds()
        assert api.query("i", q) == want
        assert api.query("i", "TopN(f, n=3)")["results"]
        planes.wait_builds()
        resident = planes.tenant_bytes("i")
        assert resident > 0
        gc.collect()
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        api.delete_field("i", "f")
        gc.collect()
        torch.cuda.synchronize()
        assert planes.tenant_bytes("i") == 0
        assert mem0 - torch.cuda.memory_allocated() >= resident
        api.create_field("i", "f")
        api.import_bits("i", "f", row_ids=[1, 1, 2, 7],
                        col_ids=[3, (1 << 20) + 3, 5, 4 << 20])
        cpu = API(holder, Executor(holder, device="cpu",
                                   count_batch_window="off",
                                   tree_fusion=False))
        for _ in range(2):
            for pql in (q, "TopN(f, n=3)",
                        "Count(Intersect(Row(f=1), Row(g=0)))"):
                assert api.query("i", pql) == cpu.query("i", pql), pql
            planes.wait_builds()
    finally:
        api.executor.close()
        holder.close()


def test_cli_server_answers_on_the_card(dev, tmp_path):
    """``python -m pilosa_tpu_torch.cli server`` with no ``--device``
    serves on the card: its log names the CUDA device, a Count answers
    exactly, and SIGTERM closes it with exit code 0."""
    import os
    import signal
    import subprocess
    import sys

    from pilosa_tpu_torch.api.client import Client
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PILOSA_")}
    proc = subprocess.Popen(
        [sys.executable, "-m", "pilosa_tpu_torch.cli", "server", "--bind",
         "127.0.0.1:0", "--data-dir", str(tmp_path / "d")], cwd=repo,
        env=env, stderr=subprocess.PIPE, text=True)
    try:
        port = None
        for _ in range(50):
            line = proc.stderr.readline()
            if "listening on http://127.0.0.1:" in line:
                assert "device=cuda" in line, line
                port = int(line.split("127.0.0.1:")[1].split()[0])
                break
        assert port is not None
        c = Client("127.0.0.1", port)
        c.create_index("i")
        c.create_field("i", "f")
        cols = list(range(0, 3 << 20, 997))
        assert c.import_bits("i", "f", rowIDs=[1] * len(cols),
                             columnIDs=cols) == len(cols)
        assert c.query("i", "Count(Row(f=1))TopN(f, n=1)") == \
            [len(cols), [{"id": 1, "count": len(cols)}]]
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
        proc.stderr.close()


def _obs_api(root: str, dev):
    """A 6-shard ``i`` (``f`` 32 rows, ``h`` 4, ``g`` 2) behind the
    default executor with a metrics registry on the card."""
    from pilosa_tpu_torch.api import API
    from pilosa_tpu_torch.exec import Executor
    from pilosa_tpu_torch.obs import Stats

    class PeakStats(Stats):
        def __init__(self):
            super().__init__()
            self.peak = {}

        def gauge(self, name, value, **labels):
            super().gauge(name, value, **labels)
            self.peak[name] = max(value, self.peak.get(name, value))

    holder = _robust_holder(root, 32, 4)
    ex = Executor(holder, device=dev, stats=PeakStats())
    return API(holder, ex)


def test_bandwidth_gauge_within_the_card_peak(dev, tmp_path):
    """Under a concurrent burst every ``kernel_bandwidth_gbps`` value the
    windows set lies in (0, 3350] GB/s (the H100's HBM peak): a window's
    wall never misses its kernels."""
    import threading
    api = _obs_api(str(tmp_path / "d"), dev)
    ex = api.executor
    qs = ("".join(f"Count(Row(f={r}))" for r in range(32)),
          "Count(Row(f=1))Count(Row(f=9))",
          "Count(Intersect(Row(f=1), Row(g=0)))Count(Union(Row(f=2), "
          "Row(h=1)))")
    try:
        want = {q: api.query("i", q) for q in qs}
        ex.planes.wait_builds()
        errs = []

        def client(k):
            try:
                for i in range(12):
                    q = qs[(k + i) % len(qs)]
                    assert api.query("i", q) == want[q]
            except Exception as e:  # noqa: BLE001
                errs.append(repr(e))

        ts = [threading.Thread(target=client, args=(k,)) for k in range(16)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(120)
        assert not errs and ex.batcher.windows > 0
        peak = ex.stats.peak.get("kernel_bandwidth_gbps")
        assert peak is not None and 0 < peak <= 3350.0
    finally:
        ex.close()
        api.holder.close()


@pytest.mark.parametrize("pql", [
    "".join(f"Count(Row(f={r}))" for r in range(32)),
    "Count(Intersect(Row(f=1), Row(g=0)))",
    "TopN(f, Row(g=0), n=5)",
    "GroupBy(Rows(f, limit=4), Rows(g))"])
def test_kernel_ms_within_ledger_within_wall(dev, tmp_path, pql):
    """A sequential profiled request: its kernels' CUDA-event time <= the
    cost ledger's ``deviceSeconds`` on its root <= its wall."""
    import time
    api = _obs_api(str(tmp_path / "d"), dev)
    try:
        want = api.query("i", pql)["results"]
        api.executor.planes.wait_builds()
        for _ in range(3):
            cuda_kernels.EVENTS = []
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = api.query("i", pql, profile=True)
            wall = time.perf_counter() - t
            events, cuda_kernels.EVENTS = cuda_kernels.EVENTS, None
            torch.cuda.synchronize()
            assert out["results"] == want
            kms = sum(a.elapsed_time(b) for _, a, b in events)
            dev_s = out["profile"][0]["tags"]["deviceSeconds"]
            assert kms / 1e3 <= dev_s <= wall
    finally:
        cuda_kernels.EVENTS = None
        api.executor.close()
        api.holder.close()


def test_debug_profile_capture_lists_the_hand_kernels(dev, tmp_path):
    """``POST /debug/profile`` while requests run: the Chrome trace names
    every hand kernel launched meanwhile."""
    import json
    import re
    import threading
    import urllib.request

    from pilosa_tpu_torch.api import Server
    api = _obs_api(str(tmp_path / "d"), dev)
    server = Server(api, "127.0.0.1", 0).start()
    stop = threading.Event()
    qs = ("".join(f"Count(Row(f={r}))" for r in range(32)),
          "Count(Row(f=1))Count(Row(f=9))",
          "Count(Intersect(Row(f=1), Row(g=0)))")

    def load():
        while not stop.is_set():
            for q in qs:
                api.query("i", q)

    try:
        for q in qs:
            api.query("i", q)
        api.executor.planes.wait_builds()
        before = dict(cuda_kernels.LAUNCHES)
        th = threading.Thread(target=load)
        th.start()
        url = ("http://%s:%d/debug/profile?seconds=1&dir=" % server.address
               + str(tmp_path / "prof"))
        req = urllib.request.Request(url, data=b"", method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            cap = json.loads(r.read())
        stop.set()
        th.join(60)
        launched = {k for k, v in cuda_kernels.LAUNCHES.items()
                    if v > before[k]}
        trace = open(cap["traceFile"]).read()
        assert launched >= {"row_counts", "selected_row_counts", "count"}
        for k in launched:
            assert re.search(rf"(?<![A-Za-z_]){k}_kernel", trace), k
    finally:
        stop.set()
        server.close()
        api.executor.close()
        api.holder.close()


def _cluster_answers(tmp_path, device: str, reads) -> tuple[list, dict]:
    """A 3-node cluster (replicas = 2) over 8 shards of f (8 rows) and g,
    loaded by /import-roaring through node 0, its answers to ``reads``
    asked of every node, and the launches those reads made."""
    from pilosa_tpu_torch.store import roaring
    from pilosa_tpu_torch.testing import run_cluster
    rng = np.random.default_rng(22)
    f = (rng.integers(0, 1 << 32, (8, 8, 32768), dtype=np.uint32)
         & rng.integers(0, 1 << 32, (8, 8, 32768), dtype=np.uint32))
    g = rng.integers(0, 1 << 32, (8, 2, 32768), dtype=np.uint32)
    with run_cluster(3, str(tmp_path / device), replicas=2,
                     device=device) as c:
        cl = c.client(0)
        cl.create_index("i", {"trackExistence": False})
        cl.create_field("i", "f")
        cl.create_field("i", "g")
        for name, arr in (("f", f), ("g", g)):
            for s in range(8):
                cl.import_roaring("i", name, s, roaring.serialize_dense(arr[s]))
        cuda_kernels.reset_launches()
        out = [c.client(n).query("i", q) for n in range(3) for q in reads]
        return out, dict(cuda_kernels.LAUNCHES)


def test_cluster_on_the_card_answers_as_on_the_cpu(dev, tmp_path):
    reads = ["Count(Row(f=0)) Count(Row(f=1)) Count(Row(f=7))",
             "Count(Intersect(Row(f=1), Row(g=0)))",
             "TopN(f, Row(g=1), n=3)", "TopN(f)",
             "GroupBy(Rows(g), Rows(f, limit=3))",
             "Row(f=2)"]
    card, launches = _cluster_answers(tmp_path, "", reads)
    cpu, _ = _cluster_answers(tmp_path, "cpu", reads)
    assert card == cpu
    assert launches["row_counts"] > 0 and launches["count"] > 0


def test_card_backup_restores_into_a_cpu_node(dev, tmp_path):
    """A backup of a 3-node cluster serving on the card, restored into an
    un-clustered node on the CPU, answers as the card did."""
    from contextlib import closing

    from pilosa_tpu_torch.api import API, Server
    from pilosa_tpu_torch.api.client import Client
    from pilosa_tpu_torch.backup import BackupDriver, RestoreDriver
    from pilosa_tpu_torch.exec import Executor
    from pilosa_tpu_torch.store import Holder, roaring
    from pilosa_tpu_torch.testing import run_cluster
    reads = ["Count(Row(f=0)) Count(Row(f=1)) Count(Row(f=7))",
             "Count(Intersect(Row(f=1), Row(g=0)))",
             "TopN(f, Row(g=1), n=3)", "Row(f=2)", "Sum(field=n)"]
    rng = np.random.default_rng(23)
    f = (rng.integers(0, 1 << 32, (6, 8, 32768), dtype=np.uint32)
         & rng.integers(0, 1 << 32, (6, 8, 32768), dtype=np.uint32))
    g = rng.integers(0, 1 << 32, (6, 2, 32768), dtype=np.uint32)
    arch = str(tmp_path / "arch")
    with run_cluster(3, str(tmp_path / "card"), replicas=2) as c:
        cl = c.client(0)
        cl.create_index("i", {"trackExistence": False})
        cl.create_field("i", "f")
        cl.create_field("i", "g")
        cl.create_field("i", "n", {"type": "int", "min": 0, "max": 1000})
        for name, arr in (("f", f), ("g", g)):
            for s in range(6):
                cl.import_roaring("i", name, s,
                                  roaring.serialize_dense(arr[s]))
        cols = rng.choice(6 << 20, 500, replace=False)
        cl.import_values("i", "n", columnIDs=[int(x) for x in cols],
                         values=[int(v) for v in
                                 rng.integers(0, 1001, len(cols))])
        card = [cl.query("i", q) for q in reads]
        res = BackupDriver("127.0.0.1", c.servers[0].http.address[1],
                           arch, workers=4).run()
        assert res["fragments"] == 6 * 3
    holder = Holder(str(tmp_path / "cpu")).open()
    api = API(holder, Executor(holder, device="cpu"))
    server = Server(api, "127.0.0.1", 0).start()
    try:
        RestoreDriver("127.0.0.1", server.address[1], arch).run()
        with closing(Client("127.0.0.1", server.address[1])) as cc:
            assert [cc.query("i", q) for q in reads] == card
    finally:
        server.close()
        api.executor.close()
        holder.close()


def test_meshed_executor_on_the_card_equals_cpu_twin(dev, tmp_path):
    """A small meshed executor over ``virtual_placement(4, "cuda:0")``
    answers as its CPU twin over ``virtual_placement(4, "cpu")``: Counts,
    compound Counts, BSI ranges, TopN (plain, filtered, tanimoto),
    Sum/Min/Max, GroupBy and a Row read, then again after a set and a
    value import absorbed with no rebuild, and under an 8-thread burst.
    Each block launches on its own stream, all four kernels launch (the
    ``intersect_count`` one through ``parallel.spmd``), and the programs
    equal the CPU twin's."""
    import threading

    from pilosa_tpu_torch.api import API
    from pilosa_tpu_torch.exec import Executor
    from pilosa_tpu_torch.parallel import spmd
    from pilosa_tpu_torch.store import FieldOptions, Holder
    from pilosa_tpu_torch.virtmesh import virtual_placement
    rng = np.random.default_rng(16)
    holder = Holder(str(tmp_path)).open()
    idx = holder.create_index("i")
    for name, rows in (("f", 16), ("g", 2)):
        idx.create_field(name)
        cols = rng.choice(7 << 20, 60000, replace=False).astype(np.uint64)
        idx.field(name).import_bits(
            rng.integers(0, rows, len(cols)).astype(np.uint64), cols)
    idx.create_field("amount", FieldOptions(type="int", min=-100000,
                                            max=100000))
    cols = rng.choice(7 << 20, 50000, replace=False).astype(np.uint64)
    idx.field("amount").import_values(
        cols, rng.integers(-100000, 100001, len(cols)).tolist())
    mix = ["Count(Row(f=1))", "Count(Row(f=1))Count(Row(f=7))",
           "Count(Intersect(Row(f=1), Union(Row(f=2), Row(g=0))))",
           "Count(Not(Row(g=1)))", "Count(Row(-500 < amount < 90000))",
           "TopN(f)", "TopN(f, Row(g=0), n=5)",
           "TopN(f, Row(g=0), n=5, tanimoto=10)",
           "Sum(Row(g=1), field=amount)", "Min(field=amount)",
           "Max(Row(f=99), field=amount)",
           "GroupBy(Rows(g), Rows(f), aggregate=Sum(field=amount))"]
    card = API(holder, Executor(holder,
                                placement=virtual_placement(4, dev)))
    cpu = API(holder, Executor(holder,
                               placement=virtual_placement(4, "cpu")))
    try:
        cuda_kernels.reset_launches()
        for q in mix + ["Row(f=3)"]:
            assert card.query("i", q) == cpu.query("i", q), q
        builds = card.executor.planes.builds
        card.import_bits("i", "f", row_ids=[3] * 200,
                         col_ids=rng.choice(7 << 20, 200,
                                            replace=False).tolist())
        card.import_values("i", "amount",
                           col_ids=cols[:300].tolist(),
                           values=rng.integers(-100000, 100001,
                                               300).tolist())
        for q in mix:
            assert card.query("i", q) == cpu.query("i", q), q
        assert card.executor.planes.builds == builds
        want = {q: cpu.query("i", q) for q in mix[:6]}
        errs = []

        def worker(k):
            for i in range(3 * len(want)):
                q = list(want)[(k + i) % len(want)]
                if card.query("i", q) != want[q]:
                    errs.append(q)

        ts = [threading.Thread(target=worker, args=(k,)) for k in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(300)
        assert not errs
        ps = card.executor.planes.field_plane(
            "i", idx.field("f"), "standard",
            card.executor._shards_for(idx, None))
        streams = ps.plane.map(lambda b: torch.cuda.current_stream(),
                               ps.plane)
        assert len({s.cuda_stream for s in streams}) == 4
        a, b = ps.plane[:, 1].contiguous(), ps.plane[:, 2].contiguous()
        place_cpu = virtual_placement(4, "cpu")
        a_cpu, b_cpu = (place_cpu.place(x.full().cpu()) for x in (a, b))
        assert int(spmd.intersect_count(a, b)) == \
            int(spmd.intersect_count(a_cpu, b_cpu))
        assert int(spmd.make_intersect_count_psum(ps.plane.placement)(
            a, b)) == int(spmd.make_intersect_count_psum(place_cpu)(
                a_cpu, b_cpu))
        assert all(v > 0 for v in cuda_kernels.LAUNCHES.values()), \
            cuda_kernels.LAUNCHES
    finally:
        card.executor.close()
        cpu.executor.close()
        holder.close()


@pytest.mark.parametrize("layout", ["4", "2x2"])
def test_meshed_calls_on_the_card_equal_cpu_twin(dev, tmp_path, layout):
    """The calls the first meshed executor refused or answered wrong, on
    the card over ``virtual_placement(4, "cuda:0")`` and a 2x2
    ``MeshPlacement2D`` of the card, against the CPU twin: time ranges
    over a blocked time plane after a timestamped write absorbed into its
    overlay, ``Limit`` windows across blocks, Min/Max and GroupBy Max,
    ``Shift`` across word blocks and ``Extract``.  ``count`` and
    ``row_counts`` launch."""
    from datetime import datetime, timedelta

    from pilosa_tpu_torch.api import API
    from pilosa_tpu_torch.exec import Executor
    from pilosa_tpu_torch.parallel import MeshPlacement2D
    from pilosa_tpu_torch.store import FieldOptions, Holder
    from pilosa_tpu_torch.virtmesh import virtual_placement
    rng = np.random.default_rng(17)
    holder = Holder(str(tmp_path)).open()
    idx = holder.create_index("i")
    idx.create_field("f")
    idx.create_field("t", FieldOptions(type="time", time_quantum="YMD"))
    cols = rng.choice(6 << 20, 40000, replace=False).astype(np.uint64)
    rows = rng.integers(0, 4, len(cols)).astype(np.uint64)
    idx.field("f").import_bits(rows, cols)
    t0 = datetime(2021, 2, 1)
    idx.field("t").import_bits(rows, cols, [
        t0 + timedelta(hours=int(h))
        for h in rng.integers(0, 24 * 20, len(cols))])
    idx.create_field("amount", FieldOptions(type="int", min=-100000,
                                            max=100000))
    idx.field("amount").import_values(
        cols[:20000], rng.integers(-100000, 100001, 20000).tolist())

    def placement(device):
        if layout == "2x2":
            return MeshPlacement2D([device] * 4, shard_size=2, words_size=2)
        return virtual_placement(4, device)

    window = ("Count(Row(t=1, from=2021-02-03T00:00, to=2021-02-12T00:00))"
              "Row(t=2, from=2021-02-05T00:00)")
    mix = [window,
           "Count(Limit(Row(f=1), limit=3000, offset=4000))",
           "Limit(Row(f=2), limit=50, offset=5000)",
           "Count(Intersect(Row(f=3), Limit(Row(f=1), offset=3000)))",
           "Min(field=amount)", "Max(Row(f=1), field=amount)",
           "Min(Row(f=99), field=amount)",
           "GroupBy(Rows(f), aggregate=Max(field=amount))",
           "Count(Shift(Row(f=1), n=524283))",
           "Count(Shift(Row(f=2), n=40000))",
           "Extract(Limit(Row(f=1), limit=40, offset=6000), Rows(f), "
           "Rows(amount))"]
    card = API(holder, Executor(holder, placement=placement(dev)))
    cpu = API(holder, Executor(holder, placement=placement("cpu")))
    try:
        cuda_kernels.reset_launches()
        for q in mix:
            assert card.query("i", q) == cpu.query("i", q), q
        builds = card.executor.planes.builds
        # a timestamped write into an existing bucket of an existing row
        hit = int(cols[rows == 1][0])
        card.query("i", f"Set({hit + 1}, t=1, 2021-02-04T05:00)")
        for q in mix:
            assert card.query("i", q) == cpu.query("i", q), q
        assert card.executor.planes.builds == builds
        assert card.executor.planes.delta_absorbs > 0
        assert card.executor.time_status()["rangesServed"]["span"] == 0
        for k in ("count", "row_counts"):
            assert cuda_kernels.LAUNCHES[k] > 0, cuda_kernels.LAUNCHES
    finally:
        card.executor.close()
        cpu.executor.close()
        holder.close()


@pytest.fixture
def cards():
    """Every visible card; the test skips below two."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more NVIDIA cards (CUDA)")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def test_mesh_across_cards(cards, tmp_path):
    """``Executor(placement=MeshPlacement())`` over every visible card
    against its CPU twin over as many CPU blocks: Count, compound and BSI
    range Counts, TopN (plain, filtered), Sum, Min/Max, GroupBy,
    ``Limit`` windows across blocks, ``Shift``, time ranges and
    ``Extract``, then again after a set, a value and a timestamped write
    absorbed with no rebuild, and under a 4-thread burst; and the same
    over a 2x2 ``MeshPlacement2D`` of four cards when there are four.
    Every card holds its block of each plane (``/status``'s ``mesh``
    block names each) and launches the kernels (counted per card)."""
    import threading
    from datetime import datetime, timedelta

    from pilosa_tpu_torch.api import API
    from pilosa_tpu_torch.exec import Executor
    from pilosa_tpu_torch.parallel import MeshPlacement, MeshPlacement2D
    from pilosa_tpu_torch.store import FieldOptions, Holder
    rng = np.random.default_rng(18)
    holder = Holder(str(tmp_path)).open()
    idx = holder.create_index("i")
    for name, rows in (("f", 16), ("g", 2)):
        idx.create_field(name)
        cols = rng.choice(7 << 20, 60000, replace=False).astype(np.uint64)
        idx.field(name).import_bits(
            rng.integers(0, rows, len(cols)).astype(np.uint64), cols)
    idx.create_field("t", FieldOptions(type="time", time_quantum="YMD"))
    cols = rng.choice(7 << 20, 40000, replace=False).astype(np.uint64)
    rows = rng.integers(0, 4, len(cols)).astype(np.uint64)
    t0 = datetime(2021, 2, 1)
    idx.field("t").import_bits(rows, cols, [
        t0 + timedelta(hours=int(h))
        for h in rng.integers(0, 24 * 20, len(cols))])
    idx.create_field("amount", FieldOptions(type="int", min=-100000,
                                            max=100000))
    vcols = rng.choice(7 << 20, 50000, replace=False).astype(np.uint64)
    idx.field("amount").import_values(
        vcols, rng.integers(-100000, 100001, len(vcols)).tolist())
    mix = ["Count(Row(f=1))Count(Row(f=7))",
           "Count(Intersect(Row(f=1), Union(Row(f=2), Row(g=0))))",
           "Count(Not(Row(g=1)))", "Count(Row(-500 < amount < 90000))",
           "TopN(f)", "TopN(f, Row(g=0), n=5)",
           "Sum(Row(g=1), field=amount)", "Min(field=amount)",
           "Max(Row(f=1), field=amount)", "Min(Row(f=99), field=amount)",
           "GroupBy(Rows(g), Rows(f), aggregate=Sum(field=amount))",
           "GroupBy(Rows(g), aggregate=Max(field=amount))",
           "Count(Limit(Row(f=1), limit=3000, offset=4000))",
           "Count(Intersect(Row(f=3), Limit(Row(f=1), offset=3000)))",
           "Count(Shift(Row(f=1), n=524283))",
           "Count(Shift(Row(f=2), n=40000))",
           "Count(Row(t=1, from=2021-02-03T00:00, to=2021-02-12T00:00))"
           "Row(t=2, from=2021-02-05T00:00)",
           "Extract(Limit(Row(f=1), limit=40, offset=6000), Rows(f), "
           "Rows(amount))", "Row(f=3)"]
    layouts = [("1d", MeshPlacement(), MeshPlacement(["cpu"] * len(cards)),
                len(cards))]
    if len(cards) >= 4:
        layouts.append(("2x2", MeshPlacement2D(cards[:4], 2, 2),
                        MeshPlacement2D(["cpu"] * 4, 2, 2), 4))
    hit = int(cols[rows == 1][0])
    writes = [f"Set({hit + 1}, t=1, 2021-02-04T05:00)", "Set(11, f=3)",
              "Set(12, amount=777)"]
    for name, on_cards, on_cpu, n in layouts:
        card = API(holder, Executor(holder, placement=on_cards))
        cpu = API(holder, Executor(holder, placement=on_cpu))
        try:
            cuda_kernels.reset_launches()
            for q in mix:
                assert card.query("i", q) == cpu.query("i", q), (name, q)
            builds = card.executor.planes.builds
            for w in writes:  # the second layout finds them written
                card.query("i", w)
            for q in mix:
                assert card.query("i", q) == cpu.query("i", q), (name, q)
            assert card.executor.planes.builds == builds, name
            want = {q: cpu.query("i", q) for q in mix[:6]}
            errs: list = []

            def worker(k):
                for i in range(2 * len(want)):
                    q = list(want)[(k + i) % len(want)]
                    if card.query("i", q) != want[q]:
                        errs.append(q)

            ts = [threading.Thread(target=worker, args=(k,))
                  for k in range(4)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(300)
            assert not errs, (name, errs)
            mesh = card.executor.mesh_status()
            want_cards = sorted(f"cuda:{i}" for i in range(n))
            assert sorted(mesh["perDeviceBytes"]) == want_cards, mesh
            by_dev = cuda_kernels.launches_by_device()
            assert sorted(by_dev) == list(range(n)), by_dev
            for dev_i, counts in by_dev.items():
                assert counts["count"] > 0 and counts["row_counts"] > 0, \
                    (name, dev_i, counts)
        finally:
            card.executor.close()
            cpu.executor.close()
    holder.close()


def test_spmd_across_processes(cards):
    """Two NCCL processes over disjoint cards (the two halves of the first
    ``min(cards, 4)``), four blocks each on their own cards: every
    ``parallel.spmd`` program answers as the numpy oracle and as the same
    two processes over gloo on the CPU."""
    from pilosa_tpu_torch import testing
    half = min(len(cards), 4) // 2
    want = testing.spmd_expect(testing.spmd_inputs(19, 4096))
    on_cards = testing.run_spmd_processes(
        2, "cuda", seed=19, width=4096,
        cards=[list(range(half)), list(range(half, 2 * half))])
    on_cpu = testing.run_spmd_processes(2, "cpu", seed=19, width=4096)
    assert on_cards == on_cpu == [want, want]
