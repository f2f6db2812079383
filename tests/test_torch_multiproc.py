"""Serving across processes (``pilosa_tpu_torch.parallel.multiproc``) on
the CPU, against the reference's multi-process runtime
(``tests/test_multihost.py``):

- two processes joined over gloo, each placing its own rows of the
  reference test's seeded arrays over four local blocks (and a 2x2
  placement for the ``*2d`` programs), answer every program of
  ``parallel.spmd`` bit-equal to each other, to the reference's programs
  over its 8-device CPU mesh and to numpy;
- two port servers, each its own process in one group with
  ``cluster_enabled``, run the collective, converge, route ``Set``s
  through process 0 and read them back through both nodes;
- the three coordinator keys are served from the config layers, the
  detection defaults read torchrun's variables or refuse naming the key,
  a join whose peer never comes raises after its timeout, and ``mesh =
  true`` beside a coordinator is refused at boot;
- a world of one process answers as its local placement does, and the
  exchanges that cannot cross processes refuse.

Every child is a port-only ``python -c`` script.
"""

import json
import os
import time

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from pilosa_tpu.parallel import MeshPlacement as JMesh
from pilosa_tpu.parallel import MeshPlacement2D as JMesh2D
from pilosa_tpu.parallel import spmd as jspmd
from pilosa_tpu_torch import testing
from pilosa_tpu_torch.cli import config as tconfig
from pilosa_tpu_torch.engine import kernels
from pilosa_tpu_torch.exec.errors import MeshNotSupported
from pilosa_tpu_torch.parallel import (MeshPlacement, MeshPlacement2D,
                                       multiproc)
from pilosa_tpu_torch.parallel.mesh import shard_prefix
from pilosa_tpu_torch.server import PilosaTPUServer
from pilosa_tpu_torch.testing import free_ports, share_cpu_threads

share_cpu_threads()


def _reference(inputs: dict) -> dict:
    """The reference's programs over its 8-device CPU mesh (1-D) and a
    2x4 one, in :func:`testing.spmd_answers`' form."""
    jmesh = JMesh(jax.devices())
    jmesh2 = JMesh2D(jax.devices(), shard_size=2, words_size=4)
    p = {k: jmesh.place(v) for k, v in inputs.items()}

    def ints(x):
        return np.asarray(x).tolist()

    words = jspmd.make_ingest_step(jmesh.mesh)(p["a"], p["idx"], p["mask"])
    return {
        "intersect_count": int(jspmd.intersect_count(p["a"], p["b"])),
        "union_count": int(jspmd.union_count(p["a"], p["b"])),
        "intersect_psum": int(jspmd.make_intersect_count_psum(jmesh.mesh)(
            p["a"], p["b"])),
        "topn": [ints(x) for x in jspmd.topn(p["plane"], p["filt"], 5)],
        "topn_psum": [ints(x) for x in jspmd.make_topn_psum(
            jmesh.mesh, n=5)(p["plane"], p["filt"])],
        "bsi_bit_counts": [ints(x) for x in
                           jspmd.bsi_bit_counts(p["bsi"], p["filt"])],
        "bsi_sum_psum": [ints(x) for x in jspmd.make_bsi_sum_psum(
            jmesh.mesh)(p["bsi"], p["filt"])],
        "intersect_psum2d": int(jspmd.make_intersect_count_psum2d(
            jmesh2.mesh)(jmesh2.place(inputs["a"]),
                         jmesh2.place(inputs["b"]))),
        "topn_psum2d": [ints(x) for x in jspmd.make_topn_psum2d(
            jmesh2.mesh, n=5)(jmesh2.place(inputs["plane"]),
                              jmesh2.place(inputs["filt"]))],
        "ingest": np.asarray(words).view(np.int32).tolist(),
        "ingest_count": int(jspmd.intersect_count(words, words)),
    }


def test_two_process_spmd_equal():
    """The counterpart of ``test_two_process_jax_distributed``: every
    ``spmd`` program over two gloo processes of four blocks each."""
    inputs = testing.spmd_inputs(0, 256)
    want = testing.spmd_expect(inputs)
    assert _reference(inputs) == want
    answers = testing.run_spmd_processes(2, "cpu", seed=0, width=256)
    assert len(answers) == 2
    for got in answers:
        assert got == want


CLUSTER_CHILD = r"""
import json, sys
args = json.loads(sys.argv[1])
from pilosa_tpu_torch import testing
from pilosa_tpu_torch.cli import config
from pilosa_tpu_torch.parallel import MeshPlacement, multiproc, spmd
from pilosa_tpu_torch.server import PilosaTPUServer

testing.share_cpu_threads()
rank, ports = args["rank"], args["ports"]
cfg = config.load(env={}, overrides=dict(
    bind=f"127.0.0.1:{ports[rank]}", data_dir=args["data"],
    jax_coordinator=args["coord"], jax_num_processes=len(ports),
    jax_process_id=rank, mesh=False, cluster_enabled=True,
    seeds=[f"127.0.0.1:{ports[0]}"] if rank else [],
    heartbeat_interval=2.0, anti_entropy_interval=0.0, device="cpu"))
srv = PilosaTPUServer(cfg).open()
try:
    # the collective first, while every process stands at the same point
    place = multiproc.ProcessPlacement(MeshPlacement(["cpu"] * 4), srv.group)
    per = testing.SPMD_SHARDS // srv.group.size
    rows = {k: v[rank * per:(rank + 1) * per]
            for k, v in testing.spmd_inputs(1, 128).items()}
    psum = int(spmd.make_intersect_count_psum(place)(rows["a"], rows["b"]))
    got = testing.cluster_over_group(srv, len(ports), args["barrier"])
    print("CLUSTER " + json.dumps({"count": got, "psum": psum}), flush=True)
finally:
    srv.close()
"""


def test_cluster_layer_over_process_group(tmp_path):
    """The counterpart of ``test_cluster_layer_over_multiprocess_jax``:
    two servers, each its own process of one group, form an HTTP
    cluster; shard-routed writes through process 0 read back through
    both nodes, and both agree on the collective."""
    cport, *ports = free_ports(3)
    argv = []
    for rank in range(2):
        (tmp_path / f"c{rank}").mkdir()
        argv.append([json.dumps({
            "rank": rank, "ports": ports, "coord": f"127.0.0.1:{cport}",
            "data": str(tmp_path / f"c{rank}"), "barrier": str(tmp_path)})])
    outs = testing.run_processes(CLUSTER_CHILD, argv, timeout=240)
    psum = testing.spmd_expect(testing.spmd_inputs(1, 128))[
        "intersect_psum"]
    for rank, (out, err) in enumerate(outs):
        line = next(x for x in out.splitlines() if x.startswith("CLUSTER "))
        assert json.loads(line[8:]) == {"count": [4], "psum": psum}
        assert f"torch.distributed: process {rank} of 2 (gloo)" in err


def test_mesh_with_coordinator_refused(tmp_path):
    """``mesh = true`` (the default) beside a coordinator stops the boot
    naming both keys, before the data directory or a group exists: the
    reference boots it and then answers no query through one process."""
    cfg = tconfig.load(env={}, overrides={
        "data_dir": str(tmp_path / "d"), "device": "cpu",
        "jax_coordinator": "127.0.0.1:1", "jax_num_processes": 2,
        "jax_process_id": 0})
    assert cfg.mesh
    with pytest.raises(ValueError) as ei:
        PilosaTPUServer(cfg)
    assert "mesh = true" in str(ei.value)
    assert "jax_coordinator = '127.0.0.1:1'" in str(ei.value)
    assert not os.path.exists(tmp_path / "d")
    assert not dist.is_initialized()


@pytest.mark.parametrize("key", ["jax_coordinator", "jax_num_processes",
                                 "jax_process_id"])
def test_coordinator_keys_served(tmp_path, key):
    """Each coordinator key reaches the join from the ``PILOSA_*`` layer
    (the other two from a TOML file): the server boots a world of one
    over gloo, answers, and leaves the group when it closes."""
    values = {"jax_coordinator": f"127.0.0.1:{free_ports(1)[0]}",
              "jax_num_processes": 1, "jax_process_id": 0}
    toml = tmp_path / "node.toml"
    toml.write_text("mesh = false\n" + "".join(
        f"{k} = {json.dumps(v)}\n" for k, v in values.items() if k != key))
    cfg = tconfig.load(str(toml), env={
        "PILOSA_" + key.upper(): str(values[key])}, overrides={
        "bind": "127.0.0.1:0", "data_dir": str(tmp_path / "d"),
        "device": "cpu"})
    assert {k: getattr(cfg, k) for k in values} == values
    srv = PilosaTPUServer(cfg).open()
    try:
        assert dist.is_initialized() and dist.get_world_size() == 1
        g = srv.group
        assert (g.rank, g.size, g.backend) == (0, 1, "gloo")
        srv.api.create_index("i")
        srv.api.create_field("i", "f")
        srv.api.query("i", "Set(3, f=1)Set(1048579, f=1)")
        assert srv.api.query("i", "Count(Row(f=1))")["results"] == [2]
    finally:
        srv.close()
    assert srv.group is None and not dist.is_initialized()


def test_world_size_from_env(monkeypatch):
    """At the reference's detection defaults the process count and index
    come from torchrun's ``WORLD_SIZE`` and ``RANK``."""
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    group = multiproc.join(f"127.0.0.1:{free_ports(1)[0]}", device="cpu")
    try:
        assert (group.rank, group.size, group.backend) == (0, 1, "gloo")
        assert dist.get_backend() == "gloo"
        t = torch.arange(6, dtype=torch.int32).reshape(2, 3)
        assert torch.equal(group.sum(t), t)
        assert torch.equal(group.cat(t, 1), t)
    finally:
        group.leave()
    assert not dist.is_initialized()


@pytest.mark.parametrize("key", ["jax_num_processes", "jax_process_id"])
def test_world_size_from_env_missing(monkeypatch, key):
    """A detection default with no variable to read raises a
    ``ValueError`` naming the key, before any group forms."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.delenv("RANK", raising=False)
    kw = {"jax_num_processes": {"num_processes": 0, "process_id": 0},
          "jax_process_id": {"num_processes": 2, "process_id": -1}}[key]
    with pytest.raises(ValueError, match=f"config key {key} is not set"):
        multiproc.join("127.0.0.1:1", device="cpu", **kw)
    assert not dist.is_initialized()


def test_join_raises_without_its_peer():
    """A world of two whose second process never comes: the join raises
    after its timeout instead of hanging the boot."""
    t = time.monotonic()
    with pytest.raises(dist.DistError, match="1/2 clients joined"):
        multiproc.join(f"127.0.0.1:{free_ports(1)[0]}", 2, 0, device="cpu",
                       timeout=5)
    assert time.monotonic() - t < 20
    assert not dist.is_initialized()


def test_world_of_one_equals_the_local_placement():
    """Over a group of one process every program answers as over its
    local placement alone; a prefix and per-block entries, which could
    not cross processes, refuse."""
    inputs = testing.spmd_inputs(2, 64)
    group = multiproc.join(f"127.0.0.1:{free_ports(1)[0]}", 1, 0,
                           device="cpu")
    try:
        local = MeshPlacement(["cpu"] * 4)
        local2 = MeshPlacement2D(["cpu"] * 4, 2, 2)
        got = testing.spmd_answers(multiproc.ProcessPlacement(local, group),
                                   multiproc.ProcessPlacement(local2, group),
                                   inputs)
        assert got == testing.spmd_answers(local, local2, inputs) == \
            testing.spmd_expect(inputs)
        place = multiproc.ProcessPlacement(local, group)
        assert place.n_devices == 4
        assert place.pad_shards(tuple(range(6))) == (0, 1, 2, 3, 4, 5, -1, -1)
        counts = kernels.count(place.place(inputs["a"]))
        with pytest.raises(MeshNotSupported):
            shard_prefix(counts)
        with pytest.raises(MeshNotSupported):
            counts.concat(counts.blocks)
    finally:
        group.leave()
