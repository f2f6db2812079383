"""A whole run on the CPU at one shard, past the look for a card: the
result's shape, the module check, and ``correct`` coming out false with
the timed path broken underneath or the control in the program's place."""

import json
import os
import subprocess
import sys
import types

import pytest

from benchmark import control, harness, traffic
import benchmark.run as brun

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELL = {"name": "taxi.dash-c32", "config": "nyc-taxi",
        "traffic": "taxi.dash-c32", "chips": 1}


def run_cell(small, wrap=None, traced=False):
    bench = harness.load_benchmark()
    cell = CELL
    lines = []
    return brun.run(bench, cell, 2**31 + 21, 1.0, traced, device="cpu",
                    log=lines.append, cfg=small("nyc-taxi"), wrap=wrap)


def test_a_sound_run_is_correct(small):
    result, counts, peak, summary = run_cell(small)
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] > 0
    # the cell's end-to-end metrics; a latency only where a request
    # returned
    listed = {m["name"] for m in harness.load_benchmark()["end_to_end"]
              if brun.applies(m, CELL["name"])}
    assert {"requests_per_s", "setup_s"} <= set(result["metrics"]) <= listed
    assert result["metrics"]["setup_s"]["value"] > 0
    assert counts == {"wrong": 0, "errors": 0, "unanswered": 0}


def break_query(program, alter):
    real = program.query

    def broken(pql):
        return alter(real(pql))
    program.query = broken


def bump(answer):
    """One number of an answer off by one: a Sum's value, the first
    TopN pair's or group's count."""
    if isinstance(answer, dict):
        return dict(answer, value=answer["value"] + 1)
    if answer:
        return [dict(answer[0], count=answer[0]["count"] + 1)] + answer[1:]
    return [{"id": 0, "count": 1}]


def test_an_answer_altered_where_it_is_produced(small):
    def alter(results):
        return [bump(results[0])] + results[1:]
    result, counts, _, _ = run_cell(
        small, wrap=lambda p: break_query(p, alter))
    assert result["correct"] is False
    assert counts["wrong"] == result["attempted"]


def test_half_of_a_request_left_out(small):
    def alter(results):
        return results[:len(results) // 2]
    result, counts, _, _ = run_cell(
        small, wrap=lambda p: break_query(p, alter))
    assert result["correct"] is False and counts["wrong"] > 0


def test_a_request_that_raises(small):
    def alter(results):
        raise RuntimeError("launch failed")
    result, counts, _, _ = run_cell(
        small, wrap=lambda p: break_query(p, alter))
    assert result["correct"] is False
    assert counts["errors"] == result["attempted"] == result["failed"]


@pytest.mark.parametrize("mix_name,config", [
    ("taxi.dash-c32", "nyc-taxi"), ("ssb.flights-c1", "ssb-sf10")])
def test_the_control_is_not_correct(small, mix_name, config):
    cfg = small(config)
    mix = traffic.load(mix_name)
    counts = control.readings(cfg, mix, 2**31 + 5, 2)
    assert not harness.is_correct(counts) and counts["wrong"] > 0
    exact = control.readings(cfg, mix, 2**31 + 5, 2,
                             answer=control.cube.answer)
    assert harness.is_correct(exact)


def loaded_after(code: str) -> list:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted(sys.modules)))"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_no_jax_and_no_jax_package_after_set_up(small):
    mods = loaded_after(
        "from benchmark import harness, run, trace, control\n"
        "from benchmark.tests.conftest import small_config\n"
        "cfg = small_config('nyc-taxi')\n"
        "p = harness.Program(cfg, device='cpu')\n"
        "p.load(cfg, harness.generate(cfg, 1), 2)\n"
        "p.query('Count(Row(cab_type=0))'); p.close()\n"
        "assert harness.forbidden_modules() == [], harness.forbidden_modules()")
    tops = {m.split(".")[0] for m in mods}
    assert "pilosa_tpu_torch" in tops
    assert not tops & set(harness.FORBIDDEN)


def test_the_reference_imports_nothing_of_the_program():
    mods = loaded_after("import benchmark.reference.cube, "
                        "benchmark.traffic, benchmark.roofline")
    assert not {m.split(".")[0] for m in mods} & {
        "pilosa_tpu_torch", "pilosa_tpu", "jax", "torch"}


def test_the_module_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "pilosa_tpu_torch_x",
                        types.ModuleType("pilosa_tpu_torch_x"))
    base = [m for m in harness.forbidden_modules()]
    monkeypatch.setitem(sys.modules, "jaxlib.fake",
                        types.ModuleType("jaxlib.fake"))
    assert "jaxlib.fake" in harness.forbidden_modules()
    assert "pilosa_tpu_torch_x" not in harness.forbidden_modules()
    assert "pilosa_tpu_torch_x" not in base


def test_no_card_no_result(capsys):
    torch = pytest.importorskip("torch")
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert brun.main(["--workload", "taxi.dash-c32", "--seed", "1",
                      "--seconds", "1"]) != 0
    out = capsys.readouterr()
    assert out.out == "" and "needs 1 CUDA device" in out.err
