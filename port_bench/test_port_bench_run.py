"""A whole run of a cell, less the look for a card, at smoke sizes on the
CPU: ``correct`` holds for the port as it is, and comes out false with
the timed path broken underneath (a served token altered where the
replica produces it, in a decode round or in an admit), and for the
float8 control put in the program's place (``--control 1``), on both
cells' paths.  And the command exits 2,
printing no result, without a card or without the port beside it."""
import functools
import json
import shutil
import subprocess
import sys
from unittest import mock

import pytest
import torch

import run as bench_run
from harness.spec import BENCH_DIR, load_cell
from test_port_bench_reference import SMOKE

ROOT = BENCH_DIR.parent


# the long_prompt mix on qwen3-moe-l8 (GQA, K5 and K3 at g 16): its files
# are in the tree, and BENCHMARK.json lists it once it is proven on the card
LONG = "qwen3-moe-l8.long_prompt"
CELLS = ["dsv2-l6.chat", LONG]


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the command would run the cell")


@pytest.fixture(scope="module")
def bench_file(tmp_path_factory):
    """``BENCHMARK.json`` with every cell of ``CELLS`` listed."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = {w["name"] for w in spec["workloads"]}
    spec["workloads"] += [{"name": n, "config": n.split(".")[0],
                           "traffic": n.split(".")[1], "chips": 1, "why": "-"}
                          for n in CELLS if n not in names]
    path = tmp_path_factory.mktemp("bench") / "BENCHMARK.json"
    path.write_text(json.dumps(spec))
    return path


def smoke_cell(name, bench_file, **config):
    cell = load_cell(name, bench_file)
    cell.config.update(SMOKE[cell.config_name], **config)
    t = cell.traffic
    t["prompt"].update(median=24, min=8, max=48)
    if t["output"]["dist"] == "lognormal":
        t["output"].update(median=8, min=2, max=16)
    t["server"].update(slots=4, max_len=96)
    t["warmup"] = {"prompts": [8, 24, 48], "sessions": 6, "output": 3}
    t["check"] = {"min_served_tokens": 40, "max_requests": 6}
    if t["loop"] == "open":
        cell.params["rate_per_s"] = 6.0
    return cell


class Ticks:
    """A clock that moves ``step`` seconds a reading: the window then
    holds the same loop iterations however busy the host is."""

    def __init__(self, step):
        self.t, self.step = 0.0, step

    def __call__(self):
        self.t += self.step
        return self.t


def _run(cell, seed=7, control=False, trace=False):
    from harness import serve
    with mock.patch.object(serve, "serve",
                           functools.partial(serve.serve, clock=Ticks(0.01))):
        out = bench_run.run_cell(cell, seed, 2.5, trace, torch.device("cpu"),
                                 control=control)
    out.pop("_run")
    json.dumps(out)
    return out


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name, bench_file):
    out = _run(smoke_cell(name, bench_file))
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["served"]["checked_tokens"] > 0
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {m.name for m in
                                   load_cell(name, bench_file).end_to_end}


@pytest.mark.parametrize("name", CELLS)
def test_a_traced_run_reads_its_per_layer_metrics(name, bench_file):
    """``--trace 1``: the profiler runs over the window's last seconds, the
    line holds per-layer metrics only, with those read from host spans and
    from the window's work; the device's own find no device events on the
    CPU and are left out, never read as 0."""
    cell = smoke_cell(name, bench_file)
    cell.traffic["trace"]["seconds"] = 0.5
    out = _run(cell, trace=True)
    assert out["correct"], out["checks"]
    got = set(out["metrics"])
    assert got <= {m.name for m in cell.per_layer}
    assert {"queue_ms_p50", "admit_ms_per_ktok"} <= got
    assert not got & {"expert_share.chat", "expert_share.long",
                      "device_idle.chat", "device_idle.long",
                      "k5_roofline.long"}
    assert out["device"]["window_s"] > 0 and out["device"]["busy_s"] == 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("where", ["decode_round", "admit"])
def test_a_token_altered_where_produced_is_not_correct(where, monkeypatch,
                                                      bench_file):
    from repro_torch.serve.server import Replica
    cell = smoke_cell("dsv2-l6.chat", bench_file)
    vocab = cell.config["vocab_size"]
    original = getattr(Replica, where)

    def altered(self, *args, **kwargs):
        out = original(self, *args, **kwargs)
        if where == "admit":
            return (out + 1) % vocab
        return {sid: (tok + 1) % vocab for sid, tok in out.items()}
    monkeypatch.setattr(Replica, where, altered)
    out = _run(cell)
    assert not out["correct"]
    assert out["checks"]["mean_logit_gap"]["value"] > \
        out["checks"]["mean_logit_gap"]["limit"]


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_float8_control_is_not_correct(name, seed, bench_file):
    """The float8 reference put in the program's place (``--control 1``):
    its first choices at the served positions go through the run's own
    comparison, and the run reports not correct, where the program's own
    served tokens of the same run pass.  Widths of 256, six layers (the
    depth at which rounding piles up as in the cells) and a vocabulary of
    16,384, so that the best logits lie close together as in the
    published ones; some hundred tokens checked."""
    cell = smoke_cell(name, bench_file, hidden_size=256,
                      moe_intermediate_size=256, vocab_size=16384,
                      num_hidden_layers=6)
    cell.traffic["check"] = {"min_served_tokens": 100, "max_requests": 40}
    out = _run(cell, seed=seed, control=True)
    c = out["checks"]["mean_logit_gap"]
    assert not out["correct"] and c["value"] > c["limit"]
    assert c["value"] == out["served"]["control_mean_gap"]
    assert out["served"]["mean_gap"] <= c["limit"]
    assert out["served"]["checked_tokens"] >= 80


def test_no_card_no_result(no_card):
    p = subprocess.run([sys.executable, str(BENCH_DIR / "run.py"),
                        "--workload", "dsv2-l6.chat", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert p.returncode == 2 and p.stdout == ""


def test_without_the_port_no_result(tmp_path, no_card):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH_DIR, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "port_bench/run.py", "--workload",
                        "dsv2-l6.chat", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       cwd=tmp_path, timeout=120,
                       env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert p.returncode != 0 and p.stdout == ""
