"""The harness finds a cell's configuration, traffic mix, cell file and
metrics by name (a dotted metric name shares the reader of its first
part unless it has its own), so that a later change adds them as files; and the one
traffic generator gives every seed the same sizes, in another order
unless the mix fixes it."""
import json

import numpy as np
import pytest

from harness.spec import BENCH_DIR, load_cell
from harness.traffic import make_plan


def _write(path, obj):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(obj if isinstance(obj, str) else json.dumps(obj))


@pytest.fixture
def added(tmp_path):
    """A benchmark directory with one cell of a new configuration, mix and
    metric, and a per-layer metric of another cell."""
    bench = tmp_path / "bench"
    cfg = json.loads((BENCH_DIR / "configs" / "dsv2-l6.json").read_text())
    _write(bench / "configs" / "new-model.json", cfg)
    mix = json.loads((BENCH_DIR / "traffic" / "chat.json").read_text())
    mix["prompt"]["median"] = 99
    _write(bench / "traffic" / "new_mix.json", mix)
    _write(bench / "cells" / "new-model.new_mix.json",
           {"rate_per_s": 1.5, "limits": {"mean_logit_gap": 0.5}})
    _write(bench / "metrics" / "new_metric.py",
           "LABELS = {'pb.x': ('os.path', 'join')}\n"
           "def read(run):\n    return 41.5\n")
    _write(bench / "metrics" / "setup_s.py", "def read(run):\n    return 1.0\n")
    _write(bench / "metrics" / "other_cells.py", "def read(run):\n    return 2\n")
    _write(bench / "metrics" / "untied.py", "def read(run):\n    return 3\n")
    _write(bench / "metrics" / "split.py", "def read(run):\n    return 5\n")
    _write(bench / "metrics" / "split.own.py", "def read(run):\n    return 6\n")
    spec = {
        "workloads": [{"name": "new-model.new_mix", "config": "new-model",
                       "traffic": "new_mix", "chips": 1, "why": "x"}],
        "end_to_end": [{"name": "setup_s", "unit": "s", "better": "lower",
                        "bound": 0.25, "source": "host_clock"}],
        "per_layer": [
            {"name": "new_metric", "unit": "%", "better": "higher",
             "source": "device_trace", "layer": "l", "moves": "setup_s",
             "workloads": ["new-model.new_mix"]},
            {"name": "other_cells", "unit": "%", "better": "higher",
             "source": "device_trace", "layer": "l", "moves": "setup_s",
             "workloads": ["another.cell"]},
            {"name": "untied", "unit": "%", "better": "higher",
             "source": "device_trace", "layer": "l", "moves": "setup_s"},
            {"name": "split.shared", "unit": "%", "better": "higher",
             "source": "device_trace", "layer": "l", "moves": "setup_s",
             "workloads": ["new-model.new_mix"]},
            {"name": "split.own", "unit": "%", "better": "higher",
             "source": "device_trace", "layer": "l", "moves": "setup_s",
             "workloads": ["new-model.new_mix"]}]}
    _write(tmp_path / "BENCHMARK.json", spec)
    return bench, tmp_path / "BENCHMARK.json"


def test_cell_files_found_by_name(added):
    bench, spec = added
    cell = load_cell("new-model.new_mix", spec, bench)
    assert cell.config["hidden_size"] == 5120
    assert cell.traffic["prompt"]["median"] == 99
    assert cell.params["rate_per_s"] == 1.5
    assert [m.name for m in cell.end_to_end] == ["setup_s"]
    # a metric listing other cells is not read here; one without a list
    # is read wherever the metric it moves is
    assert [m.name for m in cell.per_layer] == ["new_metric", "untied",
                                                "split.shared", "split.own"]
    assert [m.read(None) for m in cell.per_layer] == [41.5, 3, 5, 6]
    assert cell.labels == {"pb.x": ("os.path", "join")}
    with pytest.raises(KeyError):
        load_cell("missing.cell", spec, bench)


def test_the_repos_cells_load():
    spec = json.loads((BENCH_DIR.parent / "BENCHMARK.json").read_text())
    for w in spec["workloads"]:
        cell = load_cell(w["name"])
        names = {m.name for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            e = next(x for x in spec["per_layer"] if x["name"] == m.name)
            assert e["moves"] in names


@pytest.mark.parametrize("mix,rate", [("chat", 2.4), ("long_prompt", None)])
def test_every_seed_gets_the_same_sizes(mix, rate):
    m = json.loads((BENCH_DIR / "traffic" / f"{mix}.json").read_text())
    a = make_plan(m, 1, 1000, 45, rate)
    b = make_plan(m, 2**31 + 12345, 1000, 45, rate)
    assert len(a) == len(b)
    # the seed orders the sizes unless the mix fixes the order
    assert np.array_equal(a.prompt_len, b.prompt_len) == ("order_seed" in m)
    k = m["block"]
    for x, y in ((a.prompt_len, b.prompt_len), (a.output_len, b.output_len)):
        assert np.array_equal(np.sort(x), np.sort(y))
        # every block of k requests holds one value of each of k strata
        strata = np.sort(x).reshape(k, -1)
        for blk in (x[:k], y[-k:]):
            got = np.sort(blk)
            assert (strata[:, 0] <= got).all() and (got <= strata[:, -1]).all()
    if a.due is not None:
        # the same gaps but the first, which opens the window at 0
        ga, gb = np.diff(a.due), np.diff(b.due)
        assert abs(ga.sum() - gb.sum()) <= max(ga.max(), gb.max())
        assert abs(a.due[-1] / len(a) * rate - 1) < 0.1
    p = m["prompt"]
    assert p["min"] <= a.prompt_len.min() and a.prompt_len.max() <= p["max"]
    assert np.array_equal(a.tokens(3), make_plan(m, 1, 1000, 45, rate).tokens(3))
    assert not np.array_equal(a.tokens(3)[:50], b.tokens(3)[:50])
