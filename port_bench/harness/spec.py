"""What a run is: the cell of ``BENCHMARK.json``, its model configuration,
its traffic mix, its own parameters and the metrics it reports, each found
by name in a file of its own.

    port_bench/configs/<config>.json   the model, keys as published
    port_bench/traffic/<traffic>.json  the mix: lengths, loop, server shape
    port_bench/cells/<cell>.json       the cell's rate and correctness limits
    port_bench/metrics/<metric>.py     one reader a metric; a metric split
                                       by the end-to-end metric it moves
                                       (``mfu.chat``, ``mfu.long``) shares
                                       ``metrics/mfu.py`` unless it has a
                                       file of its own

A later change adds a cell, a mix or a metric by adding such files and
entries, never by editing one that is there.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]


@dataclass
class Metric:
    name: str
    unit: str
    better: str
    read: Callable[[Any], Optional[float]]
    labels: Dict[str, tuple] = field(default_factory=dict)


@dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: Dict[str, Any]          # the configuration file
    traffic: Dict[str, Any]         # the mix file
    params: Dict[str, Any]          # the cell file
    end_to_end: List[Metric]
    per_layer: List[Metric]

    def port_config_kwargs(self) -> Dict[str, Any]:
        return port_config_kwargs(self.config)

    @property
    def labels(self) -> Dict[str, tuple]:
        """The ``record_function`` labels the cell's traced metrics read:
        label -> (module, function name)."""
        out: Dict[str, tuple] = {}
        for m in self.per_layer:
            out.update(m.labels)
        return out


def read_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def port_config_kwargs(config: Dict[str, Any]) -> Dict[str, Any]:
    """The port's ``ModelConfig`` keywords: each field the file maps to a
    published key takes that key's value, and the file's ``set`` fields
    (name, family, dtype, what the source does not state) are added."""
    port = config["port"]
    kw = {f: config[k] for f, k in port["from_config"].items()}
    kw.update(port["set"])
    return kw


def load_reader(path: Path):
    """A metric's reader module, loaded from its file (names hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "port_bench_metric_" + path.stem.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader_path(bench_dir: Path, name: str) -> Path:
    """``metrics/<name>.py``, or where there is none, the file of the name
    up to its first dot."""
    own = bench_dir / "metrics" / f"{name}.py"
    return own if own.exists() else \
        bench_dir / "metrics" / f"{name.split('.')[0]}.py"


def _metrics(entries, per_layer: bool, cell: str, reported_e2e: List[str],
             bench_dir: Path) -> List[Metric]:
    out = []
    for e in entries:
        if "workloads" in e:
            if cell not in e["workloads"]:
                continue
        elif per_layer and e["moves"] not in reported_e2e:
            continue
        mod = load_reader(reader_path(bench_dir, e["name"]))
        out.append(Metric(e["name"], e["unit"], e["better"], mod.read,
                          dict(getattr(mod, "LABELS", {}))))
    return out


def load_cell(name: str, bench_file: Optional[Path] = None,
              bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` (at the checkout's root)
    with its files; raises KeyError for a cell it does not list."""
    bench_file = bench_file or bench_dir.parent / "BENCHMARK.json"
    bench = read_json(bench_file)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {bench_file}")
    w = cells[name]
    e2e = _metrics(bench["end_to_end"], False, name, [], bench_dir)
    names = [m.name for m in e2e]
    per = _metrics(bench["per_layer"], True, name, names, bench_dir)
    return Cell(name=name, config_name=w["config"], traffic_name=w["traffic"],
                chips=int(w["chips"]),
                config=read_json(bench_dir / "configs" / f"{w['config']}.json"),
                traffic=read_json(bench_dir / "traffic" / f"{w['traffic']}.json"),
                params=read_json(bench_dir / "cells" / f"{name}.json"),
                end_to_end=e2e, per_layer=per)
