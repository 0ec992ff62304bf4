"""The port's launch group (``repro_torch.launch.{presets, dryrun, mesh}``
and the registry's cells) against ``repro``'s: the presets, the cells,
the abstract trees and every full-size cell's per-device argument bytes
on both production meshes, and a dry run of each family's ``smoke()`` at
each mode on a small mesh of ``meta`` entries."""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_config
from repro.configs import registry as j_registry
from repro.launch import presets as j_presets
from repro.models import Model as JModel
from repro_torch.configs import (ARCH_IDS, SHAPES, all_cells, get_config,
                                 get_smoke_config, shape_cells, skipped_cells)
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun, presets
from repro_torch.launch.mesh import (HARDWARE, make_host_mesh,
                                     make_production_mesh)
from repro_torch.models import Model

REPO = Path(__file__).resolve().parents[1]
MESHES = {"16x16": False, "2x16x16": True}


# -- registry, presets, meshes ------------------------------------------------

def test_the_cells_are_repros():
    assert ARCH_IDS == j_registry.ARCH_IDS
    assert all_cells() == j_registry.all_cells()
    for arch in ARCH_IDS:
        assert [(s.name, s.seq_len, s.global_batch, s.mode)
                for s in shape_cells(arch)] == [
            (s.name, s.seq_len, s.global_batch, s.mode)
            for s in j_registry.shape_cells(arch)]
        assert skipped_cells(arch) == j_registry.skipped_cells(arch)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_preset_is_repros_for_every_shape(arch):
    for name, shape in SHAPES.items():
        assert presets.preset(get_config(arch), shape) == j_presets.preset(
            j_config(arch), J_SHAPES[name])


def test_production_mesh_is_repros_grid_of_meta_entries():
    single, multi = make_production_mesh(), make_production_mesh(
        multi_pod=True)
    assert single.shape == {"data": 16, "model": 16} and single.size == 256
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert multi.axis_names == ("pod", "data", "model") and multi.size == 512
    assert set(multi.entries()) == {torch.device("meta")}
    assert len(multi.entries()) == 512
    # a 2-D host mesh reads as before
    host = make_host_mesh(2, ["cpu"] * 8)
    assert host.shape == {"data": 4, "model": 2} and len(host.entries()) == 8
    assert host.devices[3][1] == torch.device("cpu")


def test_hardware_is_the_h100s():
    assert HARDWARE == {"peak_bf16_flops": 989e12, "hbm_bandwidth": 3.35e12,
                        "nvlink_bandwidth": 450e9, "hbm_bytes": 80 * 10**9}


# -- abstract trees ----------------------------------------------------------------

def _flat(tree, pre=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{pre}{k}/").items()}
    return {pre[:-1]: tree}


def _sd(t):
    return tuple(t.shape), str(t.dtype).replace("torch.", "")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_trees_are_repros(arch):
    """Every full-size parameter leaf (int8 experts too) and every cache
    leaf: repro's shape and dtype, nothing allocated."""
    over = [{}] + ([{"moe_weight_dtype": "int8"}]
                   if get_config(arch).moe_experts else [])
    for kw in over:
        mine = _flat(Model(get_config(arch).with_overrides(**kw))
                     .abstract_params())
        want = _flat(JModel(j_config(arch).with_overrides(**kw))
                     .abstract_params())
        assert {k: _sd(v) for k, v in mine.items()} == {
            k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
        assert all(v.device.type == "meta" for v in mine.values())
    mine = {k.split("/")[-1]: _sd(v) for k, v in _flat(
        Model(get_config(arch)).cache_shapes(2, 64)).items()}
    want = {k.split("/")[-1]: (tuple(v.shape), str(v.dtype)) for k, v in
            _flat(JModel(j_config(arch)).cache_shapes(2, 64)).items()}
    assert mine == want


# -- per-device argument bytes of every full-size cell ------------------------

_REPRO_ARGUMENT_BYTES = r"""
import json, math, os
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=512")
import jax
from repro.configs import SHAPES, get_config
from repro.configs.registry import all_cells
from repro.launch import dryrun as D, presets
from repro.launch.inputs import batch_pspecs, input_specs
from repro.launch.mesh import make_production_mesh
from repro.models import Model
from repro.optim import adamw
from repro.sharding import specs as sh


def nbytes(shardings, abstract):
    return sum(math.prod(s.shard_shape(a.shape)) * a.dtype.itemsize
               for s, a in zip(jax.tree.leaves(shardings),
                               jax.tree.leaves(abstract)))


out = {}
for arch, name in all_cells():
    for mesh_name, multi in (("16x16", False), ("2x16x16", True)):
        cfg, shape = get_config(arch), SHAPES[name]
        mesh = make_production_mesh(multi_pod=multi)
        sh.set_mesh(mesh, presets.preset(cfg, shape)[0])
        model = Model(cfg)
        ap = model.abstract_params()
        psh = D._fitted_shardings(mesh, D._resolve_pspecs(
            model.param_pspecs()), ap)
        ispecs = input_specs(cfg, shape)
        bsh = D._fitted_shardings(mesh, D._resolve_pspecs(
            batch_pspecs(cfg, shape)), ispecs)
        total = nbytes(psh, ap)
        if shape.mode == "train":
            st = adamw.init_state(ap, adamw.OptConfig(
                moment_dtype=cfg.opt_dtype))
            total += nbytes(psh, st["m"]) + nbytes(psh, st["v"]) + 4
            total += nbytes(bsh, ispecs)
        else:
            ac = model.cache_shapes(shape.global_batch, shape.seq_len)
            total += nbytes(D._fitted_shardings(mesh, D._resolve_pspecs(
                model.cache_pspecs()), ac), ac)
            if shape.mode == "prefill":
                total += nbytes(bsh, ispecs)
            else:
                total += nbytes(bsh["tokens"], ispecs["tokens"]) + 4
        sh.set_mesh(None)
        out[f"{arch}|{name}|{mesh_name}"] = total
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def repro_argument_bytes():
    """repro's per-device argument bytes of every cell, from a subprocess
    of 512 forced host devices: the flag never reaches this process."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(REPO / "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, "-c", _REPRO_ARGUMENT_BYTES],
                         env=env, capture_output=True, text=True,
                         timeout=300, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_argument_bytes_of_every_cell_are_repros(arch, repro_argument_bytes):
    assert "512" not in os.environ.get("XLA_FLAGS", "")
    assert len(jax.devices()) < 512
    for shape in shape_cells(arch):
        for mesh_name, multi in MESHES.items():
            cell = dryrun.Cell(get_config(arch), shape,
                               make_production_mesh(multi_pod=multi))
            got = sum(cell.argument_bytes().values())
            assert got == repro_argument_bytes[
                f"{arch}|{shape.name}|{mesh_name}"], (shape.name, mesh_name)


# -- the dry run at smoke size ---------------------------------------------

SMALL = {"train": ShapeConfig("train_4k", 32, 4, "train"),
         "prefill": ShapeConfig("prefill_32k", 32, 4, "prefill"),
         "decode": ShapeConfig("decode_32k", 32, 4, "decode")}


@pytest.mark.parametrize("mode", list(SMALL))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_dry_run_of_every_family(arch, mode, tmp_path):
    """``run_cell`` on each ``smoke()`` at each mode on a (2, 2) mesh of
    meta entries: ok, every record field, the ``per_device`` rule said,
    the record appended to the file it was given and nowhere else."""
    mesh = make_host_mesh(2, ["meta"] * 4)
    rec = dryrun.run_cell(get_smoke_config(arch), SMALL[mode], mesh)
    assert rec["ok"], rec.get("traceback")
    for key in ("devices", "matmul_flops_per_device", "hbm_bytes_per_device",
                "collective_bytes_per_device", "collective_bytes_by_op",
                "peak_memory_per_device", "argument_bytes", "temp_bytes",
                "params", "active_params", "tokens", "mode", "wall_s",
                "trace_s", "fits", "per_device"):
        assert key in rec
    assert rec["devices"] == 4 and rec["mode"] == mode and rec["fits"]
    assert rec["matmul_flops_per_device"] > 0 and rec["temp_bytes"] > 0
    assert rec["peak_memory_per_device"] == rec["argument_bytes"] \
        + rec["temp_bytes"]
    rules = presets.preset(get_smoke_config(arch), SMALL[mode])[0]
    assert (rec["per_device"] == "divided") == (rec["model_divisor"] == 2)
    if mode == "train" and rules["heads"] is None:      # DP + FSDP
        assert rec["per_device"] == "local_batch"
        assert rec["local_batch"] == 1
        assert rec["collective_bytes_by_op"]["all-gather"] \
            == 2 * rec["collective_bytes_by_op"]["reduce-scatter"]
    if mode != "train":                  # heads / ff on the model axis
        assert rec["per_device"] == "divided" and rec["local_batch"] == 2
        assert rec["collective_bytes_by_op"]["all-reduce"] > 0
    out = tmp_path / "dry.jsonl"
    dryrun.append_result(rec, str(out))
    assert [json.loads(line) for line in out.read_text().splitlines()] \
        == [json.loads(json.dumps(rec))]
    assert sorted(os.listdir(tmp_path)) == ["dry.jsonl"]
    assert not torch.cuda.is_initialized()


def test_a_failing_cell_is_recorded_not_raised():
    rec = dryrun.run_cell(get_smoke_config("qwen2.5-3b"),
                          ShapeConfig("train_4k", 32, 3, "train"),
                          make_host_mesh(2, ["meta"] * 4), microbatches=2)
    assert rec["ok"] is False and "microbatches" in rec["error"]


def test_skip_records_are_repros():
    for arch in ARCH_IDS:
        recs = dryrun.skip_records(arch)
        assert [r["shape"] for r in recs] == j_registry.skipped_cells(arch)
        assert all(r["ok"] is None and "sub-quadratic" in r["skipped"]
                   for r in recs)


def test_the_cli_wants_an_out_path():
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--all"])
    assert e.value.code == 2
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "qwen2.5-3b", "--out", "/dev/null"])


def test_fit_spec_drops_an_axis_that_does_not_divide():
    mesh = make_production_mesh()
    assert dryrun._fit_spec(mesh, ("model", ("data", "model"), None),
                            (12, 512, 7)) == (None, ("data", "model"), None)
    assert dryrun.shard_bytes(mesh, (None, ("data", "model")), (3, 512),
                              2) == 3 * 2 * 2
    assert math.prod(mesh.shape.values()) == 256
    np.testing.assert_equal(dryrun._fit_spec(mesh, (None,), ()), (None,))
