"""The port's quickstart tour (``python -m repro_torch.quickstart``)
against ``examples/quickstart.py``: the same five lines with the same
numbers, where only step 5's wording of the device may differ (repro
names its Pallas kernel; the port on the CPU names K7's plain
version)."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from repro_torch import quickstart
from repro_torch.kernels.ring_lookup import ops

REPO = Path(__file__).resolve().parents[1]


def _lines(cmd, **env):
    res = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                         timeout=300, env={**os.environ,
                                           "PYTHONPATH": str(REPO / "src"),
                                           **env})
    assert res.returncode == 0, res.stdout + res.stderr
    return res.stdout.strip().splitlines()


def test_quickstart_prints_repro_numbers():
    want = _lines([sys.executable, "examples/quickstart.py"],
                  JAX_PLATFORMS="cpu")
    got = _lines([sys.executable, "-m", "repro_torch.quickstart",
                  "--device", "cpu"])
    assert len(got) == len(want) == 5
    assert got[:4] == want[:4]
    assert want[4].startswith("ring_lookup kernel routed 4096 keys; ")
    assert got[4].startswith("ring_lookup plain version (cpu) routed 4096 "
                             "keys; ")
    assert got[4].split("; ", 1)[1] == want[4].split("; ", 1)[1]


def test_quickstart_step5_routes_every_key():
    lines = []
    before = ops.ring_lookup.launches
    res = quickstart.run("cpu", out=lines.append)
    assert len(lines) == 5 and ops.ring_lookup.launches == before
    table, keys = res["table"], res["keys"]
    assert table.dtype == keys.dtype == np.uint32 and table.size == 1000
    assert res["idx"].dtype == torch.int32
    np.testing.assert_array_equal(
        res["idx"].numpy(), np.searchsorted(table, keys, side="left") % 1000)
