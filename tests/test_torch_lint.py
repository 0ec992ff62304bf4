"""The port's repro-lint (``repro_torch.analysis``): each of
``tests/test_repro_lint.py``'s rule tests in its torch form (the violation
is flagged, its clean twin is not), RL005's non-torch checks and the
baseline ratchet held to ``repro``'s ``run_lint`` / ``Baseline`` on the
same fixture trees, and the CLI's exit codes on seeded violations and on
the committed ``src/repro_torch``."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.analysis import Baseline as JBaseline
from repro.analysis import run_lint as j_run_lint
from repro_torch.analysis import RULES, Baseline, run_lint
from repro_torch.analysis.metering import meter_count, metered, reset_meters

REPO = Path(__file__).resolve().parent.parent


def _write(root: Path, rel: str, code: str) -> Path:
    p = root / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(code)
    return p


def _rules_of(report):
    return sorted({f.rule for f in report.findings})


# ---------------------------------------------------------------------------
# RL001: a host sync inside an autograd Function
# ---------------------------------------------------------------------------

RL001_BAD = """\
import torch

class ReluBranchy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        if x.sum() > 0:
            return x
        return torch.zeros_like(x)

    @staticmethod
    def backward(ctx, g):
        return g
"""

RL001_OK = """\
import torch
from typing import Optional

class Relu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, causal: bool, h0=None):
        if causal:                    # a host argument: no sync
            x = x * 2
        if h0 is None:                # identity on a maybe-tensor
            h0 = torch.zeros_like(x)
        if x.shape[0] > 4 or x.dtype != torch.float32 \\
                or x.device.type == "cpu" or x.numel() == 0:
            x = x + 1                 # metadata: no sync
        if any(t.data_ptr() % 16 for t in (x, h0)):
            x = x.clone()
        ctx.save_for_backward(x)
        return torch.where(x > 0, x, torch.zeros_like(x)) + h0

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        if ctx.needs_input_grad[0]:
            g = g * (x > 0)
        return g, None, None
"""


def test_rl001_flags_a_tensor_branch_and_spares_the_clean_twin(tmp_path):
    _write(tmp_path, "bad.py", RL001_BAD)
    rep = run_lint([tmp_path], root=tmp_path)
    assert _rules_of(rep) == ["RL001"]
    assert rep.findings[0].scope == "ReluBranchy.forward"
    _write(tmp_path, "bad.py", RL001_OK)
    assert run_lint([tmp_path], root=tmp_path).findings == []


def test_rl001_reaches_through_the_call_graph(tmp_path):
    _write(tmp_path, "deep.py", """\
import torch

def helper(x):
    while x.sum() > 0:
        x = x - 1
    return x

class Fn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return helper(x)

    @staticmethod
    def backward(ctx, g):
        return g
""")
    rep = run_lint([tmp_path], root=tmp_path)
    assert [f.rule for f in rep.findings] == ["RL001"]
    assert rep.findings[0].scope == "helper"


@pytest.mark.parametrize("line,what", [
    ("n = int(g.sum())", "int() coercion"),
    ("n = float(g.max())", "float() coercion"),
    ("n = bool(g.any())", "bool() coercion"),
    ("n = g.norm().item()", ".item() materialization"),
    ("n = 1 if g.sum() > 0 else 0", "conditional-expression test"),
    ("assert (g >= 0).all()", "assert"),
])
def test_rl001_flags_each_coercion_in_backward(tmp_path, line, what):
    _write(tmp_path, "fn.py", f"""\
import torch

class Fn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x * 2

    @staticmethod
    def backward(ctx, g):
        {line}
        return g * 2
""")
    rep = run_lint([tmp_path], root=tmp_path)
    assert [f.rule for f in rep.findings] == ["RL001"], rep.findings
    assert rep.findings[0].message.startswith(what)
    assert rep.findings[0].scope == "Fn.backward"


def test_rl001_is_scoped_to_autograd_functions(tmp_path):
    """The same branch in a plain function or an nn.Module is no entry."""
    _write(tmp_path, "plain.py", """\
import torch

def relu(x):
    if x.sum() > 0:
        return x
    return torch.zeros_like(x)

class Layer(torch.nn.Module):
    def forward(self, x):
        if x.sum() > 0:
            return x
        return x * 0
""")
    assert run_lint([tmp_path], root=tmp_path).findings == []


# ---------------------------------------------------------------------------
# RL002: no torch form
# ---------------------------------------------------------------------------

RL002_BAD = """\
import numpy as np
import jax.numpy as jnp

def upload(xs):
    n = len(xs)
    buf = np.zeros(n, np.int32)
    return jnp.asarray(buf)
"""


def test_rl002_has_no_torch_form(tmp_path):
    _write(tmp_path, "bad.py", RL002_BAD)
    assert _rules_of(j_run_lint([tmp_path], root=tmp_path)) == ["RL002"]
    assert run_lint([tmp_path], root=tmp_path).findings == []
    assert "RL002" in RULES and "no torch form" in RULES["RL002"]


# ---------------------------------------------------------------------------
# RL003: a host sync in the serve hot path
# ---------------------------------------------------------------------------

RL003_BAD = """\
import numpy as np
import torch

def decode_round(cache, tokens):
    logits = torch.ones((4, 8)) * tokens
    return logits.cpu().numpy()
"""

RL003_OK = """\
import numpy as np
import torch
from repro_torch.analysis.metering import metered

def decode_round(cache, tokens):
    toks = torch.argmax(torch.ones((4, 8)) * tokens, dim=-1)
    # repro-lint: allow(RL003) the one mandatory per-round transfer
    return toks.cpu().numpy()

@metered
def calibrate(route):
    torch.cuda.synchronize()
    return route
"""


def test_rl003_flags_hot_path_sync_and_honours_allowlists(tmp_path):
    _write(tmp_path, "serve/hot.py", RL003_BAD)
    rep = run_lint([tmp_path], root=tmp_path)
    assert _rules_of(rep) == ["RL003"]
    assert rep.findings[0].scope == "decode_round"
    assert len(rep.findings) == 1          # the .cpu(), not the .numpy()
    _write(tmp_path, "serve/hot.py", RL003_OK)
    rep = run_lint([tmp_path], root=tmp_path)
    assert rep.findings == []
    assert len(rep.suppressed) == 1
    # the SAME file outside serve/ is not hot-path at all
    _write(tmp_path, "serve/hot.py", "")
    _write(tmp_path, "offline.py", RL003_BAD)
    assert run_lint([tmp_path], root=tmp_path).findings == []


@pytest.mark.parametrize("line,what", [
    ("return logits.item()", ".item()"),
    ("return logits.tolist()", ".tolist()"),
    ("return int(logits.argmax())", "int()"),
    ("return float(logits.sum())", "float()"),
    ("return bool(logits.any())", "bool()"),
    ("return np.asarray(logits)", "np.asarray"),
    ("return torch.cuda.synchronize()", "torch.cuda.synchronize"),
])
def test_rl003_flags_each_sync_through_a_callee(tmp_path, line, what):
    _write(tmp_path, "serve/server.py", f"""\
import numpy as np
import torch

def _read(logits):
    {line}

class Replica:
    def decode_round(self):
        return self._finish(torch.ones(4))

    def _finish(self, logits):
        return _read(logits * 2)

    def offline(self, logits):
        return logits.cpu()
""")
    rep = run_lint([tmp_path], root=tmp_path)
    assert [f.rule for f in rep.findings] == ["RL003"], rep.findings
    assert rep.findings[0].scope == "_read"
    assert f"`{what}" in rep.findings[0].message


def test_rl003_host_values_are_no_sync(tmp_path):
    _write(tmp_path, "serve/server.py", """\
import numpy as np
import torch

def step(tokens, lengths):
    n = int(lengths.max())                 # numpy
    host = torch.from_numpy(tokens).cpu()  # from_numpy's result, moved
    k = int(np.asarray(tokens).sum())
    return n + k + len(host) + int(host.shape[0])
""")
    rep = run_lint([tmp_path], root=tmp_path)
    kinds = [f.message.split("`")[1] for f in rep.findings]
    # torch.from_numpy(...) is a torch call: conservatively a device value
    assert kinds == [".cpu()"]


# ---------------------------------------------------------------------------
# RL004: the kernel directory contract
# ---------------------------------------------------------------------------

KERNEL_OK = "from repro_torch.kernels.autotune import tiles_for\n"


def test_rl004_kernel_contract(tmp_path):
    _write(tmp_path, "kernels/foo/kernel.py", KERNEL_OK)
    _write(tmp_path, "kernels/foo/ops.py", "def op(x):\n    return x\n")
    rep = run_lint([tmp_path], root=tmp_path)
    assert any("missing" in f.message and f.rule == "RL004"
               for f in rep.findings)
    _write(tmp_path, "kernels/foo/ref.py", "def plain(x):\n    return x\n")
    _write(tmp_path, "kernels/foo/kernel.py", "TILE = 128\n")
    rep = run_lint([tmp_path], root=tmp_path)
    assert any("tiles_for" in f.message for f in rep.findings)
    _write(tmp_path, "kernels/foo/kernel.py", KERNEL_OK)
    assert run_lint([tmp_path], root=tmp_path).findings == []


@pytest.mark.parametrize("imp", [
    "from .kernel import foo_cuda",
    "from . import kernel",
    "from .. import build",
    "from ..build import launch",
    "from repro_torch.kernels.build import library",
    "import repro_torch.kernels.build",
    "import ctypes",
    "from ctypes import c_int",
])
def test_rl004_flags_a_plain_version_that_needs_the_build(tmp_path, imp):
    _write(tmp_path, "kernels/foo/kernel.py", KERNEL_OK)
    _write(tmp_path, "kernels/foo/ops.py", "def op(x):\n    return x\n")
    _write(tmp_path, "kernels/foo/ref.py",
           f"{imp}\n\ndef plain(x):\n    return x\n")
    rep = run_lint([tmp_path], root=tmp_path)
    assert [f.rule for f in rep.findings] == ["RL004"]
    assert "ref.py imports" in rep.findings[0].message


# ---------------------------------------------------------------------------
# RL005: determinism in the simulation planes
# ---------------------------------------------------------------------------

RL005_BAD = """\
import random
from datetime import datetime

def jitter():
    return random.random() + datetime.now().timestamp()
"""

RL005_OK = """\
import random
import numpy as np

def jitter(seed):
    rng = random.Random(seed)
    return rng.random() + float(np.random.default_rng(seed).random())
"""

RL005_TORCH_BAD = """\
import torch

def draw(n):
    torch.manual_seed(0)
    a = torch.rand(n) + torch.randn(n) + torch.normal(0.0, 1.0, (n,))
    b = torch.randint(0, 9, (n,)) + torch.randperm(n)
    c = torch.bernoulli(a.clamp(0, 1)) + torch.multinomial(a.abs() + 1, 2)
    return a, b, c, torch.randn_like(a)
"""

RL005_TORCH_OK = """\
import torch

def draw(n, seed):
    g = torch.Generator().manual_seed(seed)
    a = torch.rand(n, generator=g) + torch.randn(n, generator=g)
    b = torch.randint(0, 9, (n,), generator=g) + torch.randperm(n, generator=g)
    return a, b, torch.normal(0.0, 1.0, (n,), generator=g)
"""


def test_rl005_determinism_in_sim_planes(tmp_path):
    _write(tmp_path, "dht/node.py", RL005_BAD)
    rep = run_lint([tmp_path], root=tmp_path)
    assert {f.rule for f in rep.findings} == {"RL005"}
    assert len(rep.findings) == 2          # unseeded RNG + wall clock
    _write(tmp_path, "dht/node.py", RL005_OK)
    assert run_lint([tmp_path], root=tmp_path).findings == []
    # the same code OUTSIDE dht/-core/ is not a sim plane
    _write(tmp_path, "dht/node.py", "")
    _write(tmp_path, "tools/node.py", RL005_BAD)
    assert run_lint([tmp_path], root=tmp_path).findings == []


def test_rl005_torch_samplers_need_a_generator(tmp_path):
    _write(tmp_path, "core/draw.py", RL005_TORCH_BAD)
    msgs = [f.message for f in run_lint([tmp_path], root=tmp_path).findings]
    assert msgs[0] == "global torch RNG seeding `torch.manual_seed()`"
    assert sorted(m.split("`")[1] for m in msgs[1:]) == sorted(
        f"torch.{n}()" for n in ("rand", "randn", "normal", "randint",
                                 "randperm", "bernoulli", "multinomial",
                                 "randn_like"))
    _write(tmp_path, "core/draw.py", RL005_TORCH_OK)
    assert run_lint([tmp_path], root=tmp_path).findings == []


@pytest.mark.parametrize("code", [RL005_BAD, RL005_OK, """\
import random
import numpy as np
from datetime import date, datetime

def a():
    random.seed(3)
    np.random.shuffle([1, 2])

class Node:
    def b(self):
        return datetime.utcnow(), date.today(), random.choice([1])

    def c(self):
        return np.random.default_rng(1).random(), random.getrandbits(3)
"""])
def test_rl005_non_torch_checks_give_repros_keys(tmp_path, code):
    _write(tmp_path, "dht/node.py", code)
    _write(tmp_path, "core/sim.py", code)
    ours = run_lint([tmp_path], root=tmp_path).findings
    theirs = j_run_lint([tmp_path], root=tmp_path).findings
    assert [(f.key, f.line) for f in ours] == \
        [(f.key, f.line) for f in theirs]


# ---------------------------------------------------------------------------
# the baseline ratchet, against repro's
# ---------------------------------------------------------------------------

def _diff_keys(diff):
    return ([f.key for f in diff.new], [f.key for f in diff.baselined],
            diff.stale, diff.ok)


def test_baseline_ratchet_matches_repros(tmp_path):
    _write(tmp_path, "dht/node.py", RL005_BAD)

    def both():
        return (run_lint([tmp_path], root=tmp_path).findings,
                j_run_lint([tmp_path], root=tmp_path).findings)

    first, j_first = both()
    bl, j_bl = Baseline.from_findings(first), JBaseline.from_findings(j_first)
    assert bl.counts == j_bl.counts
    # baselined: the same findings pass the gate
    diff, j_diff = bl.diff(first), j_bl.diff(j_first)
    assert _diff_keys(diff) == _diff_keys(j_diff)
    assert diff.ok and len(diff.baselined) == 2 and not diff.stale
    # new: an extra offender fails even though the recorded ones pass
    _write(tmp_path, "dht/other.py", RL005_BAD)
    now, j_now = both()
    diff, j_diff = bl.diff(now), j_bl.diff(j_now)
    assert _diff_keys(diff) == _diff_keys(j_diff)
    assert not diff.ok and len(diff.new) == 2 and len(diff.baselined) == 2
    # fixed: the offenders gone -> the gate passes, the entries go stale
    _write(tmp_path, "dht/node.py", RL005_OK)
    _write(tmp_path, "dht/other.py", "")
    now, j_now = both()
    diff, j_diff = bl.diff(now), j_bl.diff(j_now)
    assert _diff_keys(diff) == _diff_keys(j_diff)
    assert diff.ok and len(diff.stale) == 2
    # re-recording prunes: the ratchet only shrinks
    assert sum(Baseline.from_findings(now).counts.values()) == 0


def test_baseline_keys_are_line_free_like_repros(tmp_path):
    _write(tmp_path, "dht/node.py", RL005_BAD)
    bl = Baseline.from_findings(run_lint([tmp_path], root=tmp_path).findings)
    _write(tmp_path, "dht/node.py", "\n\n\n" + RL005_BAD)
    findings = run_lint([tmp_path], root=tmp_path).findings
    diff = bl.diff(findings)
    assert diff.ok and not diff.stale
    assert [f.key for f in findings] == [
        f.key for f in j_run_lint([tmp_path], root=tmp_path).findings]


def test_baseline_save_load_roundtrip(tmp_path):
    _write(tmp_path, "dht/node.py", RL005_BAD)
    bl = Baseline.from_findings(run_lint([tmp_path], root=tmp_path).findings)
    bl.save(tmp_path / "baseline.json")
    assert Baseline.load(tmp_path / "baseline.json").counts == bl.counts
    assert JBaseline.load(tmp_path / "baseline.json").counts == bl.counts
    assert Baseline.load(tmp_path / "missing.json").counts == {}


def test_committed_baseline_is_the_serve_rounds_host_reads():
    """The committed ratchet holds exactly the serve hot path's host syncs:
    the one device read of ``Replica.decode_round`` (tokens, and the
    owners in a fused round)."""
    bl = Baseline.load(REPO / "src" / "repro_torch" / "analysis"
                       / "baseline.json")
    assert sorted(k.split(":")[0] for k in bl.counts) == ["RL003", "RL003"]
    assert all(":Replica.decode_round:" in k for k in bl.counts)


# ---------------------------------------------------------------------------
# the CLI: exit codes
# ---------------------------------------------------------------------------

def _cli(*args, cwd=REPO):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", *args],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("rule,rel,code", [
    ("RL001", "bad.py", RL001_BAD),
    ("RL003", "serve/hot.py", RL003_BAD),
    ("RL004", "kernels/foo/ops.py", "def op(x):\n    return x\n"),
    ("RL005", "dht/node.py", RL005_BAD),
    ("RL005", "core/draw.py", RL005_TORCH_BAD),
])
def test_cli_exits_nonzero_on_each_seeded_violation(tmp_path, rule, rel,
                                                    code):
    _write(tmp_path, rel, code)
    res = _cli(str(tmp_path), "--root", str(tmp_path), "--no-baseline")
    assert res.returncode == 1, res.stdout + res.stderr
    assert rule in res.stdout


def test_cli_exits_zero_on_the_committed_tree():
    res = _cli()
    assert res.returncode == 0, res.stdout + res.stderr
    assert "0 new" in res.stdout


def test_cli_update_baseline_writes_and_gate_then_passes(tmp_path):
    _write(tmp_path, "dht/node.py", RL005_BAD)
    bl = tmp_path / "bl.json"
    res = _cli(str(tmp_path), "--root", str(tmp_path),
               "--baseline", str(bl), "--update-baseline")
    assert res.returncode == 0 and bl.exists()
    res = _cli(str(tmp_path), "--root", str(tmp_path), "--baseline", str(bl))
    assert res.returncode == 0
    assert "2 baselined" in res.stdout
    assert _cli("--rules", "RL009").returncode == 2


def test_metered_counts_calls():
    reset_meters()

    @metered
    def probe(x):
        return x * 2

    assert probe(3) == 6 and probe(4) == 8
    assert meter_count(probe) == 2
    reset_meters()
    assert meter_count(probe) == 0
