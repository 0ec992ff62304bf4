"""repro-lint of the port: codebase-specific static analysis (the
counterpart of ``repro.analysis.lint``, DESIGN.md §14), scoped to the
port's idioms.

The five rule ids are ``repro``'s; each takes its torch form:

  RL001  host-sync-in-autograd  Python ``if``/``while``/``assert``/
                            conditional expression, ``bool()``/``int()``/
                            ``float()`` or ``.item()`` on a tensor inside
                            ``forward``/``backward`` of a
                            ``torch.autograd.Function`` subclass, or a
                            function they reach (a host sync paid in every
                            training step).  ``ctx``, parameters annotated
                            as non-tensors (``causal: bool``), tensor
                            metadata (``.shape``, ``.dtype``, ``.device``,
                            ``.numel()``, ``.data_ptr()`` ...) and
                            ``x is None`` tests are exempt.
  RL002  recompile-hazard   No torch form: the port compiles nothing per
                            shape (its kernels build once per source
                            digest, ``kernels/build.py``), so the rule
                            reports nothing.  The id stays in ``RULES``.
  RL003  host-sync          ``.item()``/``.cpu()``/``.tolist()``/
                            ``.numpy()``, ``int()``/``float()``/``bool()``
                            of a tensor, ``np.asarray``/``np.array`` of a
                            tensor, and ``torch.cuda.synchronize`` (any
                            ``*.synchronize``) inside the serve hot path
                            (``decode_round``, ``step``, ``submit``,
                            ``*fused*``, and what they call in
                            ``serve/``) outside the allowlisted
                            ``@metered`` decorator or a
                            ``# repro-lint: allow(RL003)`` pragma.
  RL004  kernel-contract    Every ``kernels/<name>/`` directory keeps the
                            ``kernel.py``/``ref.py``/``ops.py`` triple,
                            ``ref.py`` (the plain version) imports neither
                            ``kernel.py`` nor ``kernels.build`` nor
                            ``ctypes``, and ``kernel.py`` gets its launch
                            shapes through ``autotune.tiles_for``.
  RL005  determinism        No unseeded ``random.*`` module calls, no
                            global ``np.random.*`` samplers, no torch
                            sampler (``torch.rand*``/``randn*``/
                            ``randint``/``randperm``/``normal``/
                            ``bernoulli``/``multinomial``) without
                            ``generator=``, no ``torch.manual_seed`` /
                            ``torch.seed``, and no ``datetime.now``-family
                            wall-clock reads in the ``dht/`` / ``core/``
                            simulation planes.

All analysis is stdlib ``ast``.  The rules are heuristics that know this
repo's idioms (``tiles_for``, the serve hot-path names, the autograd
Functions), and the committed ``baseline.json`` ratchet (``baseline.py``)
absorbs the residue: recorded findings may stay, NEW findings fail.

Suppression:

  * ``# repro-lint: allow(RL003)`` (or ``allow(RL001, RL003)`` /
    ``allow(*)``) on the flagged line, or the line above it, suppresses
    those rules there.  Suppressions are counted in the report, never
    silent.
  * a decorator whose name contains ``metered`` marks a function as an
    allowlisted metering site for RL003 (``metering.metered``).
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

__all__ = ["Finding", "LintReport", "RULES", "run_lint", "collect_files"]

RULES: Dict[str, str] = {
    "RL001": "host-sync-in-autograd: Python control flow / coercion on a "
             "tensor in a torch.autograd.Function's forward/backward",
    "RL002": "recompile-hazard: no torch form -- the port compiles nothing "
             "per shape (kernels build once per source digest)",
    "RL003": "host-sync: device materialization inside the serve hot path",
    "RL004": "kernel-contract: kernels/<name>/ triple, a plain ref.py, or "
             "tiles_for broken",
    "RL005": "determinism: unseeded randomness / wall-clock in a sim plane",
}

_HINTS: Dict[str, str] = {
    "RL001": "use torch.where/masking, keep the decision on tensor metadata "
             "(shape/dtype/device), or pass the flag as a non-tensor "
             "argument",
    "RL002": "",
    "RL003": "keep the sync out of the round loop, fuse it into one device "
             "read a round, or mark a metering site with @metered / "
             "'# repro-lint: allow(RL003) <why>'",
    "RL004": "keep kernel.py (launcher) / ref.py (plain version: no kernel, "
             "build or ctypes import) / ops.py (wrapper); resolve launch "
             "shapes via autotune.tiles_for",
    "RL005": "thread a seeded random.Random / np.random.default_rng / "
             "torch.Generator through the caller instead",
}

# serve hot-path roots (RL003): the per-round / per-request functions a
# hidden host sync taxes on EVERY call
_HOT_ROOTS = {"decode_round", "step", "submit"}
# functions and methods of the serve plane whose results are device
# tensors: the model's decode and prefill steps
_DEVICE_CALL_RE = re.compile(r"^_?(decode|prefill)")
_PRAGMA_RE = re.compile(r"#\s*repro-lint:\s*allow\(([^)]*)\)")
# module-level `random.<fn>` calls that consume the global (unseeded) RNG
_RANDOM_FNS = {
    "random", "randint", "randrange", "choice", "choices", "shuffle",
    "sample", "uniform", "gauss", "normalvariate", "expovariate",
    "betavariate", "gammavariate", "lognormvariate", "vonmisesvariate",
    "paretovariate", "weibullvariate", "triangular", "getrandbits",
    "seed",
}
_NP_RANDOM_OK = {"default_rng", "Generator", "RandomState", "SeedSequence",
                 "PRNGKey"}
_WALLCLOCK = {"now", "utcnow", "today"}
# torch samplers that draw from the global generator unless given one
_TORCH_SAMPLERS = {"normal", "bernoulli", "multinomial", "poisson"}
_TORCH_SEEDING = {"torch.manual_seed", "torch.seed",
                  "torch.random.manual_seed", "torch.random.seed"}


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str          # scan-root-relative posix path
    line: int
    scope: str         # enclosing function qualname, or "<module>"
    message: str
    hint: str = ""

    @property
    def key(self) -> str:
        """Baseline-ratchet identity: line-free, so unrelated edits that
        shift line numbers never churn the baseline."""
        return f"{self.rule}:{self.path}:{self.scope}:{self.message}"

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} [{self.scope}] " \
               f"{self.message}" + (f"  (fix: {self.hint})" if self.hint
                                    else "")


@dataclass
class LintReport:
    findings: List[Finding] = field(default_factory=list)
    suppressed: List[Finding] = field(default_factory=list)
    files: int = 0

    def by_rule(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for f in self.findings:
            out[f.rule] = out.get(f.rule, 0) + 1
        return out


# ---------------------------------------------------------------------------
# module indexing
# ---------------------------------------------------------------------------

def _dotted(node: ast.AST) -> Optional[str]:
    """'jnp.argmax' for Attribute chains rooted at a Name, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _root(node: ast.AST) -> Optional[str]:
    d = _dotted(node)
    return d.split(".", 1)[0] if d else None


@dataclass
class FuncInfo:
    qualname: str
    node: ast.AST                        # FunctionDef | AsyncFunctionDef
    module: "ModuleInfo"
    params: List[str]
    static_params: Set[str]              # annotated as non-tensors
    is_entry: bool = False               # an autograd Function's forward/
    metered: bool = False                # backward
    calls: Set[str] = field(default_factory=set)   # simple-name targets


@dataclass
class ModuleInfo:
    path: Path                           # absolute
    rel: str                             # scan-root-relative posix
    tree: ast.Module
    lines: List[str]
    funcs: Dict[str, FuncInfo] = field(default_factory=dict)  # simple name
    all_funcs: List[FuncInfo] = field(default_factory=list)   # every def
    imports: Dict[str, Tuple[str, str]] = field(default_factory=dict)
    # local name -> (resolved module key, original name)

    def pragma_allows(self, line: int, rule: str) -> bool:
        for ln in (line, line - 1):
            if 1 <= ln <= len(self.lines):
                m = _PRAGMA_RE.search(self.lines[ln - 1])
                if m:
                    allowed = {s.strip() for s in m.group(1).split(",")}
                    if "*" in allowed or rule in allowed:
                        return True
        return False


# annotations that name a tensor: anything else (bool, int, float, str,
# Optional[int], ...) marks a host value, exempt from RL001
_TENSOR_ANN = ("Tensor",)


def _static_params_of(fn: ast.AST) -> Set[str]:
    """Params annotated with a non-tensor type (``causal: bool``)."""
    out: Set[str] = set()
    args = fn.args
    for a in args.posonlyargs + args.args + args.kwonlyargs:
        if a.annotation is not None and not any(
                t in ast.unparse(a.annotation) for t in _TENSOR_ANN):
            out.add(a.arg)
    return out


def _is_autograd_function(cls: ast.ClassDef) -> bool:
    """``class F(torch.autograd.Function)`` / ``(autograd.Function)`` /
    ``(Function)``."""
    return any((_dotted(b) or "") in ("torch.autograd.Function",
                                       "autograd.Function", "Function")
               for b in cls.bases)


def _is_metered(fn: ast.AST) -> bool:
    for deco in fn.decorator_list:
        target = deco.func if isinstance(deco, ast.Call) else deco
        d = _dotted(target)
        if d and "metered" in d.split(".")[-1]:
            return True
    return False


class _Indexer(ast.NodeVisitor):
    """One pass per module: functions, imports, call edges, entries."""

    def __init__(self, mod: ModuleInfo):
        self.mod = mod
        self.stack: List[str] = []
        self.fn_stack: List[FuncInfo] = []
        self.cls_stack: List[ast.ClassDef] = []

    # -- imports ---------------------------------------------------------
    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        mod = node.module or ""
        key = f"{'.' * node.level}{mod}"
        for alias in node.names:
            self.mod.imports[alias.asname or alias.name] = (key, alias.name)
        self.generic_visit(node)

    # -- functions -------------------------------------------------------
    def _visit_func(self, node) -> None:
        qual = ".".join(self.stack + [node.name]) if self.stack else node.name
        args = node.args
        params = [a.arg for a in
                  args.posonlyargs + args.args + args.kwonlyargs]
        # a method of an autograd Function (directly in the class body)
        owner = self.cls_stack[-1] if self.cls_stack and \
            self.stack and self.stack[-1] == self.cls_stack[-1].name \
            else None
        info = FuncInfo(qual, node, self.mod, params,
                        _static_params_of(node),
                        is_entry=owner is not None and node.name in (
                            "forward", "backward")
                        and _is_autograd_function(owner),
                        metered=_is_metered(node))
        self.mod.funcs.setdefault(node.name, info)
        self.mod.all_funcs.append(info)
        self.stack.append(node.name)
        self.fn_stack.append(info)
        self.generic_visit(node)
        self.fn_stack.pop()
        self.stack.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self.stack.append(node.name)
        self.cls_stack.append(node)
        self.generic_visit(node)
        self.cls_stack.pop()
        self.stack.pop()

    # -- calls -----------------------------------------------------------
    def visit_Call(self, node: ast.Call) -> None:
        name = None
        if isinstance(node.func, ast.Name):
            name = node.func.id
        elif isinstance(node.func, ast.Attribute) and \
                isinstance(node.func.value, ast.Name) and \
                node.func.value.id in ("self", "cls"):
            name = node.func.attr
        if name and self.fn_stack:
            self.fn_stack[-1].calls.add(name)
        self.generic_visit(node)


def _index_module(path: Path, rel: str) -> Optional[ModuleInfo]:
    try:
        src = path.read_text()
        tree = ast.parse(src)
    except (SyntaxError, UnicodeDecodeError, OSError):
        return None
    mod = ModuleInfo(path=path, rel=rel, tree=tree, lines=src.splitlines())
    _Indexer(mod).visit(tree)
    return mod


# ---------------------------------------------------------------------------
# cross-module reachability
# ---------------------------------------------------------------------------

def _module_key(rel: str) -> str:
    return rel[:-3].replace("/", ".") if rel.endswith(".py") else rel


def _resolve_import(mods: Dict[str, ModuleInfo], cur: ModuleInfo,
                    spec: str) -> Optional[str]:
    """Best-effort: map an import spec to a scanned module key."""
    if spec.startswith("."):
        level = len(spec) - len(spec.lstrip("."))
        base = _module_key(cur.rel).split(".")
        base = base[:-level] if level <= len(base) else []
        tail = spec.lstrip(".")
        parts = base + (tail.split(".") if tail else [])
        cand = ".".join(parts)
    else:
        cand = spec
    if cand in mods:
        return cand
    # absolute imports may carry a prefix the scan root strips (e.g.
    # `repro_torch.kernels.x` scanned as `src.repro_torch.kernels.x`)
    for key in mods:
        if key == cand or key.endswith("." + cand) or \
                cand.endswith("." + key):
            return key
    return None


def _resolve_callee(mods: Dict[str, ModuleInfo], fi: FuncInfo,
                    name: str) -> Optional[FuncInfo]:
    target = fi.module.funcs.get(name)
    if target is None and name in fi.module.imports:
        spec, orig = fi.module.imports[name]
        mkey = _resolve_import(mods, fi.module, spec)
        if mkey is not None:
            target = mods[mkey].funcs.get(orig)
    return target


def _reachable(mods: Dict[str, ModuleInfo],
               roots: Iterable[FuncInfo]) -> Set[int]:
    """BFS over the (module-resolved) simple-name call graph; returns
    id()s of reachable FuncInfos."""
    seen: Set[int] = set()
    work = list(roots)
    while work:
        fi = work.pop()
        if id(fi) in seen:
            continue
        seen.add(id(fi))
        for callee in fi.calls:
            target = _resolve_callee(mods, fi, callee)
            if target is not None and id(target) not in seen:
                work.append(target)
    return seen


# ---------------------------------------------------------------------------
# tensor taint (shared by RL001 / RL003)
# ---------------------------------------------------------------------------

# torch.<attr> calls that return host values, not tensors
_TORCH_HOST = {"cuda", "backends", "device", "finfo", "iinfo", "is_tensor",
               "is_floating_point", "is_complex", "is_grad_enabled",
               "get_default_dtype", "Size", "dtype", "Generator", "no_grad",
               "enable_grad", "inference_mode", "autograd", "_C", "version",
               "distributed", "jit", "compiler", "utils", "profiler",
               "set_grad_enabled", "get_rng_state", "manual_seed"}
# tensor attributes and methods that are metadata: host values, no sync
_STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "layout",
                 "requires_grad", "itemsize", "nbytes", "names",
                 "needs_input_grad", "type"}
_STATIC_METHODS = {"numel", "dim", "size", "element_size", "data_ptr",
                   "is_contiguous", "stride", "nelement", "ndimension",
                   "get_device", "is_floating_point", "is_complex",
                   "storage_offset", "untyped_storage"}
_PY_CALLS = {"len", "isinstance", "type", "hasattr", "id", "callable",
             "str", "repr", "print"}


def _is_torch_call(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    d = _dotted(node.func)
    parts = d.split(".") if d else []
    return len(parts) >= 2 and parts[0] == "torch" \
        and parts[1] not in _TORCH_HOST


class _Taint:
    """Forward, order-of-statements taint over one function body: which
    names hold tensors."""

    def __init__(self, tainted: Set[str]):
        self.tainted = set(tainted)

    def expr_tainted(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Attribute):
            if node.attr in _STATIC_ATTRS:
                return False
            if node.attr == "saved_tensors":
                return True
        if isinstance(node, ast.Name):
            return node.id in self.tainted
        if _is_none_check(node):          # identity never reads a tensor
            return False
        if isinstance(node, ast.Call):
            if isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _STATIC_METHODS:
                return False
            if isinstance(node.func, ast.Name) and \
                    node.func.id in _PY_CALLS:
                return False
            if _is_torch_call(node):
                return True
        if isinstance(node, (ast.GeneratorExp, ast.ListComp, ast.SetComp,
                             ast.DictComp)):
            return self._comprehension(node)
        return any(self.expr_tainted(c)
                   for c in ast.iter_child_nodes(node))

    def _comprehension(self, node) -> bool:
        """Bind each generator's targets to its iterable's taint, then
        read the element (and the conditions) under those bindings."""
        inner = _Taint(self.tainted)
        for gen in node.generators:
            inner.bind(gen.target, inner._elements_tainted(gen.iter))
            if any(inner.expr_tainted(c) for c in gen.ifs):
                return True
        elts = [node.key, node.value] if isinstance(node, ast.DictComp) \
            else [node.elt]
        return any(inner.expr_tainted(e) for e in elts)

    def _elements_tainted(self, node: ast.AST) -> bool:
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            return any(self.expr_tainted(e) for e in node.elts)
        return self.expr_tainted(node)

    def bind(self, target: ast.AST, tainted: bool) -> None:
        for sub in ast.walk(target):
            if isinstance(sub, ast.Name):
                if tainted:
                    self.tainted.add(sub.id)
                else:
                    self.tainted.discard(sub.id)


def _is_none_check(test: ast.AST) -> bool:
    """`x is None` / `x is not None`: identity on a tensor is no sync."""
    return isinstance(test, ast.Compare) and all(
        isinstance(op, (ast.Is, ast.IsNot)) for op in test.ops)


def _iter_body_stmts(fn: ast.AST):
    """Statements of fn in SOURCE order (DFS pre-order: taint binding
    must see a definition before its uses), skipping nested function/
    class bodies (they are analyzed as their own FuncInfo)."""

    def walk(stmts):
        for stmt in stmts:
            yield stmt
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            for name in ("body", "orelse", "finalbody"):
                yield from walk(getattr(stmt, name, []) or [])
            for h in getattr(stmt, "handlers", []) or []:
                yield from walk(h.body)

    yield from walk(fn.body)


def _shallow_walk(stmt: ast.AST):
    """Walk the statement's OWN expressions only: nested statement lists
    are visited by ``_iter_body_stmts`` in their own right, and walking
    them here would double-count every finding."""
    for fname, value in ast.iter_fields(stmt):
        if fname in ("body", "orelse", "finalbody", "handlers"):
            continue
        vals = value if isinstance(value, list) else [value]
        for v in vals:
            if isinstance(v, ast.AST):
                yield from ast.walk(v)


def _bind_stmt(t: _Taint, stmt: ast.AST, tainted) -> None:
    if isinstance(stmt, ast.Assign):
        value = tainted(stmt.value)
        for tgt in stmt.targets:
            t.bind(tgt, value)
    elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)) and \
            stmt.value is not None:
        t.bind(stmt.target, tainted(stmt.value))
    elif isinstance(stmt, ast.For):
        t.bind(stmt.target, t._elements_tainted(stmt.iter))


# ---------------------------------------------------------------------------
# RL001 -- host sync in an autograd Function
# ---------------------------------------------------------------------------

_RL001_EXCLUDED_PARAMS = {"self", "cls", "ctx", "model", "cfg", "config",
                          "mesh"}


def _rl001(mods: Dict[str, ModuleInfo], emit) -> None:
    entries = [fi for m in mods.values() for fi in m.all_funcs
               if fi.is_entry]
    reach = _reachable(mods, entries)
    infos = [fi for m in mods.values() for fi in m.all_funcs
             if id(fi) in reach]

    def seedable(fi: FuncInfo, p: str) -> bool:
        return p not in _RL001_EXCLUDED_PARAMS and \
            p not in fi.static_params and p in fi.params

    # interprocedural taint, two layers:
    #   * an ENTRY's params are tensors (ctx and annotated host values
    #     aside);
    #   * a reachable helper's param is a tensor only if some call site
    #     in reached code passes it a tainted argument.
    # fixpoint over call sites, then one emitting pass.
    param_taint: Dict[int, Set[str]] = {
        id(fi): ({p for p in fi.params if seedable(fi, p)}
                 if fi.is_entry else set())
        for fi in infos}

    def analyze(fi: FuncInfo, check) -> None:
        t = _Taint(set(param_taint[id(fi)]))
        for stmt in _iter_body_stmts(fi.node):
            check(fi, t, stmt)
            _bind_stmt(t, stmt, t.expr_tainted)

    def propagate(fi: FuncInfo, t: _Taint, stmt: ast.AST) -> None:
        for sub in _shallow_walk(stmt):
            if not isinstance(sub, ast.Call):
                continue
            name = None
            if isinstance(sub.func, ast.Name):
                name = sub.func.id
            elif isinstance(sub.func, ast.Attribute) and \
                    isinstance(sub.func.value, ast.Name) and \
                    sub.func.value.id in ("self", "cls"):
                name = sub.func.attr
            callee = _resolve_callee(mods, fi, name) if name else None
            if callee is None or id(callee) not in param_taint:
                continue
            # method resolution: skip a leading self/cls param
            params = callee.params
            if params and params[0] in ("self", "cls") and \
                    isinstance(sub.func, ast.Attribute):
                params = params[1:]
            for i, arg in enumerate(sub.args):
                if isinstance(arg, ast.Starred):
                    break
                if i < len(params) and t.expr_tainted(arg) and \
                        seedable(callee, params[i]):
                    if params[i] not in param_taint[id(callee)]:
                        param_taint[id(callee)].add(params[i])
                        propagate.changed = True
            for kw in sub.keywords:
                if kw.arg and t.expr_tainted(kw.value) and \
                        seedable(callee, kw.arg):
                    if kw.arg not in param_taint[id(callee)]:
                        param_taint[id(callee)].add(kw.arg)
                        propagate.changed = True

    for _ in range(6):                     # call-graph-depth fixpoint
        propagate.changed = False
        for fi in infos:
            analyze(fi, propagate)
        if not propagate.changed:
            break

    def check(fi: FuncInfo, t: _Taint, stmt: ast.AST) -> None:
        m = fi.module

        def flag(node, what):
            emit(Finding("RL001", m.rel, node.lineno, fi.qualname,
                         f"{what} on a tensor "
                         f"`{ast.unparse(node)[:60]}`",
                         _HINTS["RL001"]), m)

        if isinstance(stmt, (ast.If, ast.While)) and \
                not _is_none_check(stmt.test) and \
                t.expr_tainted(stmt.test):
            flag(stmt.test, type(stmt).__name__.lower() + " branch")
        if isinstance(stmt, ast.Assert) and t.expr_tainted(stmt.test):
            flag(stmt.test, "assert")
        for sub in _shallow_walk(stmt):
            if isinstance(sub, ast.IfExp) and \
                    not _is_none_check(sub.test) and \
                    t.expr_tainted(sub.test):
                flag(sub.test, "conditional-expression test")
            if isinstance(sub, ast.Call):
                fname = _dotted(sub.func)
                if fname in ("bool", "int", "float") and sub.args \
                        and t.expr_tainted(sub.args[0]):
                    flag(sub, f"{fname}() coercion")
                if isinstance(sub.func, ast.Attribute) and \
                        sub.func.attr == "item" and \
                        t.expr_tainted(sub.func.value):
                    flag(sub, ".item() materialization")

    for fi in infos:
        analyze(fi, check)


# ---------------------------------------------------------------------------
# RL002 -- no torch form
# ---------------------------------------------------------------------------

def _rl002(mods: Dict[str, ModuleInfo], emit) -> None:
    """``repro``'s recompile hazard has no counterpart in the port: it
    traces and compiles nothing per shape (the CUDA kernels build once per
    source digest, ``kernels/build.py``), so nothing is reported."""
    return None


# ---------------------------------------------------------------------------
# RL003 -- host sync in the serve hot path
# ---------------------------------------------------------------------------

_HOST_METHODS = {"cpu", "numpy", "tolist", "item"}


def _device_expr(node: ast.AST, t: _Taint, kernel_imports: Set[str]) -> bool:
    """Does the expression hold a device tensor (RL003)?  torch calls,
    the serve plane's kernel wrappers and decode/prefill steps, ``.to``
    / ``.cuda``, and names bound to those; never a host read's result."""
    if isinstance(node, ast.Attribute) and node.attr in _STATIC_ATTRS:
        return False
    if _is_none_check(node):
        return False
    if isinstance(node, ast.Call):
        d = _dotted(node.func) or ""
        # np.* results and host reads live on the HOST: the sync is the
        # call itself (flagged by `check`), not later uses of its result
        if d.split(".")[0] in ("np", "numpy"):
            return False
        if isinstance(node.func, ast.Attribute):
            attr = node.func.attr
            if attr in _HOST_METHODS or attr in _STATIC_METHODS:
                return False
            if attr in ("to", "cuda"):
                return True
            if _DEVICE_CALL_RE.match(attr) and attr != "decode_round":
                return True
        if isinstance(node.func, ast.Name):
            if node.func.id in _PY_CALLS:
                return False
            if node.func.id in kernel_imports:
                return True
            if _DEVICE_CALL_RE.match(node.func.id) and \
                    node.func.id != "decode_round":
                return True
        if _is_torch_call(node):
            return True
    if isinstance(node, ast.Name):
        return node.id in t.tainted
    return any(_device_expr(c, t, kernel_imports)
               for c in ast.iter_child_nodes(node))


def _rl003(mods: Dict[str, ModuleInfo], emit) -> None:
    serve_mods = {k: m for k, m in mods.items()
                  if "serve/" in m.rel or "/serve" in m.rel.rsplit("/", 1)[0]}
    if not serve_mods:
        return
    roots = [fi for m in serve_mods.values() for fi in m.all_funcs
             if fi.node.name in _HOT_ROOTS or "fused" in fi.node.name]
    hot_ids = _reachable(serve_mods, roots)
    hot = [fi for m in serve_mods.values() for fi in m.all_funcs
           if id(fi) in hot_ids and not fi.metered]
    # kernel wrappers imported into serve return device tensors
    kernel_imports = {id(m): {alias for alias, (spec, _) in m.imports.items()
                              if "kernel" in spec}
                      for m in serve_mods.values()}
    # a hot callee's param holds a device tensor where some hot call site
    # passes it one (fixpoint, as RL001's)
    param_dev: Dict[int, Set[str]] = {id(fi): set() for fi in hot}

    def analyze(fi: FuncInfo, visit) -> None:
        t = _Taint(set(param_dev[id(fi)]))
        kimp = kernel_imports[id(fi.module)]

        def dev(node):
            return _device_expr(node, t, kimp)

        for stmt in _iter_body_stmts(fi.node):
            for sub in _shallow_walk(stmt):
                if isinstance(sub, ast.Call):
                    visit(fi, sub, dev)
            _bind_stmt(t, stmt, dev)

    def propagate(fi: FuncInfo, sub: ast.Call, dev) -> None:
        name = sub.func.id if isinstance(sub.func, ast.Name) else \
            sub.func.attr if isinstance(sub.func, ast.Attribute) and \
            isinstance(sub.func.value, ast.Name) and \
            sub.func.value.id in ("self", "cls") else None
        callee = _resolve_callee(serve_mods, fi, name) if name else None
        if callee is None or id(callee) not in param_dev:
            return
        params = callee.params
        if params and params[0] in ("self", "cls") and \
                isinstance(sub.func, ast.Attribute):
            params = params[1:]
        passed = [(params[i], a) for i, a in enumerate(sub.args)
                  if i < len(params) and not isinstance(a, ast.Starred)]
        passed += [(k.arg, k.value) for k in sub.keywords
                   if k.arg in callee.params]
        for p, a in passed:
            if p not in param_dev[id(callee)] and dev(a):
                param_dev[id(callee)].add(p)
                propagate.changed = True

    for _ in range(6):                     # call-graph-depth fixpoint
        propagate.changed = False
        for fi in hot:
            analyze(fi, propagate)
        if not propagate.changed:
            break

    def check(fi: FuncInfo, sub: ast.Call, dev) -> None:
        d = _dotted(sub.func) or ""
        attr = sub.func.attr if isinstance(sub.func, ast.Attribute) else None
        what = None
        if attr == "synchronize":
            what = d or ".synchronize()"
        elif d == "synchronize":
            what = "synchronize()"
        elif d in ("np.asarray", "numpy.asarray", "np.array",
                   "numpy.array") and sub.args and dev(sub.args[0]):
            what = d
        elif d in ("int", "float", "bool") and sub.args and \
                dev(sub.args[0]):
            what = f"{d}()"
        elif attr in _HOST_METHODS and dev(sub.func.value):
            what = f".{attr}()"
        if what:
            emit(Finding("RL003", fi.module.rel, sub.lineno, fi.qualname,
                         f"host sync `{what}` in serve hot path "
                         f"(`{ast.unparse(sub)[:60]}`)", _HINTS["RL003"]),
                 fi.module)

    for fi in hot:
        analyze(fi, check)


# ---------------------------------------------------------------------------
# RL004 -- kernel directory contract
# ---------------------------------------------------------------------------

def _ref_forbidden_import(tree: ast.Module) -> Optional[Tuple[int, str]]:
    """(line, what) of the first import a plain version must not make:
    the launcher (``kernel.py``), the build (``kernels.build``) or
    ``ctypes``."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                last = a.name.split(".")[-1]
                if a.name == "ctypes" or last in ("kernel", "build"):
                    return node.lineno, a.name
        elif isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            last = mod.split(".")[-1] if mod else ""
            if mod == "ctypes" or (mod and last in ("kernel", "build")):
                return node.lineno, "." * node.level + mod
            if not mod:
                for a in node.names:
                    if a.name in ("kernel", "build"):
                        return node.lineno, "." * node.level + a.name
    return None


def _mentions_tiles_for(tree: ast.Module) -> bool:
    for node in ast.walk(tree):
        if isinstance(node, ast.Name) and node.id == "tiles_for":
            return True
        if isinstance(node, ast.Attribute) and node.attr == "tiles_for":
            return True
        if isinstance(node, (ast.Import, ast.ImportFrom)) and any(
                a.name == "tiles_for" or a.asname == "tiles_for"
                for a in node.names):
            return True
    return False


def _rl004(mods: Dict[str, ModuleInfo], emit) -> None:
    by_dir: Dict[Path, Dict[str, ModuleInfo]] = {}
    for m in mods.values():
        parent = m.path.parent
        if parent.parent.name == "kernels" and \
                parent.name != "__pycache__":
            by_dir.setdefault(parent, {})[m.path.name] = m
    for d, files in sorted(by_dir.items()):
        rel_dir = next(iter(files.values())).rel.rsplit("/", 1)[0]
        anchor = next(iter(files.values()))
        missing = {"kernel.py", "ref.py", "ops.py"} - set(files)
        if missing:
            emit(Finding("RL004", rel_dir, 1, "<dir>",
                         f"kernel dir missing {sorted(missing)} of the "
                         "kernel/ref/ops triple", _HINTS["RL004"]), anchor)
        ref = files.get("ref.py")
        if ref is not None:
            bad = _ref_forbidden_import(ref.tree)
            if bad is not None:
                emit(Finding("RL004", ref.rel, bad[0], "<module>",
                             f"ref.py imports `{bad[1]}`: the plain version "
                             "must run without the kernels' build",
                             _HINTS["RL004"]), ref)
        kernel = files.get("kernel.py")
        if kernel is not None and not _mentions_tiles_for(kernel.tree):
            emit(Finding("RL004", kernel.rel, 1, "<module>",
                         "kernel launch shapes not resolved via "
                         "autotune.tiles_for", _HINTS["RL004"]), kernel)


# ---------------------------------------------------------------------------
# RL005 -- determinism in the simulation planes
# ---------------------------------------------------------------------------

def _is_torch_sampler(name: str) -> bool:
    return name.startswith("rand") or name in _TORCH_SAMPLERS


def _rl005(mods: Dict[str, ModuleInfo], emit) -> None:
    for m in mods.values():
        if not ("/dht/" in f"/{m.rel}" or "/core/" in f"/{m.rel}"):
            continue
        scope = "<module>"
        for node in ast.walk(m.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                scope = node.name        # coarse but stable
            if not isinstance(node, ast.Call):
                continue
            d = _dotted(node.func)
            if not d:
                continue
            parts = d.split(".")
            if parts[0] == "random" and len(parts) == 2 and \
                    parts[1] in _RANDOM_FNS:
                emit(Finding("RL005", m.rel, node.lineno, scope,
                             f"unseeded global RNG call `{d}()`",
                             _HINTS["RL005"]), m)
            elif len(parts) >= 3 and parts[0] in ("np", "numpy") and \
                    parts[1] == "random" and parts[2] not in _NP_RANDOM_OK:
                emit(Finding("RL005", m.rel, node.lineno, scope,
                             f"global numpy RNG call `{d}()`",
                             _HINTS["RL005"]), m)
            elif parts[-1] in _WALLCLOCK and "datetime" in parts or \
                    (len(parts) == 2 and parts[0] in ("datetime", "date")
                     and parts[1] in _WALLCLOCK):
                emit(Finding("RL005", m.rel, node.lineno, scope,
                             f"wall-clock read `{d}()` in a sim plane",
                             _HINTS["RL005"]), m)
            elif d in _TORCH_SEEDING:
                emit(Finding("RL005", m.rel, node.lineno, scope,
                             f"global torch RNG seeding `{d}()`",
                             _HINTS["RL005"]), m)
            elif len(parts) == 2 and parts[0] == "torch" and \
                    _is_torch_sampler(parts[1]) and not any(
                        kw.arg == "generator" for kw in node.keywords):
                emit(Finding("RL005", m.rel, node.lineno, scope,
                             f"torch RNG call `{d}()` without generator=",
                             _HINTS["RL005"]), m)


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def collect_files(paths: Sequence[Path]) -> List[Path]:
    out: List[Path] = []
    for p in paths:
        p = Path(p)
        if p.is_file() and p.suffix == ".py":
            out.append(p)
        elif p.is_dir():
            out.extend(f for f in sorted(p.rglob("*.py"))
                       if "__pycache__" not in f.parts)
    return out


def run_lint(paths: Sequence, root: Optional[Path] = None,
             rules: Optional[Set[str]] = None) -> LintReport:
    """Lint ``paths`` (files or directories); findings carry paths
    relative to ``root`` (default: cwd) so baseline keys are stable
    across checkouts."""
    root = Path(root) if root is not None else Path.cwd()
    files = collect_files([Path(p) for p in paths])
    mods: Dict[str, ModuleInfo] = {}
    for f in files:
        try:
            rel = f.resolve().relative_to(root.resolve()).as_posix()
        except ValueError:
            rel = f.as_posix()
        mod = _index_module(f, rel)
        if mod is not None:
            mods[_module_key(rel)] = mod
    report = LintReport(files=len(mods))

    def emit(finding: Finding, mod: ModuleInfo) -> None:
        if rules is not None and finding.rule not in rules:
            return
        if mod.pragma_allows(finding.line, finding.rule):
            report.suppressed.append(finding)
        else:
            report.findings.append(finding)

    _rl001(mods, emit)
    _rl002(mods, emit)
    _rl003(mods, emit)
    _rl004(mods, emit)
    _rl005(mods, emit)
    report.findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return report
