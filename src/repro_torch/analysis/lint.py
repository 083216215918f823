"""Pass B: an AST lint for CUDA-graph hazards (the port's counterpart of
``repro/analysis/lint.py``; the rules live in ``rules.py``).

The reference lints the bodies of jitted functions.  The port's counterpart
of a jitted function is a **tick body**: a function whose call a CUDA graph
captures and then replays without running its Python again.  Per file the
engine finds them as the reference finds ``jax.jit`` calls, at their call
sites: the function and warm-up arguments of every ``StepGraphs.run(key,
fn, warmup)`` call (``serve/graphs.py``), a lambda standing for the
functions it calls; the names in the graph key are fixed for a capture
(the reference's static arguments).  Beside them ``TICK_FUNCTIONS`` names
the model step methods and per-layer functions those bodies run, which
live in other files.  Inside a tick body a parameter is a tensor unless
it is ``self``/``cls``/``cfg``, has a constant default (a flag), or is
named static for it; the lint flags:

* L-TRACED-BRANCH: ``if``/``while``/``x if c else y`` on a tensor's value;
* L-TRACED-CAST: ``int``/``float``/``bool``, ``.item()``, ``.tolist()``,
  ``.cpu()``, ``.numpy()`` of a tensor;
* L-NP-TRACED: numpy called on a tensor;
* L-DONATED-REBIND: a cache leaf rebound (``cache[k] = ...``) or an
  attribute reached from ``self`` rebound (``self.arena = ...``): the
  graph keeps the old buffer, the capture needs ``copy_``/``index_copy_``
  in place.

A local bound to an expression of a tensor, or looping over one, is a
tensor too.

A tensor's metadata (``.shape``, ``.dtype``, ``.device``, ``.dim()``,
``len``, ``isinstance``), identity tests (``x is None``) and membership
tests on a dict of leaves (``"k_scale" in cache``) are host values and
never flagged.  Over every file: L-STATIC-UNHASHABLE (a graph key with
a list, dict or set in it), L-MUT-DEFAULT and L-UNUSED-IMPORT, as in the
reference.  The analysis is syntactic: it never imports the linted code.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Optional

from repro_torch.analysis.findings import Finding

MUTABLE_CALLS = {"list", "dict", "set", "deque", "defaultdict", "Counter",
                 "OrderedDict", "bytearray"}
UNHASHABLE_NODES = (ast.List, ast.Dict, ast.Set, ast.ListComp, ast.DictComp, ast.SetComp)
CAST_CALLS = {"int", "float", "bool", "complex"}
# identity and membership tests (``x is None``, ``"k_scale" in cache``)
HOST_COMPARES = (ast.Is, ast.IsNot, ast.In, ast.NotIn)
SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "__index__"}
NUMPY_ALIASES = {"np", "numpy"}
# numpy attributes that are pure metadata or constants: safe on a tensor
NUMPY_SAFE_ATTRS = {"shape", "ndim", "dtype", "float32", "float64", "int32", "int64", "int8",
                    "bool_", "uint32", "pi", "inf", "nan", "newaxis", "intp", "issubdtype",
                    "floating", "integer", "number", "result_type", "promote_types"}
# a tensor's metadata: host values, never a sync
META_ATTRS = {"shape", "dtype", "device", "ndim", "is_cuda", "dim", "size", "numel",
              "element_size", "is_contiguous", "stride", "requires_grad", "is_floating_point"}
META_CALLS = {"isinstance", "len", "hasattr", "type", "id", "callable"}
# parameters that are never tensors
STATIC_ALWAYS = {"self", "cls", "cfg"}
# the model step methods and per-layer functions the captured ticks run
# (models/, serve/sampling.py), each with its parameters that are Python
# values fixed for a capture
TICK_FUNCTIONS = {
    "fused_step_slots_paged": ("sentinel",),
    "fused_step_slots": (),
    "decode_step_slots": (),
    "decode_step": (),
    "attn_paged_chunk": ("probe",),
    "mla_paged_chunk": ("probe",),
    "paged_quant_write": ("block_size", "return_clip"),
    "paged_probe_word": ("block_size",),
    "attn_slab_chunk": (),
    "attn_slab_decode": (),
    "mla_slab_chunk": (),
    "sample": ("seed",),
}
# names whose subscripts are cache leaves
CACHE_NAMES = {"cache", "pool_cache", "arenas", "slabs"}


def dotted(node: ast.AST) -> Optional[str]:
    """'self.pool.cache'-style dotted name for Name/Attribute chains."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _graph_run(call: ast.Call) -> bool:
    """Whether ``call`` is ``<...graphs>.run(key, fn, warmup)``."""
    name = dotted(call.func)
    if not name or not name.endswith(".run") or len(call.args) < 1:
        return False
    return name.split(".")[-2].lower().endswith("graphs")


def _callees(node: ast.AST) -> set[str]:
    """The functions a graph-run argument stands for: a lambda's calls, or
    the named function itself (methods bind by attribute name)."""
    if isinstance(node, ast.Lambda):
        return {d.split(".")[-1] for sub in ast.walk(node.body) if isinstance(sub, ast.Call)
                for d in [dotted(sub.func)] if d}
    name = dotted(node)
    return {name.split(".")[-1]} if name else set()


def _loaded_names(node: ast.AST) -> set[str]:
    return {sub.id for sub in ast.walk(node) if isinstance(sub, ast.Name)}


def _unhashable(node: ast.AST) -> bool:
    if isinstance(node, UNHASHABLE_NODES):
        return True
    if isinstance(node, ast.Call) and dotted(node.func) in MUTABLE_CALLS:
        return True
    if isinstance(node, ast.Tuple):
        return any(_unhashable(e) for e in node.elts)
    return False


class _Index(ast.NodeVisitor):
    """Per file: the tick bodies found at graph-run call sites (name ->
    the key's names), and the graph keys to check for hashability."""

    def __init__(self):
        self.bodies: dict[str, set[str]] = {}
        self.keys: list[ast.AST] = []
        self._fns: list[ast.AST] = []

    def visit_FunctionDef(self, node) -> None:
        self._fns.append(node)
        self.generic_visit(node)
        self._fns.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def _key_exprs(self, key: ast.AST) -> list[ast.AST]:
        """The key, or for a name the values assigned to it in the
        enclosing function."""
        if isinstance(key, ast.Name) and self._fns:
            found = [n.value for n in ast.walk(self._fns[-1]) if isinstance(n, ast.Assign)
                     and any(isinstance(t, ast.Name) and t.id == key.id for t in n.targets)]
            return found or [key]
        return [key]

    def visit_Call(self, node: ast.Call) -> None:
        if _graph_run(node):
            exprs = self._key_exprs(node.args[0])
            self.keys.extend(exprs)
            static = set().union(*(_loaded_names(e) for e in exprs))
            for arg in node.args[1:3]:
                for name in _callees(arg):
                    self.bodies.setdefault(name, set()).update(static)
        self.generic_visit(node)


def _stmt_targets(stmt: ast.stmt) -> list[ast.AST]:
    if isinstance(stmt, ast.Assign):
        return list(stmt.targets)
    if isinstance(stmt, (ast.AugAssign, ast.AnnAssign)) and stmt.target is not None:
        return [stmt.target]
    return []


class FileLinter:
    def __init__(self, path: str, src: str):
        self.path = path
        self.tree = ast.parse(src)
        self.findings: list[Finding] = []
        self.index = _Index()
        self.index.visit(self.tree)

    def _emit(self, rule: str, severity: str, lineno: int, msg: str) -> None:
        self.findings.append(Finding(rule, severity, f"{self.path}:{lineno}", msg))

    # ------------------------------------------------------- module level --
    def check_unused_imports(self) -> None:
        if Path(self.path).name == "__init__.py":
            return  # re-export surface: unused-at-module-scope is the point
        imported: dict[str, int] = {}
        for node in self.tree.body:
            if isinstance(node, ast.Import):
                for a in node.names:
                    imported[a.asname or a.name.split(".")[0]] = node.lineno
            elif isinstance(node, ast.ImportFrom):
                if node.module == "__future__":
                    continue
                for a in node.names:
                    if a.name == "*" or a.asname == a.name:
                        continue  # explicit re-export (PEP 484 idiom)
                    imported[a.asname or a.name] = node.lineno
        used: set[str] = set()
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Name):
                used.add(node.id)
            elif isinstance(node, ast.Attribute):
                d = dotted(node)
                if d:
                    used.add(d.split(".")[0])
        for node in self.tree.body:  # names quoted in __all__
            if (isinstance(node, ast.Assign)
                    and any(dotted(t) == "__all__" for t in node.targets)):
                used |= {el.value for el in ast.walk(node.value)
                         if isinstance(el, ast.Constant) and isinstance(el.value, str)}
        for name, lineno in imported.items():
            if name not in used:
                self._emit("L-UNUSED-IMPORT", "warning", lineno, f"import '{name}' is never used")

    def check_graph_keys(self) -> None:
        for key in self.index.keys:
            if _unhashable(key):
                self._emit("L-STATIC-UNHASHABLE", "error", key.lineno,
                           "a StepGraphs.run key holds a list, dict or set: every call raises "
                           "(or, rebuilt per call, never finds its graph)")

    # ----------------------------------------------------- function level --
    def check_functions(self) -> None:
        for fn in (n for n in ast.walk(self.tree)
                   if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))):
            self._check_mutable_defaults(fn)
            static = self.index.bodies.get(fn.name)
            if static is None and fn.name in TICK_FUNCTIONS:
                static = set(TICK_FUNCTIONS[fn.name])
            if static is not None:
                self._check_tick_body(fn, static)

    def _check_mutable_defaults(self, fn) -> None:
        for default in list(fn.args.defaults) + [d for d in fn.args.kw_defaults if d is not None]:
            mutable = isinstance(default, UNHASHABLE_NODES)
            if isinstance(default, ast.Call):
                mutable = dotted(default.func) in MUTABLE_CALLS
            if mutable:
                self._emit("L-MUT-DEFAULT", "error", default.lineno,
                           f"mutable default argument in '{fn.name}' is shared across calls")

    @staticmethod
    def _tensor_params(fn, static: set[str]) -> set[str]:
        args = fn.args.posonlyargs + fn.args.args + fn.args.kwonlyargs
        defaults = dict(zip([a.arg for a in fn.args.posonlyargs + fn.args.args][
            len(fn.args.posonlyargs + fn.args.args) - len(fn.args.defaults):],
            fn.args.defaults))
        defaults.update({a.arg: d for a, d in zip(fn.args.kwonlyargs, fn.args.kw_defaults)
                         if d is not None})
        out = set()
        for a in args:
            d = defaults.get(a.arg)
            flag = (isinstance(d, ast.Constant) and d.value is not None)
            if a.arg in STATIC_ALWAYS or a.arg in static or flag:
                continue
            out.add(a.arg)
        return out

    def _check_tick_body(self, fn, static: set[str]) -> None:
        tensors = self._tensor_params(fn, static)

        def mentions(node) -> bool:
            if isinstance(node, ast.Compare) and all(isinstance(op, HOST_COMPARES)
                                                     for op in node.ops):
                return False
            if isinstance(node, ast.Attribute) and node.attr in META_ATTRS:
                return False
            if isinstance(node, ast.Call) and dotted(node.func) in META_CALLS:
                return False
            if isinstance(node, ast.Name):
                return node.id in tensors
            return any(mentions(c) for c in ast.iter_child_nodes(node))

        # a local bound to a tensor expression (or a loop over one) is a tensor
        binds = [(t, n.value) for n in ast.walk(fn) if isinstance(n, (ast.Assign, ast.AnnAssign))
                 and n.value is not None for t in _stmt_targets(n)]
        binds += [(n.target, n.iter) for n in ast.walk(fn) if isinstance(n, ast.For)]
        grown = True
        while grown:
            before = len(tensors)
            for target, value in binds:
                if mentions(value):
                    tensors |= {el.id for el in ast.walk(target) if isinstance(el, ast.Name)}
            grown = len(tensors) > before

        where = f"tick body '{fn.name}'"
        for node in ast.walk(fn):
            if isinstance(node, (ast.If, ast.While)) and mentions(node.test):
                self._emit("L-TRACED-BRANCH", "error", node.lineno,
                           f"python branch on a tensor's value in {where}: a host sync at "
                           "capture, and the replays keep the branch it took (use torch.where)")
            elif isinstance(node, ast.IfExp) and mentions(node.test):
                self._emit("L-TRACED-BRANCH", "error", node.lineno,
                           f"conditional expression on a tensor's value in {where} "
                           "(use torch.where)")
            elif isinstance(node, ast.Call):
                callee = dotted(node.func)
                if callee in CAST_CALLS and any(mentions(a) for a in node.args):
                    self._emit("L-TRACED-CAST", "error", node.lineno,
                               f"{callee}() of a tensor in {where}: a host sync (a capture "
                               "fails on it)")
                elif (isinstance(node.func, ast.Attribute) and node.func.attr in SYNC_METHODS
                      and mentions(node.func.value)):
                    self._emit("L-TRACED-CAST", "error", node.lineno,
                               f".{node.func.attr}() of a tensor in {where}: a host sync")
                elif (callee and callee.split(".")[0] in NUMPY_ALIASES
                      and callee.split(".")[-1] not in NUMPY_SAFE_ATTRS
                      and any(mentions(a) for a in node.args)):
                    self._emit("L-NP-TRACED", "error", node.lineno,
                               f"numpy call {callee}() on a tensor in {where}: a host round "
                               "trip the replays never redo (use torch)")
            elif isinstance(node, ast.stmt):
                self._check_rebind(node, where)

    def _check_rebind(self, stmt: ast.stmt, where: str) -> None:
        for target in _stmt_targets(stmt):
            name = None
            if isinstance(target, ast.Subscript) and not isinstance(stmt, ast.AugAssign):
                base = dotted(target.value)
                if base and base.split(".")[-1] in CACHE_NAMES:
                    name = f"{base}[...]"
            elif isinstance(target, ast.Attribute) and (dotted(target) or "").startswith("self."):
                name = dotted(target)
            if name:
                self._emit("L-DONATED-REBIND", "error", stmt.lineno,
                           f"'{name}' rebound in {where}: the captured graph keeps the old "
                           "buffer (write it in place: copy_, index_copy_)")

    def run(self) -> list[Finding]:
        self.check_unused_imports()
        self.check_graph_keys()
        self.check_functions()
        return self.findings


def lint_source(src: str, path: str = "<string>") -> list[Finding]:
    return FileLinter(path, src).run()


def lint_paths(paths: list[str], root: str = ".") -> tuple[list[Finding], int]:
    """Lint every .py file under ``paths`` (files or directories, relative
    to ``root``).  Returns (findings, files_linted)."""
    rootp = Path(root)
    files: list[Path] = []
    for p in paths:
        pp = rootp / p
        if pp.is_dir():
            files.extend(sorted(pp.rglob("*.py")))
        elif pp.suffix == ".py":
            files.append(pp)
    findings: list[Finding] = []
    for f in files:
        rel = str(f.relative_to(rootp)) if f.is_relative_to(rootp) else str(f)
        findings.extend(lint_source(f.read_text(), rel))
    return findings, len(files)
