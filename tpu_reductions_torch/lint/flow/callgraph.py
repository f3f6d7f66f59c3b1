"""Static call-graph extraction for the port lint's flow layer (the
counterpart of tpu_reductions/lint/flow/callgraph.py, generic as it is).

One AST pass per file produces a serializable `ModuleInfo`: every
top-level function/method (plus the ``<module>`` body and the
``if __name__ == "__main__":`` guard as pseudo-functions) with its call
sites in line order, each resolved to a fully-qualified dotted target
where module-level binding analysis allows it:

* direct calls to names bound by ``def``/``class`` in the same module;
* ``import a.b [as z]`` / ``from a.b import c [as d]`` bindings,
  including function-local imports (the repo's lazy-import idiom) and
  relative imports;
* ``self.m()`` method calls resolved within the enclosing class.

One addition to the JAX extraction: a call site also records how it
passes a card device (rules.device_arg: "move" for ``x.to(dev)`` and
``x.cuda()``, "arg" for a ``device=dev`` keyword), because torch spells a
host->device copy with the same ``.to`` as a dtype cast and only the
argument tells them apart. The field is serialized only where it is set.

Anything dynamic (``fns[i]()``, calls on arbitrary objects) is recorded
as an *unresolved* call site — kept in the graph and the --graph export
so the analysis never silently drops an edge, but not propagated over.

Nested ``def``s and ``lambda``s fold into their enclosing function: the
``lambda: run_benchmark(cfg)`` handed to ``ctx.call`` is a
call site *of the enclosing function*, which is exactly the dispatch
path the flow rules reason about.

The extraction result is content-addressed: `extract_module` is pure in
(source, module name), so the fact cache (dataflow.py) can key it on a
source hash and reuse it until the file changes.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from tpu_reductions_torch.lint.rules import device_arg

# pseudo-function names: the module body and the __main__ guard body
MODULE_BODY = "<module>"
MAIN_GUARD = "<main>"


@dataclass
class CallSite:
    """One call expression: the dotted chain as written plus, when the
    binding analysis can see through it, the fully-qualified target."""
    line: int
    raw: str                      # dotted chain as written; '' = dynamic
    target: str                   # resolved dotted target ('' = dynamic)
    resolved: bool                # True when a binding resolved the root
    device_arg: str = ""          # passes a card device (rules.device_arg)

    def to_dict(self) -> dict:
        d = {"line": self.line, "raw": self.raw,
             "target": self.target, "resolved": self.resolved}
        if self.device_arg:
            d["device_arg"] = self.device_arg
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "CallSite":
        return cls(d["line"], d["raw"], d["target"], d["resolved"],
                   d.get("device_arg", ""))


@dataclass
class FunctionInfo:
    """One analysis node: a top-level def, a method, or a pseudo-body."""
    qualname: str                 # 'main', 'Cls.m', '<module>', '<main>'
    line: int
    calls: List[CallSite] = field(default_factory=list)
    facts: Dict[str, List[int]] = field(default_factory=dict)

    def add_fact(self, fact: str, line: int) -> None:
        self.facts.setdefault(fact, []).append(line)

    def to_dict(self) -> dict:
        return {"qualname": self.qualname, "line": self.line,
                "calls": [c.to_dict() for c in self.calls],
                "facts": self.facts}

    @classmethod
    def from_dict(cls, d: dict) -> "FunctionInfo":
        return cls(d["qualname"], d["line"],
                   [CallSite.from_dict(c) for c in d["calls"]],
                   {k: list(v) for k, v in d["facts"].items()})


@dataclass
class ModuleInfo:
    """Everything the dataflow pass needs from one file."""
    module: str                   # dotted module name
    rel: str                      # reporting path (posix)
    functions: Dict[str, FunctionInfo] = field(default_factory=dict)
    parse_error: Optional[str] = None

    def to_dict(self) -> dict:
        return {"module": self.module, "rel": self.rel,
                "functions": {k: f.to_dict()
                              for k, f in self.functions.items()},
                "parse_error": self.parse_error}

    @classmethod
    def from_dict(cls, d: dict) -> "ModuleInfo":
        return cls(d["module"], d["rel"],
                   {k: FunctionInfo.from_dict(f)
                    for k, f in d["functions"].items()},
                   d.get("parse_error"))


def module_name_for(path: Path, roots: Sequence[Path]) -> str:
    """Dotted module name for `path`: the path parts relative to the
    parent of the scan root that contains it (so scanning
    ``/repo/tpu_reductions_torch`` names
    ``tpu_reductions_torch.bench.spot``, and a
    fixture tree scanned at ``tmp/`` names ``bench.fixture``). A file
    under no scan root is named by its stem."""
    p = path.resolve()
    for root in roots:
        root = root.resolve()
        base = root.parent if root.is_dir() else root.parent
        try:
            rel = p.relative_to(base)
        except ValueError:
            continue
        parts = list(rel.with_suffix("").parts)
        if parts and parts[-1] == "__init__":
            parts = parts[:-1]
        if parts:
            return ".".join(parts)
    return p.stem


def _is_main_guard(node: ast.stmt) -> bool:
    """``if __name__ == "__main__":`` (either comparison order)."""
    if not isinstance(node, ast.If) or \
            not isinstance(node.test, ast.Compare):
        return False
    t = node.test
    sides = [t.left] + list(t.comparators)
    has_name = any(isinstance(s, ast.Name) and s.id == "__name__"
                   for s in sides)
    has_lit = any(isinstance(s, ast.Constant) and s.value == "__main__"
                  for s in sides)
    return has_name and has_lit


class _Bindings:
    """Name -> fully-qualified dotted target, from imports and defs."""

    def __init__(self, module: str, is_pkg: bool) -> None:
        self.module = module
        self.is_pkg = is_pkg
        self.names: Dict[str, str] = {}

    def _resolve_relative(self, level: int, mod: Optional[str]) -> str:
        parts = self.module.split(".") if self.module else []
        if not self.is_pkg:
            parts = parts[:-1]
        parts = parts[:len(parts) - (level - 1)] if level > 1 else parts
        if mod:
            parts = parts + mod.split(".")
        return ".".join(parts)

    def add_import(self, node: ast.stmt) -> None:
        if isinstance(node, ast.Import):
            for n in node.names:
                if n.asname:
                    self.names[n.asname] = n.name
                else:
                    # `import a.b.c` binds root `a`; the attribute chain
                    # a.b.c.f then resolves naturally
                    root = n.name.split(".")[0]
                    self.names[root] = root
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                base = self._resolve_relative(node.level, node.module)
            for n in node.names:
                if n.name == "*":
                    continue
                self.names[n.asname or n.name] = (
                    f"{base}.{n.name}" if base else n.name)

    def resolve_chain(self, chain: str) -> Tuple[str, bool]:
        """(target, resolved_by_binding) for a dotted call chain."""
        if not chain:
            return "", False
        root, _, rest = chain.partition(".")
        bound = self.names.get(root)
        if bound is None:
            return chain, False
        return (f"{bound}.{rest}" if rest else bound), True


def _attr_chain(node: ast.AST) -> str:
    """Dotted name of an attribute/name chain; '' for anything dynamic
    (mirrors lint/rules._attr_chain)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _collect_calls(body_nodes: Sequence[ast.AST], bindings: _Bindings,
                   cls: Optional[str], info: FunctionInfo,
                   local_import_scan: bool = True) -> None:
    """Walk statement subtrees, recording every Call in line order.
    Function-local imports extend a copy of the bindings first (the
    repo's lazy-import idiom: `from ...exec.core import maybe_arm`
    inside main)."""
    local = _Bindings(bindings.module, bindings.is_pkg)
    local.names = dict(bindings.names)
    if local_import_scan:
        for stmt in body_nodes:
            for sub in ast.walk(stmt):
                if isinstance(sub, (ast.Import, ast.ImportFrom)):
                    local.add_import(sub)
    # local-instance resolution: `e = ServeEngine(cfg)` followed by
    # `e.submit(req)` resolves through the constructor binding to
    # `module.ServeEngine.submit`. Capitalized-last-component is the
    # class heuristic (`out = run_bench()` never maps); a later
    # reassignment to anything else conservatively unmaps the name.
    instances: Dict[str, str] = {}
    for stmt in body_nodes:
        for sub in ast.walk(stmt):
            if not isinstance(sub, ast.Assign) or len(sub.targets) != 1 \
                    or not isinstance(sub.targets[0], ast.Name):
                continue
            name = sub.targets[0].id
            if isinstance(sub.value, ast.Call) and \
                    not isinstance(sub.value.func, ast.Call):
                chain = _attr_chain(sub.value.func)
                if chain:
                    t, _ = local.resolve_chain(chain)
                    if t.rsplit(".", 1)[-1][:1].isupper():
                        instances[name] = t
                        continue
            instances.pop(name, None)
    calls: List[CallSite] = []
    for stmt in body_nodes:
        for sub in ast.walk(stmt):
            if not isinstance(sub, ast.Call):
                continue
            if isinstance(sub.func, ast.Call):
                # an immediately-invoked factory result — `make(f)(x)`
                # runs NOW, unlike the lazy `g = make(f)`. Record the
                # outer invocation with a '()' marker so facts.py can
                # tell the two apart; '()' can never collide with a
                # dotted name.
                inner = _attr_chain(sub.func.func)
                if inner:
                    t, r = local.resolve_chain(inner)
                    calls.append(CallSite(sub.lineno, f"{inner}()",
                                          f"{t}()", r))
                else:
                    calls.append(CallSite(sub.lineno, "", "", False))
                continue
            chain = _attr_chain(sub.func)
            dev = device_arg(sub)
            if chain.startswith("self.") and cls is not None:
                rest = chain[len("self."):]
                target = f"{bindings.module}.{cls}.{rest}"
                calls.append(CallSite(sub.lineno, chain, target, True, dev))
                continue
            root = chain.split(".")[0] if chain else ""
            if "." in chain and root in instances:
                rest = chain.split(".", 1)[1]
                calls.append(CallSite(
                    sub.lineno, chain, f"{instances[root]}.{rest}", True,
                    dev))
                continue
            target, resolved = local.resolve_chain(chain)
            calls.append(CallSite(sub.lineno, chain, target, resolved, dev))
    calls.sort(key=lambda c: c.line)
    info.calls = calls


def extract_module(source: str, module: str, rel: str,
                   is_pkg: bool = False) -> ModuleInfo:
    """Parse one file into its ModuleInfo (pure in (source, module) —
    the cacheable unit). Facts are seeded afterwards by
    flow/facts.seed_facts so recognizer changes can bust the cache via
    a schema version, not a source hash."""
    mi = ModuleInfo(module=module, rel=rel)
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        mi.parse_error = f"{e.msg} (line {e.lineno})"
        return mi

    bindings = _Bindings(module, is_pkg)
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            bindings.add_import(node)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
            bindings.names[node.name] = f"{module}.{node.name}"

    module_body: List[ast.stmt] = []
    guard_body: List[ast.stmt] = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            fi = FunctionInfo(node.name, node.lineno)
            _collect_calls(node.body, bindings, None, fi)
            mi.functions[node.name] = fi
        elif isinstance(node, ast.ClassDef):
            for m in node.body:
                if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    q = f"{node.name}.{m.name}"
                    fi = FunctionInfo(q, m.lineno)
                    _collect_calls(m.body, bindings, node.name, fi)
                    mi.functions[q] = fi
        elif _is_main_guard(node):
            guard_body.extend(node.body)
        elif not isinstance(node, (ast.Import, ast.ImportFrom)):
            module_body.append(node)

    if module_body:
        fi = FunctionInfo(MODULE_BODY, 1)
        _collect_calls(module_body, bindings, None, fi)
        if fi.calls:
            mi.functions[MODULE_BODY] = fi
    if guard_body:
        fi = FunctionInfo(MAIN_GUARD, guard_body[0].lineno)
        _collect_calls(guard_body, bindings, None, fi)
        mi.functions[MAIN_GUARD] = fi
    return mi


class Project:
    """The linked whole-program view: modules by name plus a resolver
    from dotted call targets to FunctionInfo nodes."""

    def __init__(self, modules: Dict[str, ModuleInfo]) -> None:
        self.modules = modules
        # fqn ('module::qualname') -> (ModuleInfo, FunctionInfo)
        self.nodes: Dict[str, Tuple[ModuleInfo, FunctionInfo]] = {}
        # module name -> conc.extract.ConcInfo, attached by
        # dataflow.build_cached_project (empty when built uncached)
        self.conc: Dict[str, object] = {}
        for mi in modules.values():
            for fi in mi.functions.values():
                self.nodes[f"{mi.module}::{fi.qualname}"] = (mi, fi)

    def resolve_target(self, target: str) -> Optional[str]:
        """Map a dotted target to a node fqn, trying every module/
        qualname split from the right; a class target maps to its
        __init__ when one exists."""
        if not target or "." not in target:
            return None
        parts = target.split(".")
        for i in range(len(parts) - 1, 0, -1):
            mod, rest = ".".join(parts[:i]), ".".join(parts[i:])
            if mod not in self.modules:
                continue
            fqn = f"{mod}::{rest}"
            if fqn in self.nodes:
                return fqn
            init = f"{mod}::{rest}.__init__"
            if init in self.nodes:
                return init
            return None
        return None

    def entries(self) -> List[str]:
        """Entry-point nodes: every __main__ guard body."""
        return sorted(fqn for fqn, (mi, fi) in self.nodes.items()
                      if fi.qualname == MAIN_GUARD)
