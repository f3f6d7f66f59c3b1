"""Per-file concurrency-fact extraction for the port lint's conc layer
(the counterpart of tpu_reductions/lint/conc/extract.py).

One AST pass per file produces a serializable `ConcInfo` that mirrors
the flow layer's function decomposition exactly (flow/callgraph.py:
top-level defs, `Cls.method`, the ``<module>`` body and the
``__main__`` guard as pseudo-functions, nested defs/lambdas folded
into their enclosing function) so the analysis (conc/analysis.py) can
join conc facts against the call graph by qualname.

Per module it records:

* **lock definitions** — ``X = threading.Lock()/RLock()/Condition()``
  at module level (``module.X``), ``self.X = ...`` in a method
  (``module.Cls.X``), or a function-local binding (``module.X`` — the
  per-function distinction is deliberately collapsed; see
  docs/PORT.md, "Mechanics and limits");
* **spawn sites** — ``threading.Thread(target=...)``,
  ``threading.Timer(interval, fn)``, ``executor.submit(fn, ...)`` —
  with the target chain canonicalized, the daemon flag (constructor
  kwarg, a later ``t.daemon = ...`` assignment, or ``setDaemon``), and
  what the thread object was assigned to (for join matching);
* **acquisitions** — ``with lock:`` items (lexical extent =
  the ``with`` block) and explicit ``.acquire()`` calls (extent to the
  next ``.release()`` on the same chain, else end of function);
* **shared-state writes** — assignments/augmented assignments,
  subscript stores and container-mutator calls whose base is a
  ``self.`` attribute, a module-level global, or a ``global``-declared
  name. Locals never escape the thread and are skipped;
* **blocking sites** — socket ``recv/recv_into/recvfrom/accept``,
  ``future.result()`` / ``queue.get()`` / ``thread.join()`` /
  ``.wait()`` / ``.communicate()`` without a timeout,
  ``select.select`` and ``time.sleep`` — RED023's object (device
  syncs come from the flow layer's facts at analysis time);
* **joins** — every ``X.join(...)`` chain (timeout or not), RED024's
  evidence that a spawned thread is reaped on some stop path;
* **handler roots** — classes subclassing a socketserver request
  handler: their ``handle`` method runs per-connection on a server
  thread.

Like `flow/callgraph.extract_module`, `extract_conc` is pure in
(source, module) so the content-hash fact cache can store its result;
`CONC_SCHEMA_VERSION` participates in the cache version stamp so a
recognizer change invalidates cached facts.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from tpu_reductions_torch.lint.flow.callgraph import (MAIN_GUARD, MODULE_BODY,
                                                      _attr_chain, _Bindings,
                                                      _is_main_guard)

# bump to invalidate cached per-file conc facts when recognizers change
CONC_SCHEMA_VERSION = 1

_LOCK_CTORS = {"threading.Lock", "threading.RLock", "threading.Condition"}
_THREAD_CTORS = {"threading.Thread", "Thread"}
_TIMER_CTORS = {"threading.Timer", "Timer"}
_HANDLER_BASES = {"BaseRequestHandler", "StreamRequestHandler",
                  "DatagramRequestHandler"}
_SOCKET_BLOCK = {"recv", "recv_into", "recvfrom", "accept"}
_TIMEOUT_BLOCK = {"result", "wait", "communicate", "get", "join"}
_CHAIN_BLOCK = {"select.select", "time.sleep"}
# container mutations that write through a reference (threading.Event's
# internally-locked set() is deliberately absent)
_MUTATORS = {"append", "appendleft", "extend", "extendleft", "add",
             "insert", "remove", "discard", "clear", "pop", "popleft",
             "popitem", "update", "setdefault", "put", "put_nowait",
             "sort", "reverse"}


@dataclass
class ConcFunction:
    """Concurrency facts for one call-graph node (same qualnames as
    flow/callgraph.FunctionInfo)."""
    qualname: str
    spawns: List[dict] = field(default_factory=list)
    acquires: List[dict] = field(default_factory=list)
    writes: List[dict] = field(default_factory=list)
    blocking: List[dict] = field(default_factory=list)
    joins: List[str] = field(default_factory=list)

    def to_dict(self) -> dict:
        return {"qualname": self.qualname, "spawns": self.spawns,
                "acquires": self.acquires, "writes": self.writes,
                "blocking": self.blocking, "joins": self.joins}

    @classmethod
    def from_dict(cls, d: dict) -> "ConcFunction":
        return cls(d["qualname"], list(d["spawns"]), list(d["acquires"]),
                   list(d["writes"]), list(d["blocking"]),
                   list(d["joins"]))


@dataclass
class ConcInfo:
    """Everything the conc analysis needs from one file."""
    module: str
    rel: str
    locks: List[str] = field(default_factory=list)
    functions: Dict[str, ConcFunction] = field(default_factory=dict)
    handler_roots: List[str] = field(default_factory=list)

    def to_dict(self) -> dict:
        return {"module": self.module, "rel": self.rel,
                "locks": self.locks,
                "functions": {k: f.to_dict()
                              for k, f in self.functions.items()},
                "handler_roots": self.handler_roots}

    @classmethod
    def from_dict(cls, d: dict) -> "ConcInfo":
        return cls(d["module"], d["rel"], list(d["locks"]),
                   {k: ConcFunction.from_dict(f)
                    for k, f in d["functions"].items()},
                   list(d["handler_roots"]))


def _canon_ref(chain: str, module: str, cls: Optional[str],
               bindings: _Bindings) -> str:
    """Canonical id for a lock/owner reference chain: ``self.X`` in a
    method of Cls -> ``module.Cls.X`` (first attribute level), an
    import-bound root resolves through the binding, anything else is
    module-prefixed (module globals and function locals collapse —
    documented inference limit)."""
    if not chain:
        return ""
    if chain.startswith("self."):
        if cls is None:
            return ""
        return f"{module}.{cls}.{chain.split('.')[1]}"
    target, resolved = bindings.resolve_chain(chain)
    if resolved:
        return target
    return f"{module}.{chain}"


def _canon_write(node: ast.AST, module: str, cls: Optional[str],
                 func_globals: set, module_globals: set) -> str:
    """Canonical shared-attribute id for one write target, '' when the
    target is thread-local (plain locals, parameters)."""
    while isinstance(node, ast.Subscript):
        node = node.value
    chain = _attr_chain(node)
    if not chain:
        return ""
    if chain.startswith("self."):
        parts = chain.split(".")
        if cls is None or len(parts) < 2:
            return ""
        return f"{module}.{cls}.{parts[1]}"
    root = chain.split(".")[0]
    if root in func_globals or root in module_globals:
        return f"{module}.{root}"
    return ""


def _is_lock_ctor(value: ast.AST, bindings: _Bindings) -> bool:
    if not isinstance(value, ast.Call) or isinstance(value.func, ast.Call):
        return False
    chain = _attr_chain(value.func)
    target, _ = bindings.resolve_chain(chain)
    return target in _LOCK_CTORS or chain in _LOCK_CTORS


def _has_timeout(call: ast.Call) -> bool:
    """A positional arg or a timeout= kwarg bounds the block."""
    if call.args:
        return True
    return any(kw.arg == "timeout" for kw in call.keywords)


def _const_bool(node: Optional[ast.AST]) -> Optional[bool]:
    if isinstance(node, ast.Constant) and isinstance(node.value, bool):
        return node.value
    return None


def _spawn_from_call(call: ast.Call, chain: str, module: str,
                     cls: Optional[str],
                     bindings: _Bindings) -> Optional[dict]:
    """Recognize a thread/timer constructor or an executor submit."""
    target, _ = bindings.resolve_chain(chain)
    last = chain.rsplit(".", 1)[-1]
    if target in _THREAD_CTORS or chain in _THREAD_CTORS:
        tchain = ""
        daemon = None
        for kw in call.keywords:
            if kw.arg == "target":
                tchain = _attr_chain(kw.value)
            elif kw.arg == "daemon":
                daemon = _const_bool(kw.value)
        return {"line": call.lineno, "kind": "thread",
                "target": _canon_ref(tchain, module, cls, bindings),
                "raw": tchain, "daemon": daemon, "assigned": ""}
    if target in _TIMER_CTORS or chain in _TIMER_CTORS:
        tchain = _attr_chain(call.args[1]) if len(call.args) > 1 else ""
        for kw in call.keywords:
            if kw.arg == "function":
                tchain = _attr_chain(kw.value)
        return {"line": call.lineno, "kind": "timer",
                "target": _canon_ref(tchain, module, cls, bindings),
                "raw": tchain, "daemon": None, "assigned": ""}
    if last == "submit" and "." in chain and call.args:
        tchain = _attr_chain(call.args[0])
        if tchain:
            return {"line": call.lineno, "kind": "submit",
                    "target": _canon_ref(tchain, module, cls, bindings),
                    "raw": tchain, "daemon": True, "assigned": ""}
    return None


def _scan_function(body: Sequence[ast.stmt], qual: str, module: str,
                   cls: Optional[str], bindings: _Bindings,
                   module_globals: set, locks: List[str]
                   ) -> ConcFunction:
    cf = ConcFunction(qual)
    func_end = max((getattr(s, "end_lineno", s.lineno) or s.lineno)
                   for s in body) if body else 0
    func_globals: set = set()
    spawn_calls: Dict[int, dict] = {}     # id(Call) -> spawn record
    post_daemon: Dict[str, bool] = {}     # local name -> daemon flag
    releases: List[tuple] = []            # (line, owner chain)

    for stmt in body:
        for sub in ast.walk(stmt):
            if isinstance(sub, ast.Global):
                func_globals.update(sub.names)

    def record_write(target: ast.AST, line: int) -> None:
        # tuple/starred unpack counts once per element: the ledger's
        # `_fd, _path = fd, path` is two shared-state writes, not zero
        if isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                record_write(elt, line)
            return
        if isinstance(target, ast.Starred):
            record_write(target.value, line)
            return
        attr = _canon_write(target, module, cls, func_globals,
                            module_globals)
        if attr:
            cf.writes.append({"line": line, "attr": attr})

    for stmt in body:
        for sub in ast.walk(stmt):
            if isinstance(sub, (ast.With, ast.AsyncWith)):
                end = getattr(sub, "end_lineno", sub.lineno) or sub.lineno
                for item in sub.items:
                    expr = item.context_expr
                    if isinstance(expr, (ast.Name, ast.Attribute)):
                        chain = _attr_chain(expr)
                        ref = _canon_ref(chain, module, cls, bindings)
                        if ref:
                            cf.acquires.append(
                                {"line": sub.lineno, "end": end,
                                 "lock": ref, "raw": chain})
            elif isinstance(sub, ast.Assign):
                if _is_lock_ctor(sub.value, bindings):
                    for tgt in sub.targets:
                        chain = _attr_chain(tgt)
                        ref = _canon_ref(chain, module, cls, bindings)
                        if ref and ref not in locks:
                            locks.append(ref)
                sp = None
                if isinstance(sub.value, ast.Call) and \
                        not isinstance(sub.value.func, ast.Call):
                    vchain = _attr_chain(sub.value.func)
                    sp = _spawn_from_call(sub.value, vchain, module,
                                          cls, bindings) if vchain \
                        else None
                if sp is not None and len(sub.targets) == 1:
                    tchain = _attr_chain(sub.targets[0])
                    sp["assigned"] = tchain
                    spawn_calls[id(sub.value)] = sp
                    cf.spawns.append(sp)
                    continue
                for tgt in sub.targets:
                    # `t.daemon = True` post-construction flag
                    if isinstance(tgt, ast.Attribute) and \
                            tgt.attr == "daemon":
                        owner = _attr_chain(tgt.value)
                        flag = _const_bool(sub.value)
                        if owner and flag is not None:
                            post_daemon[owner] = flag
                        continue
                    record_write(tgt, sub.lineno)
            elif isinstance(sub, ast.AugAssign):
                record_write(sub.target, sub.lineno)
            elif isinstance(sub, ast.AnnAssign):
                if sub.value is not None:
                    if _is_lock_ctor(sub.value, bindings):
                        chain = _attr_chain(sub.target)
                        ref = _canon_ref(chain, module, cls, bindings)
                        if ref and ref not in locks:
                            locks.append(ref)
                    else:
                        record_write(sub.target, sub.lineno)
            elif isinstance(sub, ast.Call):
                if isinstance(sub.func, ast.Call):
                    continue
                chain = _attr_chain(sub.func)
                if not chain:
                    continue
                last = chain.rsplit(".", 1)[-1]
                owner = chain.rsplit(".", 1)[0] if "." in chain else ""
                if id(sub) not in spawn_calls:
                    sp = _spawn_from_call(sub, chain, module, cls,
                                          bindings)
                    if sp is not None:
                        spawn_calls[id(sub)] = sp
                        cf.spawns.append(sp)
                        continue
                if last == "acquire" and owner:
                    ref = _canon_ref(owner, module, cls, bindings)
                    if ref:
                        cf.acquires.append(
                            {"line": sub.lineno, "end": func_end,
                             "lock": ref, "raw": owner})
                    continue
                if last == "release" and owner:
                    releases.append((sub.lineno, owner))
                    continue
                if last == "setDaemon" and owner and sub.args:
                    flag = _const_bool(sub.args[0])
                    if flag is not None:
                        post_daemon[owner] = flag
                    continue
                if last == "join" and owner:
                    cf.joins.append(owner)
                    if not _has_timeout(sub):
                        cf.blocking.append(
                            {"line": sub.lineno, "what": "join",
                             "chain": _canon_ref(owner, module, cls,
                                                 bindings),
                             "raw": chain})
                    continue
                if last in _SOCKET_BLOCK:
                    cf.blocking.append(
                        {"line": sub.lineno, "what": last,
                         "chain": _canon_ref(owner, module, cls,
                                             bindings),
                         "raw": chain})
                elif last in _TIMEOUT_BLOCK and owner and \
                        not _has_timeout(sub):
                    if last == "get" and sub.keywords:
                        continue            # dict.get(k, d) spellings
                    cf.blocking.append(
                        {"line": sub.lineno, "what": last,
                         "chain": _canon_ref(owner, module, cls,
                                             bindings),
                         "raw": chain})
                elif chain in _CHAIN_BLOCK:
                    cf.blocking.append(
                        {"line": sub.lineno, "what": last,
                         "chain": "", "raw": chain})
                elif last in _MUTATORS and owner:
                    attr = _canon_write(sub.func.value, module, cls,
                                        func_globals, module_globals)
                    if attr:
                        cf.writes.append({"line": sub.lineno,
                                          "attr": attr})

    # fold explicit acquire() extents down to their matching release()
    for acq in cf.acquires:
        if acq["end"] != func_end:
            continue                        # with-statement: exact extent
        for line, owner in sorted(releases):
            if owner == acq["raw"] and line >= acq["line"]:
                acq["end"] = line
                break
    for sp in cf.spawns:
        if sp["daemon"] is None and sp["assigned"] in post_daemon:
            sp["daemon"] = post_daemon[sp["assigned"]]
    return cf


def extract_conc(source: str, module: str, rel: str,
                 is_pkg: bool = False) -> ConcInfo:
    """Parse one file into its ConcInfo (pure in (source, module) —
    the cacheable unit, mirroring flow/callgraph.extract_module)."""
    ci = ConcInfo(module=module, rel=rel)
    try:
        tree = ast.parse(source)
    except SyntaxError:
        return ci                           # callgraph reports the error

    bindings = _Bindings(module, is_pkg)
    module_globals: set = set()
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            bindings.add_import(node)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
            bindings.names[node.name] = f"{module}.{node.name}"
        elif isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    module_globals.add(tgt.id)
        elif isinstance(node, ast.AnnAssign) and \
                isinstance(node.target, ast.Name):
            module_globals.add(node.target.id)

    locks: List[str] = []
    module_body: List[ast.stmt] = []
    guard_body: List[ast.stmt] = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            ci.functions[node.name] = _scan_function(
                node.body, node.name, module, None, bindings,
                module_globals, locks)
        elif isinstance(node, ast.ClassDef):
            for b in node.bases:
                chain = _attr_chain(b)
                t, _ = bindings.resolve_chain(chain)
                if (t or chain).rsplit(".", 1)[-1] in _HANDLER_BASES:
                    ci.handler_roots.append(f"{node.name}.handle")
            for m in node.body:
                if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    q = f"{node.name}.{m.name}"
                    ci.functions[q] = _scan_function(
                        m.body, q, module, node.name, bindings,
                        module_globals, locks)
        elif _is_main_guard(node):
            guard_body.extend(node.body)
        elif not isinstance(node, (ast.Import, ast.ImportFrom)):
            module_body.append(node)

    if module_body:
        ci.functions[MODULE_BODY] = _scan_function(
            module_body, MODULE_BODY, module, None, bindings,
            module_globals, locks)
    if guard_body:
        ci.functions[MAIN_GUARD] = _scan_function(
            guard_body, MAIN_GUARD, module, None, bindings,
            module_globals, locks)
    ci.locks = sorted(set(locks))
    ci.handler_roots = sorted(set(ci.handler_roots))
    return ci
