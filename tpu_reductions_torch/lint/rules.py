"""The port lint's per-file rules: one AST walk per file.

The counterpart of tpu_reductions/lint/rules.py, spelled in torch and
CUDA terms. Each rule whose reason still holds on a local H100 carries
over under its JAX id; docs/PORT.md ("The lint on the port") maps every
id to its reason and says why RED001, RED004, RED007 and RED008 do not
carry and why RED003 folds into RED015. The waiver machinery (RED000,
RED009) lives in lint/engine.py, the interprocedural rules in lint/flow/
and lint/conc/.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from typing import List, Optional, Sequence

from tpu_reductions_torch.lint import grammar


@dataclass(frozen=True)
class RawFinding:
    """A pre-waiver finding: (rule, line, message); the engine attaches
    the path and applies waivers."""
    rule: str
    line: int
    message: str


# Module whitelists, matched as posix-path suffixes. Each names the one
# home of a pattern: the rule is "do it through the module that does it
# safely", not "never do it".
TIMING_WHITELIST = ("ops/chain.py", "utils/timing.py", "utils/calibrate.py",
                    "utils/debug.py")
GRAMMAR_WHITELIST = ("lint/grammar.py",)
JSONIO_WHITELIST = ("utils/jsonio.py",)
OBS_WHITELIST = ("obs/ledger.py",)
# RED012 polices the packages where event-shaped lines would otherwise
# leak out as prints
OBS_SCOPE_DIRS = ("utils", "bench", "obs", "faults", "serve", "sched")
# RED012's compile-timing trigger is legal only in the observatory and
# the warming pass's own report
COMPILE_TIMING_WHITELIST = ("obs/ledger.py", "obs/compile.py",
                            "bench/warm.py")
# RED012's trace trigger: obs/trace.py mints the trace/span/parent ids
TRACE_FIELD_WHITELIST = ("obs/trace.py", "obs/ledger.py",
                         "obs/spans.py", "obs/compile.py")
# RED013: wall-clock budgets live in the scheduler's task registry
SCHED_WHITELIST = ("sched/tasks.py",)
# RED014: serve/'s one device boundary
SERVE_EXECUTOR_WHITELIST = ("serve/executor.py",)
# RED015: the bounded host->device homes, the stager (chunked, pinned)
# and the stream (double-buffered)
STAGE_INGEST_WHITELIST = ("utils/staging.py", "ops/stream.py")
STAGE_INGEST_SCOPE_DIRS = ("ops", "bench", "serve", "utils", "parallel")
# RED016: rank-axis hops live in the collective suite and the reshard
# primitives, where the registry prices them
COLLECTIVES_SCOPE_DIR = "collectives"
RESHARD_PRIMS_WHITELIST = ("reshard/primitives.py",)
# RED025: the resilience contract is declared on a LaunchPlan and run by
# exec/core.run; these are the core and the three homes it builds on
EXEC_CORE_WHITELIST = ("exec/core.py", "utils/heartbeat.py",
                       "utils/retry.py", "obs/compile.py")
_EXEC_FENCED_NAMES = ("retry_device_call", "compile_span",
                      "probe_lower_compile")

# RED006 applies to the measured packages only
CITATION_DIRS = ("ops", "bench")

_WALLCLOCK_ATTRS = {"perf_counter", "monotonic"}

_CITATION_RE = re.compile(r"[\w./-]+:\d+(?:-\d+)?|§\s*\d")
_NO_ANALOG_RE = re.compile(r"no reference analog", re.I)

# ------------------------------------------------- the torch spellings

# torch.cuda calls that ask about the card and queue no work. A local
# card has no relay whose backend init can hang, so a query is not a
# touch: the watchdog's gate runs once the device is known
# (utils/watchdog.py, "maybe_arm(platform) ... once its device is known")
CUDA_QUERIES = {"is_available", "device_count", "get_device_name",
                "get_device_properties", "get_device_capability",
                "current_device", "is_initialized", "get_arch_list"}
# the ctypes wrappers of ops/_cuda.py, each one launch of a kernel, and
# the loaders of the nvcc-built library
KERNEL_WRAPPERS = {"k6_reduce", "k7_reduce", "k8_reduce", "k9_reduce",
                   "k10_reduce", "dd_reduce"}
KERNEL_LOADERS = {"build", "library"}
# torch.distributed's data calls: each moves a payload between ranks
DIST_DATA_CALLS = {"all_reduce", "all_gather", "all_gather_into_tensor",
                   "all_gather_object", "reduce_scatter",
                   "reduce_scatter_tensor", "all_to_all",
                   "all_to_all_single", "broadcast",
                   "broadcast_object_list", "reduce", "scatter", "gather",
                   "send", "recv", "isend", "irecv", "batch_isend_irecv"}
# the rank-axis hop helpers of collectives/ (rings.py, core.py), and the
# JAX package's redistribution names, which the port keeps as helpers
HOP_HELPERS = {"ppermute", "ring_rs_ag", "ring_rs_ag_stateful",
               "ring_all_to_all", "naive_accumulate", "all_gather",
               "all_to_all", "psum_scatter"}
# the host->device constructors RED015 reads when given a device=
INGEST_CTORS = {"torch.tensor", "torch.as_tensor", "torch.asarray"}
# the staging helpers RED014 fences in serve/
STAGING_CALLS = {"device_put_chunked", "maybe_chunked_stage",
                 "ChunkStager"}
# the gates an entry point runs before its first device touch
GATE_NAMES = {"maybe_arm", "run_preflight", "gate_verdict"}

_DEVICE_NAME_RE = re.compile(r"(?:^|_)dev(?:ice)?$")


def _suffix_match(rel_posix: str, whitelist: Sequence[str]) -> bool:
    return any(rel_posix.endswith(w) for w in whitelist)


def _attr_chain(node: ast.AST) -> str:
    """Dotted name of an attribute/name chain ('torch.cuda.synchronize');
    empty string for anything dynamic."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def device_like(node: Optional[ast.AST]) -> bool:
    """Whether an expression spells a card device: a "cuda..." string, a
    torch.device(...) call, or a name whose last part is `device`/`dev`
    (`device`, `self.device`, `mesh.device`, `x.device`, `dev`). Pure
    spelling: `x.to(x.device)` reads as a move, whose waiver then says
    it is device to device."""
    if node is None:
        return False
    s = _const_str(node)
    if s is not None:
        return s.startswith("cuda")
    if isinstance(node, ast.Call):
        return _attr_chain(node.func).rsplit(".", 1)[-1] == "device"
    chain = _attr_chain(node)
    return bool(chain) and bool(
        _DEVICE_NAME_RE.search(chain.rsplit(".", 1)[-1].lower()))


def device_move(call: ast.Call) -> bool:
    """`.cuda(...)`, or `.to(...)` whose first argument or device= is a
    card device (device_like): the spellings of a copy onto the card."""
    if not isinstance(call.func, ast.Attribute):
        return False
    if call.func.attr == "cuda":
        return True
    if call.func.attr != "to":
        return False
    first = call.args[0] if call.args else None
    kw = next((k.value for k in call.keywords if k.arg == "device"), None)
    return device_like(first) or device_like(kw)


def device_arg(call: ast.Call) -> str:
    """How a call passes a card device: "move" for a device_move, "arg"
    for any other call given a card device= (torch.tensor(...,
    device=dev), torch.zeros(..., device=dev)), "" for none."""
    if device_move(call):
        return "move"
    kw = next((k.value for k in call.keywords if k.arg == "device"), None)
    return "arg" if device_like(kw) else ""


def device_ingest(call: ast.Call) -> bool:
    """RED015's spellings: a device move, or torch.tensor/as_tensor/
    asarray given a card device=."""
    kind = device_arg(call)
    return kind == "move" or (
        kind == "arg" and _attr_chain(call.func) in INGEST_CTORS)


class _FileContext:
    """Per-file AST facts shared by the rules: docstring node ids,
    regex-consumer literal ids, import aliases."""

    def __init__(self, tree: ast.Module) -> None:
        self.tree = tree
        self.docstrings = set()
        self.regex_args = set()
        self.time_aliases = set()     # names bound to time.perf_counter etc.
        self.dist_aliases = set()     # names bound to torch.distributed
        self.dist_names = set()       # data calls imported by name
        # one walk, shared by every rule
        self.nodes = list(ast.walk(tree))
        for node in self.nodes:
            if isinstance(node, (ast.Module, ast.FunctionDef,
                                 ast.AsyncFunctionDef, ast.ClassDef)):
                body = node.body
                if body and isinstance(body[0], ast.Expr) \
                        and _const_str(body[0].value) is not None:
                    self.docstrings.add(id(body[0].value))
            if isinstance(node, ast.Call):
                chain = _attr_chain(node.func)
                if chain.startswith("re.") or chain.endswith(".compile"):
                    # consumer-side patterns (re.compile(r"...")) quote
                    # the grammars to PARSE them — not emission sites
                    for a in ast.walk(node):
                        self.regex_args.add(id(a))
            if isinstance(node, ast.Import):
                for n in node.names:
                    if n.name == "torch.distributed" and n.asname:
                        self.dist_aliases.add(n.asname)
            if isinstance(node, ast.ImportFrom):
                mod = node.module or ""
                if mod == "time":
                    for n in node.names:
                        if n.name in _WALLCLOCK_ATTRS:
                            self.time_aliases.add(n.asname or n.name)
                if mod == "torch":
                    for n in node.names:
                        if n.name == "distributed":
                            self.dist_aliases.add(n.asname or n.name)
                if mod == "torch.distributed":
                    for n in node.names:
                        if n.name in DIST_DATA_CALLS:
                            self.dist_names.add(n.asname or n.name)

    def dist_call(self, node: ast.Call) -> str:
        """The torch.distributed data call this is ('' if none)."""
        chain = _attr_chain(node.func)
        if not chain:
            return ""
        owner, _, last = chain.rpartition(".")
        if last not in DIST_DATA_CALLS and chain not in self.dist_names:
            return ""
        if owner in ("torch.distributed",) or owner in self.dist_aliases:
            return last
        if not owner and chain in self.dist_names:
            return chain
        return ""


def _is_wallclock(node: ast.Call, ctx: _FileContext) -> bool:
    chain = _attr_chain(node.func)
    if chain in ("time.perf_counter", "time.monotonic"):
        return True
    return isinstance(node.func, ast.Name) and \
        node.func.id in ctx.time_aliases


def _is_sync(node: ast.Call) -> bool:
    """torch.cuda.synchronize, device.synchronize, Event/Stream
    .synchronize(): every spelling of a host wait on the card."""
    return isinstance(node.func, ast.Attribute) and \
        node.func.attr == "synchronize"


def _cuda_touch(chain: str) -> bool:
    """A torch.cuda call other than a query."""
    if not chain.startswith("torch.cuda."):
        return False
    return chain.rsplit(".", 1)[-1] not in CUDA_QUERIES


def check_python(rel_posix: str, source: str) -> List[RawFinding]:
    """Run the per-file rules over one Python source file. `rel_posix` is
    the file's path with posix separators (whitelists match on suffixes,
    so absolute tmp-dir fixture paths work too)."""
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [RawFinding("RED???", e.lineno or 1,
                           f"file does not parse: {e.msg}")]
    ctx = _FileContext(tree)
    out: List[RawFinding] = []
    out += _red002(rel_posix, ctx)
    out += _red005(rel_posix, ctx)
    out += _red006(rel_posix, ctx)
    out += _red010(rel_posix, ctx)
    out += _red011(rel_posix, ctx)
    out += _red012(rel_posix, ctx)
    out += _red013(rel_posix, ctx)
    out += _red014(rel_posix, ctx)
    out += _red015(rel_posix, ctx)
    out += _red016(rel_posix, ctx)
    out += _red025(rel_posix, ctx)
    # nested timing scopes can double-report the same call site
    return sorted(set(out), key=lambda f: (f.line, f.rule, f.message))


# --------------------------------------------------------------------------
# RED002 — wall-clock timing beside a host wait on the card, outside the
# timing homes. A measured time of the port comes from utils/timing.py
# (CUDA events and the chained slope through ops/chain.py's graph):
# perf_counter around torch.cuda.synchronize adds the launch, the
# Python and the host's jitter to the card's time, and a number taken so
# is not comparable with the rows beside it. Sites that time host
# seconds on purpose carry a waiver saying what they time.
# --------------------------------------------------------------------------

def _red002(rel: str, ctx: _FileContext) -> List[RawFinding]:
    if _suffix_match(rel, TIMING_WHITELIST):
        return []
    if not any(isinstance(n, ast.Call) and _is_sync(n) for n in ctx.nodes):
        return []
    out = []
    # scope = a def (nested defs included via ast.walk: a closure timing
    # a sync it closes over is the same pattern)
    for fn in ctx.nodes:
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        calls = [n for n in ast.walk(fn) if isinstance(n, ast.Call)]
        if not any(_is_sync(c) for c in calls):
            continue
        for c in calls:
            if _is_wallclock(c, ctx):
                out.append(RawFinding(
                    "RED002", c.lineno,
                    "wall-clock timing beside a card synchronize — the "
                    "host clock adds launch, Python and host jitter to "
                    "the card's time; take measured times from "
                    "utils/timing.py (CUDA events, the chained slope of "
                    "ops/chain.py), or waive saying what host seconds "
                    "this times"))
    return out


# --------------------------------------------------------------------------
# RED005 — output-row grammar conformance. Downstream tooling greps the
# exact &&&& / throughput / collective-row literals; an emitted literal
# that resembles a grammar but deviates is a silent pipeline break. The
# spec lives in lint/grammar.py and the producers import it.
# --------------------------------------------------------------------------

def _literal_text(node: ast.AST) -> Optional[str]:
    """The static text of a string constant or f-string, interpolations
    replaced by grammar.PLACEHOLDER."""
    s = _const_str(node)
    if s is not None:
        return s
    if isinstance(node, ast.JoinedStr):
        parts = []
        for v in node.values:
            c = _const_str(v)
            parts.append(c if c is not None else grammar.PLACEHOLDER)
        return "".join(parts)
    return None


def _red005(rel: str, ctx: _FileContext) -> List[RawFinding]:
    if _suffix_match(rel, GRAMMAR_WHITELIST):
        return []
    # constants INSIDE an f-string are judged as part of the whole
    # JoinedStr, never standalone
    fstring_parts = {id(v) for n in ctx.nodes
                     if isinstance(n, ast.JoinedStr) for v in n.values}
    out = []
    for node in ctx.nodes:
        if id(node) in ctx.docstrings or id(node) in ctx.regex_args \
                or id(node) in fstring_parts:
            continue
        if not isinstance(node, (ast.JoinedStr, ast.Constant)):
            continue
        text = _literal_text(node)
        if text is None:
            continue
        msg = grammar.check_literal(text)
        if msg:
            out.append(RawFinding("RED005", node.lineno, msg))
    return out


# --------------------------------------------------------------------------
# RED006 — public docstrings in ops/ and bench/ cite the JAX or reference
# file:line they re-create, or say "no reference analog".
# --------------------------------------------------------------------------

def _in_citation_dirs(rel: str) -> bool:
    parts = rel.split("/")
    return any(p in CITATION_DIRS for p in parts[:-1])


def _red006(rel: str, ctx: _FileContext) -> List[RawFinding]:
    if not _in_citation_dirs(rel):
        return []
    out = []

    def check_doc(node, kind: str, name: str) -> None:
        doc = ast.get_docstring(node, clean=False)
        if doc is None:
            out.append(RawFinding(
                "RED006", getattr(node, "lineno", 1),
                f"public {kind} '{name}' in a measured package has no "
                "docstring — cite the JAX or reference file:line it "
                "re-creates or state 'no reference analog'"))
        elif not (_CITATION_RE.search(doc) or _NO_ANALOG_RE.search(doc)):
            out.append(RawFinding(
                "RED006", getattr(node, "lineno", 1),
                f"public {kind} '{name}' docstring lacks a citation "
                "(file:line / SURVEY.md §N) and does not state "
                "'no reference analog'"))

    check_doc(ctx.tree, "module", rel.rsplit("/", 1)[-1])
    for node in ctx.tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)) and \
                not node.name.startswith("_"):
            check_doc(node, "def" if not isinstance(node, ast.ClassDef)
                      else "class", node.name)
            if isinstance(node, ast.ClassDef):
                for m in node.body:
                    if isinstance(m, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)) and \
                            not m.name.startswith("_"):
                        check_doc(m, "method", f"{node.name}.{m.name}")
    return out


# --------------------------------------------------------------------------
# RED010 — raw JSON artifact writes outside utils/jsonio.py. A watchdog
# os._exit or a SIGKILL can land mid-write: a truncating json.dump or
# write_text(json.dumps(...)) destroys the artifact it was updating.
# Inside serve/ the fence widens to any write-mode open() and any
# .write_text/.write_bytes: the fleet journal and the port files must
# survive a controller killed mid-write. serve/ is matched as a path part
# (the JAX rule's literal "tpu_reductions/serve/" is not a substring of
# "tpu_reductions_torch/serve/").
# --------------------------------------------------------------------------

_SERVE_STATE_PART = "serve"


def _open_write_mode(node: ast.Call) -> bool:
    """Whether this is an `open(...)` call with a literal w/a/x/+
    mode (positional arg 1 or mode= keyword). Unknown/dynamic modes
    stay unflagged: the rule fences spellings, not possibilities."""
    if _attr_chain(node.func) != "open":
        return False
    mode = None
    if len(node.args) >= 2:
        mode = node.args[1]
    for kw in node.keywords:
        if kw.arg == "mode":
            mode = kw.value
    if mode is None or not isinstance(mode, ast.Constant) \
            or not isinstance(mode.value, str):
        return False
    return any(c in mode.value for c in "wax+")


def _red010(rel: str, ctx: _FileContext) -> List[RawFinding]:
    if _suffix_match(rel, JSONIO_WHITELIST):
        return []
    in_serve = _SERVE_STATE_PART in rel.split("/")[:-1]
    out = []
    for node in ctx.nodes:
        if not isinstance(node, ast.Call):
            continue
        if in_serve:
            if _open_write_mode(node):
                out.append(RawFinding(
                    "RED010", node.lineno,
                    "write-mode open() in serve/ — control-plane "
                    "state must survive a SIGKILL-class controller "
                    "death mid-write; persist via utils.jsonio."
                    "atomic_json_dump / atomic_text_dump"))
                continue
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr in ("write_text", "write_bytes"):
                out.append(RawFinding(
                    "RED010", node.lineno,
                    f"{node.func.attr}() in serve/ — control-plane "
                    "state must survive a SIGKILL-class controller "
                    "death mid-write; persist via utils.jsonio."
                    "atomic_json_dump / atomic_text_dump"))
                continue
        chain = _attr_chain(node.func)
        if chain == "json.dump" or chain.endswith(".json.dump"):
            out.append(RawFinding(
                "RED010", node.lineno,
                "raw json.dump of an artifact file — a kill mid-write "
                "truncates it; use utils.jsonio.atomic_json_dump "
                "(temp+fsync+rename)"))
        elif isinstance(node.func, ast.Attribute) and \
                node.func.attr == "write_text":
            dumps_inside = any(
                isinstance(sub, ast.Call)
                and _attr_chain(sub.func).endswith("json.dumps")
                for a in list(node.args)
                + [kw.value for kw in node.keywords]
                for sub in ast.walk(a))
            if dumps_inside:
                out.append(RawFinding(
                    "RED010", node.lineno,
                    "write_text(json.dumps(...)) of an artifact file — "
                    "an in-place truncating write destroys the rows "
                    "persisted so far; use utils.jsonio."
                    "atomic_json_dump or bench/resume.store_cell"))
    return out


# --------------------------------------------------------------------------
# RED011 — a device touch in a bench/ entry point's `main` before its
# gate. The watchdog must be armed before the first dispatch, or a kernel
# that hangs in its first synchronize is never ended (exit 4): a
# torch.cuda dispatch, a .cuda()/.to(<device>) copy or a kernel wrapper
# comes after maybe_arm / run_preflight / gate_verdict. Queries
# (torch.cuda.is_available, device_count, get_device_name,
# device.resolve) are not touches: the gate is armed once the device is
# known, and a local card has no relay whose backend init can hang.
# Helpers are out of scope: their callers gate (RED017 follows them).
# --------------------------------------------------------------------------

def _touch_name(node: ast.Call) -> str:
    """The device touch this call is, '' if none (RED011, RED014)."""
    chain = _attr_chain(node.func)
    if _cuda_touch(chain):
        return chain
    if device_move(node):
        return f".{node.func.attr}()"
    last = chain.rsplit(".", 1)[-1]
    if last in KERNEL_WRAPPERS:
        return chain
    if last in KERNEL_LOADERS and "_cuda" in chain:
        return chain
    return ""


def _red011(rel: str, ctx: _FileContext) -> List[RawFinding]:
    parts = rel.split("/")
    if "bench" not in parts[:-1]:
        return []
    out = []
    for fn in ctx.tree.body:
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                or fn.name != "main":
            continue
        gate_line = None
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                name = _attr_chain(node.func).rsplit(".", 1)[-1]
                if name in GATE_NAMES and (gate_line is None
                                           or node.lineno < gate_line):
                    gate_line = node.lineno
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            what = _touch_name(node)
            if what and (gate_line is None or node.lineno < gate_line):
                out.append(RawFinding(
                    "RED011", node.lineno,
                    f"{what} in a bench entry point's main before its "
                    "gate — a kernel hung in its first synchronize is "
                    "never ended unless the watchdog is armed; call "
                    "utils.watchdog.maybe_arm (or the utils.preflight "
                    "gate) BEFORE the first device touch"))
    return out


# --------------------------------------------------------------------------
# RED013 — hardcoded wall-clock budgets outside the scheduler's task
# registry (sched/tasks.py). The window plan is the scheduler's job
# (value per expected second against learned priors); a literal budget
# anywhere else is a second, drifting copy of the plan.
# --------------------------------------------------------------------------

_BUDGET_KEYWORDS = {"budget", "budget_s", "budget_seconds"}


def _numeric_literal(node: ast.AST) -> bool:
    """A compile-time numeric expression: 300, 3.5, -2, 10 * 60."""
    if isinstance(node, ast.Constant):
        return isinstance(node.value, (int, float)) \
            and not isinstance(node.value, bool)
    if isinstance(node, ast.UnaryOp):
        return _numeric_literal(node.operand)
    if isinstance(node, ast.BinOp):
        return _numeric_literal(node.left) and _numeric_literal(node.right)
    return False


def _red013(rel: str, ctx: _FileContext) -> List[RawFinding]:
    if _suffix_match(rel, SCHED_WHITELIST):
        return []
    out = []
    msg = ("hardcoded wall-clock budget outside the scheduler registry "
           "(sched/tasks.py) — a static budget is a second, drifting "
           "copy of the plan; route it through python -m "
           "tpu_reductions_torch.sched, or waive saying why this "
           "budget is not a plan's")
    for node in ctx.nodes:
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            value = node.value
            if value is None or not _numeric_literal(value):
                continue
            for t in targets:
                if isinstance(t, ast.Name) and "budget" in t.id.lower():
                    out.append(RawFinding("RED013", node.lineno, msg))
        if isinstance(node, ast.Call):
            for kw in node.keywords:
                if kw.arg and kw.arg.lower() in _BUDGET_KEYWORDS \
                        and _numeric_literal(kw.value):
                    out.append(RawFinding("RED013", node.lineno, msg))
    return out


# --------------------------------------------------------------------------
# RED014 — device work in serve/ outside serve/executor.py. The engine's
# contract (bounded queue, per-request deadlines, shed-not-hang) holds
# only if every launch flows through the admission-controlled executor,
# which carries the heartbeat and retry wrapping. A torch.cuda dispatch,
# a .cuda()/.to(<device>) copy, a torch.distributed data call, a kernel
# wrapper, run_benchmark* or a staging helper anywhere else in serve/
# bypasses all three. Queries are exempt as in RED011 (the router's
# device.resolve asks which card, it launches nothing); the executor
# object's run_batch/run_stream/run_sharded methods are that path and
# stay callable.
# --------------------------------------------------------------------------

_SERVE_DEVICE_CALLS = {"run_benchmark", "run_benchmark_batch"} \
    | STAGING_CALLS


def _red014(rel: str, ctx: _FileContext) -> List[RawFinding]:
    parts = rel.split("/")
    if "serve" not in parts[:-1] or \
            _suffix_match(rel, SERVE_EXECUTOR_WHITELIST):
        return []
    out = []
    msg = ("device work inside serve/ outside serve/executor.py — all "
           "launches must flow through the admission-controlled "
           "executor path (bounded queue, deadlines, retry/heartbeat)")
    for node in ctx.nodes:
        if not isinstance(node, ast.Call):
            continue
        what = _touch_name(node) or ctx.dist_call(node)
        if not what:
            name = _attr_chain(node.func).rsplit(".", 1)[-1]
            what = name if name in _SERVE_DEVICE_CALLS else ""
        if what:
            out.append(RawFinding("RED014", node.lineno,
                                  f"{what}: {msg}"))
    return out


# --------------------------------------------------------------------------
# RED015 — one-shot host->device copies in the measured packages outside
# the bounded homes (utils/staging.py, ops/stream.py). A bare
# .to(<device>) or .cuda() of a host payload is one synchronous copy from
# pageable memory that needs the whole payload's device buffer at once;
# the stager copies in bounded pinned chunks and the stream overlaps them
# with the fold. A device-to-device .to, or a small fixture, carries a
# waiver naming its size bound. This also holds RED003's fence (the JAX
# package's device_put): on the card one host->device fence serves both.
# --------------------------------------------------------------------------

def _red015(rel: str, ctx: _FileContext) -> List[RawFinding]:
    if _suffix_match(rel, STAGE_INGEST_WHITELIST):
        return []
    parts = rel.split("/")
    if not (set(STAGE_INGEST_SCOPE_DIRS) & set(parts[:-1])):
        return []
    out = []
    for node in ctx.nodes:
        if isinstance(node, ast.Call) and device_ingest(node):
            what = _attr_chain(node.func) or f".{node.func.attr}"
            out.append(RawFinding(
                "RED015", node.lineno,
                f"{what}(<device>) outside utils/staging.py / "
                "ops/stream.py — a one-shot host->device copy is "
                "unbounded and synchronous; route a payload through "
                "utils.staging (bounded pinned chunks) or ops/stream.py, "
                "or waive with the reason: device to device, or the "
                "fixture's size bound"))
    return out


# --------------------------------------------------------------------------
# RED016 — rank-axis hops outside the collective suite and the reshard
# primitives. Every hop (a torch.distributed data call, or one of
# collectives/' ring helpers) belongs where the algorithm registry
# (collectives/algorithms.py) declares its wire factor and step count and
# the reshard planner its peak-memory factor; a hop spelled anywhere else
# is invisible to the selector, the curves and the busbw accounting.
# Process-group lifecycle (init_process_group, get_rank, barrier,
# destroy_process_group) is not a hop.
# --------------------------------------------------------------------------

def _red016(rel: str, ctx: _FileContext) -> List[RawFinding]:
    parts = rel.split("/")
    if COLLECTIVES_SCOPE_DIR in parts[:-1]:
        return []
    if _suffix_match(rel, RESHARD_PRIMS_WHITELIST):
        return []
    msg = ("outside collectives/ and reshard/primitives.py — rank-axis "
           "hops belong there, where the algorithm registry "
           "(collectives/algorithms.py) declares their wire cost and "
           "the reshard planner its peak-memory factor; build on "
           "make_topology_all_reduce / ring_rs_ag / reshard's "
           "primitives, or waive with the reason the registry cannot "
           "express this pattern")
    out = []
    for node in ctx.nodes:
        if isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            if mod == "torch.distributed" or mod.endswith("collectives.rings"):
                names = DIST_DATA_CALLS if mod == "torch.distributed" \
                    else HOP_HELPERS
                for n in node.names:
                    if n.name in names:
                        out.append(RawFinding(
                            "RED016", node.lineno,
                            f"import of {n.name} {msg}"))
        elif isinstance(node, ast.Call):
            chain = _attr_chain(node.func)
            hop = ctx.dist_call(node) or (
                chain if chain.rsplit(".", 1)[-1] in HOP_HELPERS else "")
            if hop:
                out.append(RawFinding(
                    "RED016", node.lineno, f"{chain}() {msg}"))
    return out


# --------------------------------------------------------------------------
# RED025 — resilience wiring outside the execution core. Heartbeat
# guards, device-retry classification and compile spans are LaunchPlan
# fields run by exec/core.run; a call site that spells them privately
# forks the contract the timeline, the chaos tests and the launch audit
# reason about. Builders use the ctx.guard / ctx.call / ctx.tick surface,
# which this rule does not match; instruments that cannot be a LaunchPlan
# carry a waiver saying why.
# --------------------------------------------------------------------------


def _red025(rel: str, ctx: _FileContext) -> List[RawFinding]:
    if _suffix_match(rel, EXEC_CORE_WHITELIST):
        return []
    msg = ("outside exec/core.py — heartbeat guards, device-retry "
           "classification and compile spans are LaunchPlan contract "
           "fields executed by THE one core (exec.core.run); declare "
           "the plan (heartbeat_phase= / retry= / observe_compile) or "
           "use the builder's ctx.guard/ctx.call, or waive with the "
           "reason this site cannot be a LaunchPlan")
    out = []
    guard_aliases = set()
    for node in ctx.nodes:
        if isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            names = {n.name: (n.asname or n.name) for n in node.names}
            if (mod.endswith("utils.heartbeat") or mod == "heartbeat") \
                    and "guard" in names:
                guard_aliases.add(names["guard"])
                out.append(RawFinding(
                    "RED025", node.lineno,
                    f"import of heartbeat.guard {msg}"))
            for fenced in _EXEC_FENCED_NAMES:
                if fenced in names:
                    out.append(RawFinding(
                        "RED025", node.lineno,
                        f"import of {fenced} {msg}"))
    for node in ctx.nodes:
        if not isinstance(node, ast.Call):
            continue
        chain = _attr_chain(node.func)
        if chain.endswith("heartbeat.guard") or \
                (isinstance(node.func, ast.Name)
                 and node.func.id in guard_aliases):
            out.append(RawFinding(
                "RED025", node.lineno, f"{chain or 'guard'}() {msg}"))
        elif chain and chain.rsplit(".", 1)[-1] in _EXEC_FENCED_NAMES:
            out.append(RawFinding(
                "RED025", node.lineno, f"{chain}() {msg}"))
    return out


# --------------------------------------------------------------------------
# RED012 — ad-hoc emission of flight-recorder event rows. The row schema
# ({"t": ..., "ev": ..., "pid": ...}; lint/grammar.py EVENT_ROW_RE) is
# machine-parsed by the timeline; an event-shaped line printed or written
# anywhere but obs/ledger.py bypasses its single-write append + fsync, so
# a kill can tear it. Also: a compile duration narrated in a print
# outside obs/compile.py and bench/warm.py, and literal trace=/span=/
# parent= emit keywords outside obs/ (obs/trace.py mints those ids).
# --------------------------------------------------------------------------

def _red012(rel: str, ctx: _FileContext) -> List[RawFinding]:
    if _suffix_match(rel, OBS_WHITELIST):
        return []
    parts = rel.split("/")
    if not (set(OBS_SCOPE_DIRS) & set(parts[:-1])):
        return []
    out = []
    for node in ctx.nodes:
        if not isinstance(node, ast.Call):
            continue
        chain = _attr_chain(node.func)
        # trace extension: emit kwargs named after grammar.TRACE_FIELDS
        # outside the trace module mint ad-hoc span identity
        if chain.rsplit(".", 1)[-1] == "emit" and \
                not _suffix_match(rel, TRACE_FIELD_WHITELIST):
            minted = sorted(kw.arg for kw in node.keywords
                            if kw.arg in grammar.TRACE_FIELDS)
            if minted:
                out.append(RawFinding(
                    "RED012", node.lineno,
                    f"ad-hoc trace identity ({', '.join(minted)}=) "
                    "minted outside obs/ — span/trace ids are "
                    "contextvar-scoped (obs/trace.py): nest with "
                    "obs.spans.span / trace.child(), stamp "
                    "per-request traces via "
                    "**trace.request_fields(rid)"))
        is_print = chain == "print"
        is_write = isinstance(node.func, ast.Attribute) and \
            node.func.attr in ("write", "write_text")
        if not (is_print or is_write):
            continue
        for a in list(node.args) + [kw.value for kw in node.keywords]:
            text = _literal_text(a)
            if text is None:
                continue
            if grammar.looks_like_event(text):
                out.append(RawFinding(
                    "RED012", node.lineno,
                    "event-shaped line emitted outside obs/ledger — "
                    "ad-hoc prints/writes bypass the crash-safe "
                    "single-write append (torn lines break the "
                    "timeline); route through "
                    "tpu_reductions_torch.obs.ledger.emit"))
            elif grammar.looks_like_compile_timing(text) and \
                    not _suffix_match(rel, COMPILE_TIMING_WHITELIST):
                out.append(RawFinding(
                    "RED012", node.lineno,
                    "ad-hoc compile-timing print — compile durations "
                    "are typed observations (compile.start/end, "
                    "lint/grammar.py COMPILE_EVENTS); bracket the "
                    "build with tpu_reductions_torch.obs.compile."
                    "compile_span so the verdict lands in the ledger "
                    "and the per-surface table, not in a log line"))
    return out

