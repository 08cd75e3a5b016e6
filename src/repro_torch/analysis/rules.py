"""svmlint rules: the engine's equivalence contracts as AST checks.

Each rule enforces one invariant from ``docs/contracts.md``:

  * ``opcode-exhaustive``     — every interpreter dispatch site handles
    or explicitly rejects every ``OP_*`` tag (universe derived from
    ``repro_torch/core/engine.py`` itself, so adding e.g. ``OP_KV_GROW``
    flags every stale dispatch chain until it is taught the new op).
  * ``frozen-mutation``       — compiled-trace op columns are immutable
    after `CompiledTrace.freeze`; no subscript store, in-place NumPy
    mutation, or writeable-flag flip outside the freeze path.
  * ``manager-encapsulation`` — runtime-layer modules
    (``repro_torch.svm``, ``repro_torch.launch``) never drive a manager
    op-by-op or reach into its privates; every access is a recorded op
    replayed through `TraceSession`.
  * ``determinism``           — no unseeded RNG, no salted ``hash()``
    feeding a seed, no wall-clock reads in the simulation layers, no
    direct set-order iteration.
  * ``counter-pairing``       — attribution code reads manager counters
    as before/after snapshot *pairs* around a replay; an unpaired read
    breaks per-request conservation against the shared manager.
  * ``bounded-retry``         — a loop that catches an exception and
    re-invokes the same work must reference a bounded attempt budget
    (`repro_torch.ft.retry`); open-ended recovery loops never terminate
    under a persistent fault.
"""

from __future__ import annotations

import ast
import functools
import os
import re

from repro_torch.analysis.core import (
    Finding,
    LintModule,
    Rule,
    attr_chain,
    register_rule,
    walk_functions,
)

_ENGINE_PY = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          os.pardir, "core", "engine.py")


@functools.lru_cache(maxsize=1)
def opcode_universe() -> tuple[frozenset[str], frozenset[str]]:
    """(opcode constant names, trace-op tag strings) parsed from the live
    ``repro_torch/core/engine.py`` — module-level ``OP_* = int`` assignments
    plus the ``OP_TAGS`` table (and the lowering-only ``"kernel"``
    marker).  Parsing the source instead of importing keeps svmlint
    fully static and means a newly added opcode widens the universe
    the moment it is defined."""
    with open(_ENGINE_PY, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=_ENGINE_PY)
    ops: set[str] = set()
    tags: set[str] = {"kernel"}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            tgt = node.targets[0]
            if not isinstance(tgt, ast.Name):
                continue
            if tgt.id.startswith("OP_") and tgt.id != "OP_TAGS" and \
                    isinstance(node.value, ast.Constant) and \
                    isinstance(node.value.value, int):
                ops.add(tgt.id)
            elif tgt.id == "OP_TAGS" and isinstance(node.value, ast.Dict):
                tags.update(k.value for k in node.value.keys
                            if isinstance(k, ast.Constant)
                            and isinstance(k.value, str))
    return frozenset(ops), frozenset(tags)


# ------------------------------------------------------ opcode-exhaustive

def _chain_constants(test: ast.expr, ops: frozenset[str],
                     tags: frozenset[str]) -> tuple[set[str], set[str]]:
    """Opcode names / tag strings an if-branch test compares against."""
    found_ops: set[str] = set()
    found_tags: set[str] = set()

    def scan(expr: ast.expr) -> None:
        if isinstance(expr, ast.BoolOp):
            for v in expr.values:
                scan(v)
            return
        if not isinstance(expr, ast.Compare):
            return
        if not all(isinstance(op, (ast.Eq, ast.In)) for op in expr.ops):
            return
        for comp in expr.comparators:
            items = comp.elts if isinstance(comp,
                                            (ast.Tuple, ast.Set,
                                             ast.List)) else [comp]
            for item in items:
                if isinstance(item, ast.Name) and item.id in ops:
                    found_ops.add(item.id)
                elif isinstance(item, ast.Constant) and item.value in tags:
                    found_tags.add(item.value)

    scan(test)
    return found_ops, found_tags


def _has_rejection(stmts: list[ast.stmt]) -> bool:
    """Does a final else-branch reject (raise) or delegate (call another
    dispatcher) the remaining opcodes?"""
    for stmt in stmts:
        for node in ast.walk(stmt):
            if isinstance(node, (ast.Raise, ast.Call)):
                return True
    return False


@register_rule
class OpcodeExhaustive(Rule):
    name = "opcode-exhaustive"
    doc = ("interpreter dispatch sites must handle or explicitly reject "
           "every OP_* opcode / trace-op tag")
    invariant = ("adding a new op to repro_torch/core/engine.py cannot "
                 "silently fall through any dispatch chain")

    def check(self, mod: LintModule):
        ops, tags = opcode_universe()
        seen: set[int] = set()        # elif-members already consumed
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.If) or id(node) in seen:
                continue
            # collect the full if/elif chain
            chain: list[ast.If] = [node]
            while len(chain[-1].orelse) == 1 and \
                    isinstance(chain[-1].orelse[0], ast.If):
                chain.append(chain[-1].orelse[0])
            for member in chain[1:]:
                seen.add(id(member))
            got_ops: set[str] = set()
            got_tags: set[str] = set()
            for member in chain:
                o, t = _chain_constants(member.test, ops, tags)
                got_ops |= o
                got_tags |= t
            # a dispatch site compares >= 2 universe members
            if len(got_ops) + len(got_tags) < 2:
                continue
            missing = sorted(ops - got_ops) if got_ops \
                else sorted(tags - got_tags)
            if not missing:
                continue
            orelse = chain[-1].orelse
            if orelse and _has_rejection(orelse):
                continue
            yield Finding(
                self.name, mod.path, node.lineno, node.col_offset,
                f"opcode dispatch does not handle {', '.join(missing)} "
                "and has no rejecting/delegating else branch — a new op "
                "would silently fall through")


# -------------------------------------------------------- frozen-mutation

#: CompiledTrace op-column fields (everything `freeze` marks read-only)
COLUMN_FIELDS = ("codes", "rids", "concs", "hints", "fargs", "boundaries",
                 "touch_pos_np", "touch_rid_np", "seg_bounds")

_INPLACE_METHODS = frozenset({"fill", "sort", "put", "partition",
                              "resize", "itemset", "byteswap"})

#: qualnames allowed to flip writeable flags (the freeze path itself)
_FREEZE_QUALNAMES = frozenset({"CompiledTrace.freeze"})


@register_rule
class FrozenMutation(Rule):
    name = "frozen-mutation"
    doc = ("no subscript store / in-place NumPy mutation / writeable-flag "
           "flip on CompiledTrace op columns outside the freeze path")
    invariant = ("frozen trace columns are shared across sweep points, "
                 "sessions, and relocated SegmentCache copies — one "
                 "in-place write corrupts every sharer")

    def check(self, mod: LintModule):
        cols = frozenset(COLUMN_FIELDS)
        qual_of: dict[int, str] = {}
        for fn, q in walk_functions(mod.tree):
            for n in ast.walk(fn):
                qual_of.setdefault(id(n), q)
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for tgt in targets:
                    yield from self._check_store(mod, node, tgt, cols,
                                                 qual_of)
            elif isinstance(node, ast.Call):
                yield from self._check_call(mod, node, cols)

    def _check_store(self, mod, node, tgt, cols, qual_of):
        # ct.codes[i] = ... / ct.rids[m] += ... — in-place column write
        if isinstance(tgt, ast.Subscript) and \
                isinstance(tgt.value, ast.Attribute) and \
                tgt.value.attr in cols:
            yield Finding(
                self.name, mod.path, node.lineno, node.col_offset,
                f"subscript store into compiled-trace column "
                f"'.{tgt.value.attr}' — frozen columns are shared; "
                "build new arrays and dataclasses.replace instead")
        # ct.codes = ... rebinding on a foreign object (self.<col> = ...
        # in a builder's __init__ stays legal)
        elif isinstance(tgt, ast.Attribute) and tgt.attr in cols and \
                not (isinstance(tgt.value, ast.Name)
                     and tgt.value.id == "self"):
            yield Finding(
                self.name, mod.path, node.lineno, node.col_offset,
                f"rebinding compiled-trace column '.{tgt.attr}' on a "
                "shared trace — use CompiledTrace.relocate/copy/"
                "dataclasses.replace")
        # *.flags.writeable = ... anywhere outside CompiledTrace.freeze
        elif isinstance(tgt, ast.Attribute) and tgt.attr == "writeable" \
                and isinstance(tgt.value, ast.Attribute) \
                and tgt.value.attr == "flags":
            qual = qual_of.get(id(node), "")
            if qual not in _FREEZE_QUALNAMES:
                yield Finding(
                    self.name, mod.path, node.lineno, node.col_offset,
                    "writeable-flag flip outside CompiledTrace.freeze — "
                    "un-freezing shared columns breaks the immutability "
                    "contract")

    def _check_call(self, mod, node, cols):
        fn = node.func
        # ct.codes.sort() and friends
        if isinstance(fn, ast.Attribute) and \
                fn.attr in _INPLACE_METHODS and \
                isinstance(fn.value, ast.Attribute) and \
                fn.value.attr in cols:
            yield Finding(
                self.name, mod.path, node.lineno, node.col_offset,
                f"in-place '.{fn.attr}()' on compiled-trace column "
                f"'.{fn.value.attr}'")
        # np.foo(..., out=ct.codes)
        for kw in node.keywords:
            if kw.arg == "out" and isinstance(kw.value, ast.Attribute) \
                    and kw.value.attr in cols:
                yield Finding(
                    self.name, mod.path, node.lineno, node.col_offset,
                    f"NumPy out= targets compiled-trace column "
                    f"'.{kw.value.attr}'")


# -------------------------------------------------- manager-encapsulation

#: op-driving entry points the runtime layer must reach via TraceSession
MANAGER_DRIVE = frozenset({"touch", "advance", "pin", "unpin",
                           "writeback", "spill_oldest", "previct"})

_MANAGER_NAMES = frozenset({"mgr", "manager"})
_MANAGER_CTORS = frozenset({"SVMManager", "UVMManager"})


def _manager_aliases(scope_body: list[ast.stmt]) -> set[str]:
    """Local names bound to a manager: ``m = self.mgr``,
    ``mgr = SVMManager(...)``, ``m = plan.manager(...)``."""
    aliases = set(_MANAGER_NAMES)
    for stmt in scope_body:
        for node in ast.walk(stmt):
            if not isinstance(node, ast.Assign):
                continue
            src = node.value
            is_mgr = False
            if isinstance(src, (ast.Name, ast.Attribute)):
                chain = attr_chain(src)
                is_mgr = chain is not None and \
                    chain.split(".")[-1] in _MANAGER_NAMES
            elif isinstance(src, ast.Call):
                f = src.func
                if isinstance(f, ast.Name):
                    is_mgr = f.id in _MANAGER_CTORS
                elif isinstance(f, ast.Attribute):
                    is_mgr = f.attr in _MANAGER_CTORS or \
                        f.attr == "manager"
            if is_mgr:
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        aliases.add(tgt.id)
    return aliases


def _is_manager_recv(recv: ast.expr, aliases: set[str]) -> bool:
    chain = attr_chain(recv)
    return chain is not None and chain.split(".")[-1] in aliases


@register_rule
class ManagerEncapsulation(Rule):
    name = "manager-encapsulation"
    doc = ("repro_torch.svm / repro_torch.launch never drive a manager "
           "op-by-op or touch its private members; ops go through "
           "TraceSession")
    invariant = ("every runtime-layer manager access is a recorded op "
                 "replayed on the engine, so scalar and batched tiers "
                 "see the identical op stream")
    scope = ("repro_torch.svm", "repro_torch.launch")

    def check(self, mod: LintModule):
        scopes = [(mod.tree, mod.tree.body)]
        scopes += [(fn, fn.body) for fn, _ in walk_functions(mod.tree)]
        checked: set[int] = set()
        for scope_node, body in scopes:
            aliases = _manager_aliases(body)
            for stmt in body:
                for node in ast.walk(stmt):
                    if isinstance(node, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)) and \
                            node is not scope_node:
                        break     # inner scopes handled on their own pass
                    if id(node) in checked:
                        continue
                    if isinstance(node, ast.Call) and \
                            isinstance(node.func, ast.Attribute) and \
                            node.func.attr in MANAGER_DRIVE and \
                            _is_manager_recv(node.func.value, aliases):
                        checked.add(id(node))
                        yield Finding(
                            self.name, mod.path, node.lineno,
                            node.col_offset,
                            f"direct manager drive "
                            f"'.{node.func.attr}()' — record the op on a "
                            "TraceSession and replay it instead")
                    elif isinstance(node, ast.Attribute) and \
                            node.attr.startswith("_") and \
                            not node.attr.startswith("__") and \
                            _is_manager_recv(node.value, aliases):
                        checked.add(id(node))
                        yield Finding(
                            self.name, mod.path, node.lineno,
                            node.col_offset,
                            f"private manager member '.{node.attr}' "
                            "accessed from the runtime layer")


# ------------------------------------------------------------ determinism

_WALLCLOCK = {
    "time": {"time", "time_ns", "monotonic", "monotonic_ns",
             "perf_counter", "perf_counter_ns", "process_time"},
    "datetime": {"now", "utcnow", "today"},
}
_SEEDED_CTORS = frozenset({"default_rng", "SeedSequence", "Generator",
                           "Random"})
_NP_RANDOM_OK = _SEEDED_CTORS | frozenset({"PCG64", "Philox", "SFC64",
                                           "MT19937", "BitGenerator"})


def _is_set_expr(expr: ast.expr) -> bool:
    if isinstance(expr, ast.Set):
        return True
    return (isinstance(expr, ast.Call) and isinstance(expr.func, ast.Name)
            and expr.func.id in ("set", "frozenset"))


@register_rule
class Determinism(Rule):
    name = "determinism"
    doc = ("no unseeded RNG, no salted hash() feeding a seed, no "
           "wall-clock reads in repro_torch.core/repro_torch.svm, no "
           "direct set-order iteration")
    invariant = ("same inputs + same seed => byte-identical traces, "
                 "sweep keys, and schedules, across processes and runs")

    #: wall-clock reads are only forbidden in the simulation layers;
    #: launch/ft measure real host time legitimately
    WALLCLOCK_SCOPE = ("repro_torch.core", "repro_torch.svm",
                       "repro_torch.analysis")

    def check(self, mod: LintModule):
        clock_scoped = any(
            mod.package == s or mod.package.startswith(s + ".")
            for s in self.WALLCLOCK_SCOPE)
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call):
                yield from self._check_call(mod, node, clock_scoped)
            elif isinstance(node, (ast.For, ast.comprehension)):
                it = node.iter
                if _is_set_expr(it):
                    line = getattr(node, "lineno", it.lineno)
                    col = getattr(node, "col_offset", it.col_offset)
                    yield Finding(
                        self.name, mod.path, line, col,
                        "iteration over a set expression — order is "
                        "value-dependent; sort it before it can feed "
                        "trace emission or sweep keys")

    def _check_call(self, mod, node, clock_scoped):
        chain = attr_chain(node.func)
        if chain is None:
            # list(set(...)) / tuple(set(...)) materialise set order
            if isinstance(node.func, ast.Name) and \
                    node.func.id in ("list", "tuple", "sorted"):
                pass
            return
        parts = chain.split(".")
        # np.random.* — legacy global-state samplers are unseedable per
        # call; default_rng()/SeedSequence() need an explicit seed
        if len(parts) >= 2 and parts[-2] == "random":
            fn = parts[-1]
            if parts[0] in ("np", "numpy"):
                if fn not in _NP_RANDOM_OK:
                    yield Finding(
                        self.name, mod.path, node.lineno, node.col_offset,
                        f"global-state RNG 'np.random.{fn}' — use an "
                        "explicitly seeded np.random.default_rng(seed)")
                elif fn in ("default_rng", "SeedSequence") and \
                        not node.args and not node.keywords:
                    yield Finding(
                        self.name, mod.path, node.lineno, node.col_offset,
                        f"unseeded 'np.random.{fn}()' — pass an explicit "
                        "seed")
        elif parts[0] == "random" and len(parts) == 2:
            fn = parts[-1]
            if fn != "Random":
                yield Finding(
                    self.name, mod.path, node.lineno, node.col_offset,
                    f"global-state RNG 'random.{fn}' — use a seeded "
                    "random.Random(seed) instance")
            elif not node.args and not node.keywords:
                yield Finding(
                    self.name, mod.path, node.lineno, node.col_offset,
                    "unseeded 'random.Random()' — pass an explicit seed")
        # wall-clock reads (simulation layers only)
        elif clock_scoped and len(parts) >= 2 and \
                parts[-1] in _WALLCLOCK.get(parts[-2], ()):
            yield Finding(
                self.name, mod.path, node.lineno, node.col_offset,
                f"wall-clock read '{chain}()' in a simulation module — "
                "the simulated clock is the manager's wall")
        # hash() inside a seed expression: str hashes are salted per
        # process (PYTHONHASHSEED), so the 'seed' differs across runs
        if parts[-1] in _SEEDED_CTORS:
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                for sub in ast.walk(arg):
                    if isinstance(sub, ast.Call) and \
                            isinstance(sub.func, ast.Name) and \
                            sub.func.id == "hash":
                        yield Finding(
                            self.name, mod.path, sub.lineno,
                            sub.col_offset,
                            "salted builtin hash() feeds an RNG seed — "
                            "str hashes differ across processes; use a "
                            "stable digest (e.g. zlib.crc32)")


# -------------------------------------------------------- counter-pairing

#: manager counters used for per-request attribution
ATTRIBUTION_COUNTERS = frozenset({"wall", "n_migrations", "n_evictions",
                                  "bytes_migrated", "bytes_evicted"})

_REPLAY_ATTRS = frozenset({"replay", "replay_scalar", "run", "flush",
                           "decode_step", "decode_steps"})
_REPLAY_FUNCS = frozenset({"execute_compiled", "execute_fused",
                           "apply_trace"})


@register_rule
class CounterPairing(Rule):
    name = "counter-pairing"
    doc = ("attribution code must read manager counters as before/after "
           "pairs around a replay — unpaired reads break conservation")
    invariant = ("per-request counter deltas sum exactly to the shared "
                 "manager's aggregates")
    scope = ("repro_torch.svm", "repro_torch.launch")

    def check(self, mod: LintModule):
        for fn, qual in walk_functions(mod.tree):
            yield from self._check_fn(mod, fn, qual)

    def _check_fn(self, mod, fn, qual):
        aliases = _manager_aliases(fn.body)
        params = {a.arg for a in fn.args.args + fn.args.kwonlyargs
                  + fn.args.posonlyargs}
        replay_lines: list[int] = []
        fused_result = False
        reads: dict[str, list[tuple[int, int, int]]] = {}
        for node in ast.walk(fn):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node is not fn:
                continue
            if isinstance(node, ast.Call):
                f = node.func
                name = f.attr if isinstance(f, ast.Attribute) else (
                    f.id if isinstance(f, ast.Name) else None)
                if name in _REPLAY_FUNCS or \
                        (isinstance(f, ast.Attribute)
                         and f.attr in _REPLAY_ATTRS) or \
                        (isinstance(f, ast.Name) and f.id in params):
                    replay_lines.append(node.lineno)
            elif isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Call):
                f = node.value.func
                name = f.attr if isinstance(f, ast.Attribute) else (
                    f.id if isinstance(f, ast.Name) else None)
                if name == "execute_fused":
                    # the returned cut snapshots ARE the after-reads
                    fused_result = True
            if isinstance(node, ast.Attribute) and \
                    isinstance(node.ctx, ast.Load) and \
                    node.attr in ATTRIBUTION_COUNTERS and \
                    _is_manager_recv(node.value, aliases):
                reads.setdefault(node.attr, []).append(
                    (node.lineno, node.col_offset, node.lineno))
        if not replay_lines or not reads:
            return
        first, last = min(replay_lines), max(replay_lines)
        for counter, sites in sorted(reads.items()):
            before = any(line <= first for line, _, _ in sites)
            after = any(line >= last for line, _, _ in sites) \
                or fused_result
            if before and after:
                continue
            line, col, _ = sites[0]
            side = "after" if before else "before"
            yield Finding(
                self.name, mod.path, line, col,
                f"manager counter '{counter}' read on one side of a "
                f"replay only (missing the {side}-snapshot) — unpaired "
                "reads mis-attribute shared-pool costs")


# ---------------------------------------------------------- bounded-retry

#: identifier fragments that mark an explicit attempt budget
_BUDGET_NAME = re.compile(
    r"(max_)?(attempts?|restarts?|retr(y|ies)|budget|patience)",
    re.IGNORECASE)


def _walk_same_scope(node: ast.AST):
    """`ast.walk` that does not descend into nested function/class
    definitions — their loops and handlers are their own scope."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        n = stack.pop()
        yield n
        if not isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef, ast.Lambda)):
            stack.extend(ast.iter_child_nodes(n))


def _handler_swallows(handler: ast.ExceptHandler) -> bool:
    """A handler that neither re-raises nor exits (break/return) swallows
    the failure, so the enclosing loop re-invokes the same work."""
    for n in _walk_same_scope(handler):
        if isinstance(n, (ast.Raise, ast.Break, ast.Return)):
            return False
    return True


@register_rule
class BoundedRetry(Rule):
    name = "bounded-retry"
    doc = ("a while-loop that catches an exception and retries the same "
           "work must reference a bounded attempt budget "
           "(repro_torch.ft.retry)")
    invariant = ("every recovery loop terminates under a persistent "
                 "fault: retries are spent against an explicit budget, "
                 "never open-ended")

    def check(self, mod: LintModule):
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.While):
                continue
            body = list(_walk_same_scope(node))
            handlers = [h for n in body if isinstance(n, ast.Try)
                        for h in n.handlers]
            if not handlers or \
                    not any(_handler_swallows(h) for h in handlers):
                continue
            names: set[str] = set()
            for n in body:
                if isinstance(n, ast.Name):
                    names.add(n.id)
                elif isinstance(n, ast.Attribute):
                    names.add(n.attr)
            if any(_BUDGET_NAME.search(x) for x in names):
                continue
            yield Finding(
                self.name, mod.path, node.lineno, node.col_offset,
                "retry loop swallows exceptions with no bounded attempt "
                "budget in scope — use repro_torch.ft.retry (retry_call / "
                "RetryBudget) or reference an explicit attempt counter")


# --------------------------------------------------------------- hot-loop

#: per-op column identifiers (flat op columns and their derived
#: touch-stream views) — the arrays whose length scales with trace ops
_OP_COLUMN_NAMES = frozenset({
    "codes", "rids", "concs", "hints", "fargs",
    "tpos", "trid", "tpos_np", "trid_np",
    "touch_pos", "touch_rid", "touch_pos_np", "touch_rid_np",
})


def _op_columns_iterated(it: ast.expr) -> set[str]:
    """Op-column names a for-loop's iterable walks per element.

    Sees through ``enumerate``/``zip``/``reversed`` wrappers and
    ``.tolist()`` — but deliberately not ``range(...)``: an index loop's
    body is usually O(1) per *miss or victim*, not per op, and the
    sequential reference paths that do scale per op iterate the column
    itself."""
    out: set[str] = set()

    def scan(expr: ast.expr) -> None:
        if isinstance(expr, ast.Call):
            f = expr.func
            fname = f.attr if isinstance(f, ast.Attribute) else (
                f.id if isinstance(f, ast.Name) else None)
            if fname in ("enumerate", "zip", "reversed"):
                for a in expr.args:
                    scan(a)
            elif fname == "tolist" and isinstance(f, ast.Attribute):
                scan(f.value)
            return
        chain = attr_chain(expr)
        if chain is not None:
            tail = chain.rsplit(".", 1)[-1]
            if tail in _OP_COLUMN_NAMES:
                out.add(tail)

    scan(it)
    return out


@register_rule
class HotLoop(Rule):
    name = "hot-loop"
    doc = ("engine execute/fold functions must not iterate op-column "
           "arrays in per-op Python for loops")
    invariant = ("engine hot paths are single-pass NumPy column "
                 "operations (cumsum/searchsorted/reduceat-free ordinal "
                 "sweeps); a Python for loop over an op column scales "
                 "wall time with trace length, which the fused tiers "
                 "exist to avoid — sequential reference paths live in "
                 "dedicated `_phase_a_*` oracles, not execute/fold "
                 "functions")
    scope = ("repro_torch.core",)

    def check(self, mod: LintModule):
        if os.path.basename(mod.path) != "engine.py":
            return
        for fn, qualname in walk_functions(mod.tree):
            leaf = qualname.rsplit(".", 1)[-1]
            if "execute" not in leaf and "fold" not in leaf:
                continue
            for node in ast.walk(fn):
                if not isinstance(node, ast.For):
                    continue
                cols = _op_columns_iterated(node.iter)
                if cols:
                    yield Finding(
                        self.name, mod.path, node.lineno,
                        node.col_offset,
                        f"per-op Python loop over op column(s) "
                        f"{', '.join(sorted(cols))} in hot function "
                        f"{qualname!r} — vectorise (column ops / "
                        f"cumsum folds) or move the sequential walk to "
                        f"a reference oracle")
