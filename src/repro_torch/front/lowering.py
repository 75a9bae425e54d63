"""aten-op -> fabric-operator lowering rules (DESIGN.md §9), the PyTorch
port of ``repro.front.lowering``.

The program arrives as a ``torch.fx`` graph of aten ops, captured by
``make_fx(fn, tracing_mode="fake")`` on 0-d tensors
(:mod:`repro_torch.front.tracer`).  One rule per aten op, each standing
for the jaxpr primitive the JAX package lowers (:data:`SUPPORTED` names
it).  The arithmetic/logic/relational ops map 1:1 onto
:class:`~repro_torch.core.graph.Op`; everything else is a *schema* over
several operators:

* fan-out — an arc carries one receiver, so a value consumed by k
  operators becomes a COPY tree (``library._fanout``);
* ``where.self`` (``torch.where``) — the classical dataflow
  conditional: each data operand rides a BRANCH steered by the
  predicate (the untaken side is SINKed) and a DMERGE reunites the
  taken tokens, so *both* operands are consumed every firing;
* ``neg`` / ``abs`` / ``pow`` / ``clamp`` — expanded into SUB/MUL/MAX/MIN
  trees that are bit-exact at the execution dtype (``neg`` is ``0 - x``
  for ints, ``x * -1`` for floats, so ``-0.0`` and INT_MIN behave as in
  torch);
* constants — Python numbers in an op's arguments, 0-d ``zeros`` /
  ``ones`` / ``full`` / ``scalar_tensor`` and 0-d tensor constants
  (``get_attr``) become sticky const buses, created where they are first
  read, as the JAX package's literals are;
* ``clone`` / ``alias`` / ``detach`` / ``view`` / ``lift_fresh_copy`` and
  same-dtype conversions are aliases: they add no operator;
* ``while_loop`` (``front.while_loop``, ``front.fori_loop``, or
  ``torch._higher_order_ops.while_loop`` itself) — the paper's cyclic
  loop schema (DESIGN.md §10), exactly as the JAX package builds it for
  ``lax.while_loop`` and carry-only ``lax.scan``.

**Loops.**  The ``while_loop`` node holds a cond graph, a body graph,
the carries' initial values and ``additional_inputs``: the values the
two graphs close over.  Both graphs take every carry and every
additional input as placeholders, so each additional input is sorted by
the graph that reads it: read by the cond graph, a ``"cond"`` invariant;
read by the body graph, a ``"body"`` invariant; read by both, one of
each (JAX's separate ``cond_consts`` and ``body_consts``); read by
neither (the stray Python ints that capture brings in), dropped, with
no const bus.  A carry that the body returns unchanged (through
``clone`` and the other aliases) is moved out of the loop as JAX's
``while_loop`` and ``scan`` move it: into the body invariants, at their
front, and the loop's result for it is its initial value.  ``while``
does this only for a carry the cond graph does not read; the counted
schema below does it for every such carry.

**Counted loops** lower on the scan schema, as ``lax.fori_loop`` with
static bounds does in the JAX package: a synthetic counter carry, an
``IFLT(counter, length)`` decider, and the user carries untapped.  A
``while_loop`` node is *counted* when all of these hold:

* carry 0 starts at an integer constant ``lo``;
* the cond graph reads carry 0 and nothing else, and is exactly
  ``lt(carry0, hi)`` with ``hi`` an integer constant;
* the body's result 0 is exactly ``add(carry0, 1)``.

Its trip count is then ``length = max(hi - lo, 0)``, whatever the body
does, and carry 0 stays a carry (the fori index), so the fabric runs two
counters as the JAX package's does.  ``front.fori_loop`` with Python-int
bounds builds exactly this form; any other loop takes the while schema.

Anything else raises :class:`LoweringError` naming the aten op: integer
floor and true division, mixed dtypes (torch promotes implicitly where
JAX would have converted), and any value that is not 0-d among them.
"""
from __future__ import annotations

import itertools
import numbers

import numpy as np

from repro_torch.core.graph import Graph, Op
from repro_torch.core.library import _fanout, _reduce_tree


class LoweringError(Exception):
    """A traced program contains an op the fabric cannot run."""


# aten op name (as make_fx emits it) -> "jax primitive: fabric lowering"
# (the DESIGN.md §9 table; also the vocabulary quoted by LoweringError)
SUPPORTED = {
    "add.Tensor": "add: ADD", "add.Scalar": "add: ADD",
    "sub.Tensor": "sub: SUB", "sub.Scalar": "sub: SUB",
    "rsub.Tensor": "sub: SUB(y, x)", "rsub.Scalar": "sub: SUB(lit, x)",
    "mul.Tensor": "mul: MUL", "mul.Scalar": "mul: MUL",
    "div.Tensor": "div: DIV (float dtypes only; the fabric ALU defines "
                  "x/0 = 0)",
    "div.Scalar": "div: DIV (float dtypes only)",
    "maximum.default": "max: MAX", "minimum.default": "min: MIN",
    "bitwise_and.Tensor": "and: AND", "bitwise_and.Scalar": "and: AND",
    "bitwise_or.Tensor": "or: OR", "bitwise_or.Scalar": "or: OR",
    "bitwise_xor.Tensor": "xor: XOR", "bitwise_xor.Scalar": "xor: XOR",
    "bitwise_not.default": "not: NOT (integer dtypes)",
    "__lshift__.Tensor": "shift_left: SHL",
    "__lshift__.Scalar": "shift_left: SHL",
    "bitwise_left_shift.Tensor": "shift_left: SHL",
    "bitwise_left_shift.Tensor_Scalar": "shift_left: SHL",
    "__rshift__.Tensor": "shift_right_arithmetic / _logical: SHR "
                         "(arithmetic for signed dtypes, logical for "
                         "unsigned)",
    "__rshift__.Scalar": "shift_right_arithmetic / _logical: SHR",
    "bitwise_right_shift.Tensor": "shift_right_arithmetic / _logical: SHR",
    "bitwise_right_shift.Tensor_Scalar": "shift_right_arithmetic / "
                                         "_logical: SHR",
    "gt.Tensor": "gt: IFGT", "gt.Scalar": "gt: IFGT",
    "ge.Tensor": "ge: IFGE", "ge.Scalar": "ge: IFGE",
    "lt.Tensor": "lt: IFLT", "lt.Scalar": "lt: IFLT",
    "le.Tensor": "le: IFLE", "le.Scalar": "le: IFLE",
    "eq.Tensor": "eq: IFEQ", "eq.Scalar": "eq: IFEQ",
    "ne.Tensor": "ne: IFDF", "ne.Scalar": "ne: IFDF",
    "where.self": "select_n: BRANCH x2 + SINK x2 + DMERGE (bool "
                  "predicate)",
    "neg.default": "neg: SUB(0, x) int / MUL(x, -1) float",
    "abs.default": "abs: COPY + neg + MAX",
    "pow.Tensor_Scalar": "integer_pow: MUL tree (int dtypes, y >= 0)",
    "clamp.default": "clamp: MAX + MIN (a None bound is dropped)",
    "clamp.Tensor": "clamp: MAX + MIN (a None bound is dropped)",
    "clamp_min.default": "max: MAX", "clamp_min.Tensor": "max: MAX",
    "clamp_max.default": "min: MIN", "clamp_max.Tensor": "min: MIN",
    "_to_copy.default": "convert_element_type: alias (bool->dtype / same "
                        "dtype) or IFDF(x, 0) (dtype->bool)",
    "to.dtype": "convert_element_type: alias or IFDF(x, 0)",
    "clone.default": "stop_gradient: alias",
    "alias.default": "stop_gradient: alias",
    "detach.default": "stop_gradient: alias",
    "view.default": "reshape: alias (scalar)",
    "lift_fresh_copy.default": "literal: alias",
    "zeros.default": "literal: const bus (shape ())",
    "ones.default": "literal: const bus (shape ())",
    "full.default": "literal: const bus (shape ())",
    "scalar_tensor.default": "literal: const bus",
    "get_attr": "closure const: const bus (0-d tensors)",
    "getitem": "loop result: alias",
    "while_loop": "while / scan: cyclic loop schema: NDMERGE entry per "
                  "carry + predicate cone + BRANCH back-edge/exit "
                  "steering (scalar carries)",
}

_BINOP = {
    "add": Op.ADD, "sub": Op.SUB, "mul": Op.MUL,
    "maximum": Op.MAX, "minimum": Op.MIN,
    "clamp_min": Op.MAX, "clamp_max": Op.MIN,
    "bitwise_and": Op.AND, "bitwise_or": Op.OR, "bitwise_xor": Op.XOR,
    "__lshift__": Op.SHL, "bitwise_left_shift": Op.SHL,
    "__rshift__": Op.SHR, "bitwise_right_shift": Op.SHR,
    "gt": Op.IFGT, "ge": Op.IFGE, "lt": Op.IFLT, "le": Op.IFLE,
    "eq": Op.IFEQ, "ne": Op.IFDF,
}
_DECIDERS = ("gt", "ge", "lt", "le", "eq", "ne")
_SHIFTS = ("__lshift__", "bitwise_left_shift", "__rshift__",
           "bitwise_right_shift")
# `a op b == b op a` bit-exactly at any dtype (engine ALU formulas):
# used to put a const operand on the b side, where the identity-
# elimination pass looks for it.
_COMMUTATIVE = frozenset(("add", "mul", "maximum", "minimum", "clamp_min",
                          "clamp_max", "bitwise_and", "bitwise_or",
                          "bitwise_xor", "eq", "ne"))
_ALIAS = ("clone", "alias", "detach", "view", "lift_fresh_copy")
_CONSTS = ("zeros", "ones", "full", "scalar_tensor")


def _op_name(node) -> str:
    """The aten op name a node stands for (``SUPPORTED``'s keys)."""
    if node.op == "get_attr":
        return "get_attr"
    t = node.target
    if hasattr(t, "_overloadname"):            # an aten OpOverload
        return f"{t._opname}.{t._overloadname}"
    name = getattr(t, "__name__", None)
    if name is None and callable(getattr(t, "name", None)):
        name = t.name()                         # a higher-order op
    return name or str(t)


def _base(node) -> str:
    return _op_name(node).split(".")[0]


def _is_ref(atom) -> bool:
    """A value of the graph: an fx node or a loop result ``(node, k)``."""
    return hasattr(atom, "op") or isinstance(atom, tuple)


def _is_literal(atom) -> bool:
    return isinstance(atom, numbers.Number)


def _meta(node):
    return node.meta.get("val")


def _np_dtype(tdt) -> np.dtype:
    """numpy's name for a torch dtype."""
    import torch
    return torch.empty((), dtype=tdt).numpy().dtype


class _Lit:
    """Supply of a constant node: a const bus made where it is read."""
    __slots__ = ("value",)

    def __init__(self, value):
        self.value = value


class _Ctx:
    """Lowering state: per-value arc supplies, use counts, taint."""

    def __init__(self, graph: Graph, dtype):
        self.graph = graph
        self.dtype = np.dtype(dtype)
        self.supply: dict = {}     # value -> list[str] | str const | _Lit
        self.uses: dict = {}       # value -> planned consumer count
        self.streamy: dict = {}    # value -> depends on an env stream?
        self.env_inputs: set[str] = set()
        self.const_args: dict[int, object] = {}   # arg index -> value
        self.has_loops = False     # a while_loop lowered a cyclic region
        self.loop_depth = 0        # loop-body nesting during lowering
        self._loops: dict = {}     # while_loop node -> _LoopInfo
        self._n = itertools.count()
        self._lits: dict = {}

    def fresh(self, tag: str = "v") -> str:
        return f"{tag}{next(self._n)}"

    # -- constants ------------------------------------------------------
    def lit(self, value) -> str:
        """Const bus for a compile-time scalar (deduped by value bits —
        const arcs are sticky and may feed many receivers)."""
        v = np.asarray(value, self.dtype).reshape(()).item()
        key = repr(v)
        arc = self._lits.get(key)
        if arc is None:
            arc = self.fresh("lit")
            self.graph.const(arc, v)
            self._lits[key] = arc
        return arc

    # -- supplies -------------------------------------------------------
    def use(self, atom) -> str:
        """Claim one arc carrying the atom's value."""
        if _is_literal(atom):
            return self.lit(atom)
        s = self.supply[atom]
        if isinstance(s, _Lit):
            return self.lit(s.value)
        return s if isinstance(s, str) else s.pop(0)

    def is_streamy(self, atom) -> bool:
        return (not _is_literal(atom)) and self.streamy.get(atom, False)

    def bind(self, var, arc: str, streamy: bool = True) -> None:
        """Register `arc` as var's value, fanning out through a COPY
        tree when the var has several consumers and SINKing it when it
        has none (a produced token must always find a receiver, or the
        arc would surface as a spurious environment output)."""
        u = self.uses.get(var, 0)
        if u == 0:
            self.graph.add(Op.SINK, [arc], [])
            self.supply[var] = []
        elif u == 1:
            self.supply[var] = [arc]
        else:
            self.supply[var] = _fanout(self.graph, arc, u, arc + "f")
        self.streamy[var] = streamy

    def bind_const(self, var, arc: str) -> None:
        self.supply[var] = arc      # sticky bus: unlimited receivers
        self.streamy[var] = False

    def bind_lit(self, var, value) -> None:
        self.supply[var] = _Lit(value)
        self.streamy[var] = False


def _err(node, why: str) -> LoweringError:
    return LoweringError(
        f"aten op '{_op_name(node)}' {why} "
        f"(fabric lowering table: {sorted(SUPPORTED)})")


def _atom_dtype(atom):
    """numpy dtype of a graph value, or the Python type of a literal."""
    if _is_literal(atom):
        return type(atom)
    if isinstance(atom, tuple):
        node, k = atom
        return _np_dtype(_meta(node)[k].dtype)
    return _np_dtype(_meta(atom).dtype)


def _check_shape(node) -> None:
    val = _meta(node)
    vals = val if isinstance(val, (tuple, list)) else [val]
    for v in vals:
        shape = tuple(getattr(v, "shape", ()))
        if shape != ():
            raise _err(node, f"produces shape {shape}; the fabric carries "
                             "scalar (0-d) tokens — stream tensors "
                             "element-wise instead")


def _check_operands(ctx: _Ctx, node, atoms) -> None:
    """Refuse the implicit promotions torch makes where JAX would have
    put an explicit conversion: every tensor operand has the result's
    dtype (comparisons: each other's), or is a bool read as 0/1 at the
    fabric's dtype; a float literal never meets an integer tensor."""
    res = _atom_dtype(node)
    deciders = _base(node) in _DECIDERS
    tensors = [_atom_dtype(a) for a in atoms if _is_ref(a)]
    want = res
    if deciders:
        non_bool = [d for d in tensors if d != np.bool_]
        want = non_bool[0] if non_bool else np.dtype(np.bool_)
    for d in tensors:
        if d != want and not (d == np.bool_ and want == ctx.dtype):
            raise _err(node, f"mixes {d} and {want} operands (torch "
                             "promotes implicitly; every arc of this "
                             f"fabric carries {ctx.dtype} tokens)")
    for a in atoms:
        if isinstance(a, float) and np.issubdtype(np.dtype(want),
                                                  np.integer):
            raise _err(node, f"mixes the float literal {a} with {want} "
                             "operands (torch promotes to float)")


def _convert_kind(ctx: _Ctx, node) -> str:
    """alias | ne0 — or raise for a conversion the fabric cannot carry
    (arcs hold one dtype; deciders already emit 0/1 at that dtype)."""
    src = _atom_dtype(node.args[0])
    dt = node.kwargs.get("dtype")
    if dt is None and _op_name(node) == "to.dtype":
        dt = node.args[1]
    dst = src if dt is None else _np_dtype(dt)
    if src == dst or (src == np.bool_ and dst == ctx.dtype):
        return "alias"
    if dst == np.bool_ and src == ctx.dtype:
        return "ne0"
    raise _err(node, f"converts {src} -> {dst}, but every arc of this "
                     f"fabric carries {ctx.dtype} tokens")


def _pow_y(node) -> int:
    y = node.args[1]
    if not isinstance(y, numbers.Integral):
        raise _err(node, f"has the non-integer exponent {y!r}")
    return int(y)


def _clamp_bounds(node):
    args = list(node.args) + [None] * (3 - len(node.args))
    lo = node.kwargs.get("min", args[1])
    hi = node.kwargs.get("max", args[2])
    return node.args[0], lo, hi


def _const_value(gm, node):
    """The value of a constant node (a 0-d literal op or tensor), else
    None."""
    if not hasattr(node, "op"):
        return node if _is_literal(node) else None
    if node.op == "get_attr":
        t = getattr(gm, node.target, None)
        if hasattr(t, "shape") and tuple(t.shape) == ():
            return t.item()
        return None
    if node.op != "call_function":
        return None
    base = _base(node)
    if base == "zeros":
        return 0
    if base == "ones":
        return 1
    if base == "full":
        return node.args[1]
    if base == "scalar_tensor":
        return node.args[0]
    if base == "lift_fresh_copy":
        return _const_value(gm, node.args[0])
    return None


def _forwarded(atom, ph) -> bool:
    """atom is placeholder ``ph`` itself, through alias ops only."""
    while hasattr(atom, "op") and atom.op == "call_function" \
            and _base(atom) in _ALIAS:
        atom = atom.args[0]
    return atom is ph


def _placeholders(gm) -> list:
    return [n for n in gm.graph.nodes if n.op == "placeholder"]


def _outputs(gm) -> list:
    out = next(n for n in gm.graph.nodes if n.op == "output")
    res = out.args[0]
    return list(res) if isinstance(res, (tuple, list)) else [res]


# ---------------------------------------------------------------------------
# Loop analysis: which carries move out, which closures each graph reads
# ---------------------------------------------------------------------------
class _LoopInfo:
    """What the lowering needs to know of one ``while_loop`` node, in the
    JAX package's terms (``cond_consts``, ``body_consts``, the carries
    left after forwarding, and whether it is a counted scan)."""

    def __init__(self, ctx: _Ctx, gm, node):
        cond_ref, body_ref, carries, extra = node.args[:4]
        self.node = node
        self.cond = getattr(gm, cond_ref.target)
        self.body = getattr(gm, body_ref.target)
        self.carries = list(carries)
        self.extra = list(extra)
        n = len(self.carries)
        cph, bph = _placeholders(self.cond), _placeholders(self.body)
        self.cph, self.bph = cph, bph
        outs = _outputs(self.body)
        cond_live = _live(ctx, self.cond, _outputs(self.cond))
        body_live = _live(ctx, self.body, outs)
        # additional inputs: Python numbers are literals wherever read;
        # a value no graph reads is dropped (no const bus, no arc)
        self.cond_reads = [cph[n + j] in cond_live
                           for j in range(len(self.extra))]
        self.body_reads = [bph[n + j] in body_live
                           for j in range(len(self.extra))]
        fwd = [_forwarded(outs[k], bph[k]) for k in range(n)]
        self.length = self._counted(gm, cph, outs, cond_live)
        if self.length is not None:
            self.hoisted = [k > 0 and fwd[k] for k in range(n)]
        else:
            self.hoisted = [fwd[k] and cph[k] not in cond_live
                            for k in range(n)]
        self.kept = [k for k in range(n) if not self.hoisted[k]]
        self.moved = [k for k in range(n) if self.hoisted[k]]
        self.cond_consts = [self.extra[j] for j in range(len(self.extra))
                            if self.cond_reads[j]]
        self.body_consts = [self.carries[k] for k in self.moved] + [
            self.extra[j] for j in range(len(self.extra))
            if self.body_reads[j]]

    def _counted(self, gm, cph, outs, cond_live):
        """The trip count of a counted loop (module docstring), else
        None."""
        if not self.carries:
            return None
        lo = _const_value(gm, self.carries[0])
        if not isinstance(lo, numbers.Integral) or isinstance(lo, bool):
            return None
        (pred,) = _outputs(self.cond)
        if not (hasattr(pred, "op") and pred.op == "call_function"
                and _base(pred) == "lt" and pred.args[0] is cph[0]
                and cond_live & set(cph) == {cph[0]}):
            return None
        hi = _const_value(self.cond, pred.args[1])
        if not isinstance(hi, numbers.Integral) or isinstance(hi, bool):
            return None
        step = outs[0]
        if not (hasattr(step, "op") and step.op == "call_function"
                and _base(step) == "add" and step.args[0] is
                _placeholders(self.body)[0]
                and step.args[1:] == (1,)
                and step.kwargs.get("alpha", 1) == 1):
            return None
        return max(int(hi) - int(lo), 0)

    def demand(self, uses) -> list[tuple[object, int]]:
        """(operand, arcs claimed) of the node: each const and initial
        value once, a moved carry also once per read of its result."""
        out = [(a, 1) for a in self.cond_consts]
        out += [(a, 1) for a in self.body_consts]
        out += [(self.carries[k], 1) for k in self.kept]
        out += [(self.carries[k], uses.get((self.node, k), 0))
                for k in self.moved]
        return out


def _loop_info(ctx: _Ctx, gm, node) -> _LoopInfo:
    info = ctx._loops.get(node)
    if info is None:
        info = ctx._loops[node] = _LoopInfo(ctx, gm, node)
    return info


def _reads(ctx: _Ctx, gm, node) -> list:
    """The graph values a node reads (a loop: its used closures only)."""
    if node.op == "call_function" and _base(node) == "while_loop":
        info = _loop_info(ctx, gm, node)
        return [a for a in (*info.cond_consts, *info.body_consts,
                            *info.carries) if hasattr(a, "op")]
    return list(node.all_input_nodes)


def _live(ctx: _Ctx, gm, outs) -> set:
    """Nodes of ``gm`` the outputs depend on."""
    seen, stack = set(), [o for o in outs if hasattr(o, "op")]
    while stack:
        n = stack.pop()
        if n in seen:
            continue
        seen.add(n)
        stack.extend(_reads(ctx, gm, n))
    return seen


# ---------------------------------------------------------------------------
# Per-node demand (the reverse-order use count) and the schemas
# ---------------------------------------------------------------------------
def _operands(ctx: _Ctx, gm, node, uses) -> list[tuple[object, int]]:
    """(operand, arcs claimed) for every value a node's lowering reads.
    ``uses`` holds the (already complete, thanks to reverse iteration)
    consumer counts of the node's results — alias lowerings forward
    their result's demand straight to their input."""
    if node.op == "get_attr":
        return []
    base = _base(node)
    name = _op_name(node)
    if base == "while_loop":
        return _loop_info(ctx, gm, node).demand(uses)
    if base == "getitem":
        return [((node.args[0], node.args[1]), uses.get(node, 0))]
    if base in _CONSTS:
        return []
    if base in _ALIAS:
        return [(node.args[0], uses.get(node, 0))]
    if name in ("_to_copy.default", "to.dtype") and \
            _convert_kind(ctx, node) == "alias":
        return [(node.args[0], uses.get(node, 0))]
    if base == "where":
        return [(node.args[0], 3), (node.args[1], 1), (node.args[2], 1)]
    if base == "abs":
        return [(node.args[0], 2)]
    if base == "pow":
        y = _pow_y(node)
        return [(node.args[0], uses.get(node, 0) if y == 1 else max(y, 0))]
    if base == "clamp":
        x, lo, hi = _clamp_bounds(node)
        return [(a, 1) for a in (x, lo, hi) if a is not None]
    return [(a, 1) for a in node.args if _is_ref(a) or _is_literal(a)]


def _bind_alias(ctx: _Ctx, out, atom) -> None:
    """out shares atom's arcs (its demand was pre-charged to atom)."""
    if _is_literal(atom):
        ctx.bind_lit(out, atom)
        return
    s = ctx.supply[atom]
    if isinstance(s, _Lit):
        ctx.bind_lit(out, s.value)
    elif isinstance(s, str):
        ctx.bind_const(out, s)
    else:
        arcs = [ctx.use(atom) for _ in range(ctx.uses.get(out, 0))]
        ctx.supply[out] = arcs
        ctx.streamy[out] = ctx.is_streamy(atom)


# ---------------------------------------------------------------------------
# Loop lowering: while_loop -> the paper's cyclic loop schema
# ---------------------------------------------------------------------------
def _check_scalar_loop(node, info) -> None:
    for v in (*_meta(node), *(_meta(c) for c in info.carries
                              if hasattr(c, "op"))):
        shape = tuple(getattr(v, "shape", ()))
        if shape != ():
            raise _err(node, f"carries a value of shape {shape}; fabric "
                             "loops carry scalar tokens")


def _one_shot_init(ctx: _Ctx, arc: str, streamy: bool, node) -> str:
    """Entry-NDMERGE initial-value input: must deliver exactly one
    token per loop INITIATION (a second arrival would re-initiate a
    live loop).  A top-level const-bus supply becomes a fresh
    init-annotated arc (the one-shot compile-time initial token of
    DESIGN.md §10); a streamy supply arc carries one token per
    initiation itself.  Nested const inits never reach here — the
    caller materializes them per initiation first.  A non-streamy
    non-const supply is produced by a free-running const-fed operator
    and is rejected."""
    g = ctx.graph
    if arc in g.consts:
        f = ctx.fresh("lz")
        g.init(f, np.asarray(g.consts[arc], ctx.dtype).reshape(()).item())
        return f
    if not streamy:
        raise _err(node, "has a loop initial value produced by a "
                         "free-running const-fed operator; hoist it to a "
                         "literal or derive it from an argument")
    return arc


def _loop_schema(ctx: _Ctx, node, *, init_sup, inv_entries, need_tap,
                 make_pred, make_backs) -> list[str]:
    """Build the paper's cyclic loop schema; returns the exit arcs.

    init_sup     ``[(arc, streamy)]`` initial-value supply per carry.
    inv_entries  ``[(bind, arc, streamy, where)]`` — loop-invariant
                 values that are NOT sticky const buses; each becomes a
                 *synthetic pass-through carry* (entry merge + tap +
                 BRANCH whose exit token is SINKed) and ``bind(tap)``
                 hands its per-iteration tap arc to the consuming cone.
                 ``where`` is the cone that consumes the tap: a
                 ``"cond"`` invariant is tapped BEFORE its BRANCH (the
                 predicate fires once more than the body — the final,
                 false evaluation still reads it), a ``"body"``
                 invariant AFTER (the tap must exist only on continuing
                 iterations, or a stale token per initiation would
                 poison re-initiating nested loops).
    need_tap[j]  carry j feeds the predicate cone (gets a COPY tap);
                 untapped carries wire straight into their BRANCH.
    make_pred(taps) -> (p_arc, p_streamy): lower the predicate cone
                 (``taps[j]`` is None when ``need_tap[j]`` is False).
    make_backs(live) -> ``[(arc, streamy)]``: lower the body cone from
                 the BRANCH-true arcs; one next-state arc per carry.

    Wiring per carry (DESIGN.md §10)::

            back ----v
        NDMERGE(back, init) -> carry -> COPY -> (tap, data)
            tap  -> predicate cone -> p (fanned out)
            data -> BRANCH(data, p) -> (live -> body -> back,  exit)

    The entry NDMERGE is race-free by construction: its init input
    delivers exactly one token per run and every later token arrives on
    the back edge, serialized by the cycle itself.

    NESTED loops re-initiate once per enclosing iteration while the
    enclosing body's carries advance at skewed rates, so a fresh
    initiation token can arrive while the previous initiation's
    back-edge token is still in flight and an NDMERGE entry would race.
    Nested loops therefore take the deterministic entry: a DMERGE
    steered by the loop predicate carrying an initial-0 control token
    (sel=0 takes the init input, sel=p=1 the back edge, and the exit
    firing's p=0 becomes the next initiation's sel); const initial
    values ride their sticky buses straight into the merge.  Top-level
    loops initiate exactly once (``make_feeds`` enforces the single-shot
    contract) and keep the paper's NDMERGE with one-shot initial tokens.
    """
    g = ctx.graph
    n = len(init_sup)
    s = len(inv_entries)
    nested = ctx.loop_depth > 0
    ctx.loop_depth += 1
    # entry-merge output arcs are allocated NOW; the entry merges are
    # added LAST (their back-edge inputs only exist after the body cone
    # lowers) — node order in the table does not affect semantics
    carry = [ctx.fresh("lc") for _ in range(n)]
    inv = [ctx.fresh("li") for _ in range(s)]
    taps, data = [], []
    for j, a in enumerate(carry):
        if need_tap[j]:
            t, d = ctx.fresh(), ctx.fresh()
            g.add(Op.COPY, [a], [t, d])
        else:
            t, d = None, a
        taps.append(t)
        data.append(d)
    for (bind, _, _, where), a in zip(inv_entries, inv):
        if where == "cond":     # tap pre-BRANCH: T+1 per initiation
            t, d = ctx.fresh(), ctx.fresh()
            g.add(Op.COPY, [a], [t, d])
            bind(t)
            data.append(d)
        else:                   # tap post-BRANCH (below): T per init
            data.append(a)
    p_arc, p_streamy = make_pred(taps)
    if p_arc in g.consts or not p_streamy:
        raise _err(node, "has a loop predicate that does not depend on "
                         "the loop state — the trip count would be zero "
                         "or infinite at compile time")
    # the BRANCH nodes are added AFTER the body cone lowers — their
    # predicate-leg count depends on whether a predicate-derived gate
    # is needed (below), and the body only needs the live arc NAMES
    m = n + s
    live = [ctx.fresh("ll") for _ in range(n)]
    exits = [ctx.fresh("lx") for _ in range(n)]
    synth_live = [ctx.fresh("lv") for _ in range(s)]
    synth_backs = []
    for j, (bind, _, _, where) in enumerate(inv_entries):
        if where == "cond":
            synth_backs.append(synth_live[j])
        else:                           # body tap rides the live token
            t, back = ctx.fresh(), ctx.fresh()
            g.add(Op.COPY, [synth_live[j]], [t, back])
            bind(t)
            synth_backs.append(back)
    backs = list(make_backs(live))
    ctx.loop_depth -= 1
    # next-state fixup: a constant next value (body returns a literal /
    # const pass-through) has no per-iteration producer, and wiring the
    # always-full const bus into a top-level NDMERGE entry would
    # re-fire it every refill window.  Gate one token per CONTINUING
    # iteration instead: DMERGE with both data inputs riding the const
    # bus and the gate token as control produces exactly one
    # const-valued token per body firing.  The gate rides a streamy
    # back value when one exists, else an extra predicate token routed
    # by its own twin (BRANCH(p, p): the true output exists only on
    # continuing iterations) — a loop whose EVERY next state is
    # constant is still data-dependent through its zero-trip path.
    # The nested DMERGE entry consumes its chosen bus per firing, so
    # const backs ride their sticky buses directly there.
    const_j = [j for j, (a, _) in enumerate(backs) if a in g.consts]
    free_j = [j for j, (a, sy) in enumerate(backs)
              if a not in g.consts and not sy]
    if free_j:
        raise _err(node, "has a loop next-state value produced by a "
                         "free-running const-fed operator — its arc "
                         "would re-initiate the loop; hoist it to a "
                         "literal or derive it from the carry")
    need_gates = bool(const_j) and not nested
    gate_j = next((j for j, (a, sy) in enumerate(backs)
                   if a not in g.consts and sy), None) if need_gates \
        else None
    p_gate = need_gates and gate_j is None
    # nested entries consume the predicate too (as the DMERGE steering
    # stream): double the fan-out and pre-load each steering leg with
    # the initial-0 token that selects the first initiation's input
    ps = _fanout(g, p_arc, (2 * m if nested else m)
                 + (2 if p_gate else 0), p_arc + "f")
    sels = ps[m:2 * m] if nested else []
    for a in sels:
        g.init(a, 0)
    for j in range(n):
        g.add(Op.BRANCH, [data[j], ps[j]], [live[j], exits[j]])
    for j in range(s):
        ex = ctx.fresh()
        g.add(Op.BRANCH, [data[n + j], ps[n + j]], [synth_live[j], ex])
        g.add(Op.SINK, [ex], [])        # invariant's exit value is dead
    if need_gates:
        if p_gate:
            gl, gd = ctx.fresh("lgl"), ctx.fresh()
            g.add(Op.BRANCH, [ps[-2], ps[-1]], [gl, gd])
            g.add(Op.SINK, [gd], [])    # the final (false) evaluation
            gates = _fanout(g, gl, len(const_j), ctx.fresh("lg"))
        else:
            fan = _fanout(g, backs[gate_j][0], 1 + len(const_j),
                          ctx.fresh("lg"))
            backs[gate_j] = (fan[0], True)
            gates = fan[1:]
        for gate, j in zip(gates, const_j):
            out = ctx.fresh("lk")
            g.add(Op.DMERGE, [backs[j][0], backs[j][0], gate], [out])
            backs[j] = (out, True)
    # close the cycles: one entry merge per carry — the paper's NDMERGE
    # at top level, the predicate-steered deterministic DMERGE nested
    all_backs = [b for b, _ in backs] + synth_backs
    all_inits = list(init_sup) + [(a, sy) for _, a, sy, _ in inv_entries]
    all_carry = carry + inv
    for j in range(m):
        back, (ini_arc, ini_sy) = all_backs[j], all_inits[j]
        if nested:
            if ini_arc not in g.consts and not ini_sy:
                raise _err(node, "has a loop initial value produced by "
                                 "a free-running const-fed operator; "
                                 "hoist it to a literal or derive it "
                                 "from an argument")
            g.add(Op.DMERGE, [back, ini_arc, sels[j]], [all_carry[j]])
        else:
            ini = _one_shot_init(ctx, ini_arc, ini_sy, node)
            g.add(Op.NDMERGE, [back, ini], [all_carry[j]])
    ctx.has_loops = True
    return exits


def _split_invariants(ctx: _Ctx, sup, out, where: str):
    """Partition loop-invariant supplies: sticky const buses ride into
    the cone directly (``out[k]`` set now); anything else registers a
    synthetic carry whose ``bind`` fills ``out[k]`` with the tap arc.
    ``where`` names the consuming cone ("cond" | "body") — it decides
    the tap cadence (see :func:`_loop_schema`)."""
    inv_entries = []
    for k, (arc, sy) in enumerate(sup):
        if arc in ctx.graph.consts:
            out[k] = (arc, False)
        else:
            def bind(t, k=k, out=out):
                out[k] = (t, True)
            inv_entries.append((bind, arc, sy, where))
    return inv_entries


def _graph_inputs(info: _LoopInfo, ph, carry_arcs, moved_in, extra_in,
                  reads) -> list:
    """One ``(arc, streamy)`` (or None: unread) per placeholder of a loop
    graph: kept carries, moved carries, then the closures it reads."""
    n = len(info.carries)
    out = [None] * len(ph)
    for k, arc in zip(info.kept, carry_arcs):
        out[k] = arc
    for k, sup in zip(info.moved, moved_in):
        out[k] = sup
    it = iter(extra_in)
    for j in range(len(info.extra)):
        if reads[j]:
            out[n + j] = next(it)
    return out


def _lower_while(ctx: _Ctx, gm, node) -> None:
    info = _loop_info(ctx, gm, node)
    _check_scalar_loop(node, info)
    sup = [(ctx.use(v), ctx.is_streamy(v))
           for v in (*info.cond_consts, *info.body_consts,
                     *(info.carries[k] for k in info.kept))]
    nc, nb = len(info.cond_consts), len(info.body_consts)
    cond_in = [None] * nc
    body_in = [None] * nb
    inv_entries = (_split_invariants(ctx, sup[:nc], cond_in, "cond")
                   + _split_invariants(ctx, sup[nc:nc + nb], body_in,
                                       "body"))
    nm = len(info.moved)

    def body_inputs(live):
        return _graph_inputs(info, info.bph, [(a, True) for a in live],
                             body_in[:nm], body_in[nm:], info.body_reads)

    if info.length is None:
        def make_pred(taps):
            ins = _graph_inputs(info, info.cph, [(t, True) for t in taps],
                                [], cond_in, info.cond_reads)
            return lower_graph(ctx, info.cond, ins)[0]

        def make_backs(live):
            return lower_graph(ctx, info.body, body_inputs(live),
                               keep=info.kept)

        exits = _loop_schema(ctx, node, init_sup=sup[nc + nb:],
                             inv_entries=inv_entries,
                             need_tap=[True] * len(info.kept),
                             make_pred=make_pred, make_backs=make_backs)
    else:                       # counted: the carry-only scan schema
        g = ctx.graph
        len_bus = ctx.lit(info.length)
        one_bus = ctx.lit(1)

        def make_pred(taps):
            pa = ctx.fresh("lp")
            g.add(Op.IFLT, [taps[0], len_bus], [pa])
            return pa, True

        def make_backs(live):
            nxt = ctx.fresh("ln")
            g.add(Op.ADD, [live[0], one_bus], [nxt])
            res = lower_graph(ctx, info.body, body_inputs(live[1:]),
                              keep=info.kept)
            return [(nxt, True)] + list(res)

        exits = _loop_schema(
            ctx, node, init_sup=[(ctx.lit(0), False)] + sup[nc + nb:],
            inv_entries=inv_entries,
            need_tap=[True] + [False] * len(info.kept),
            make_pred=make_pred, make_backs=make_backs)
        g.add(Op.SINK, [exits[0]], [])  # final counter value is dead
        exits = exits[1:]
    for k, ex in zip(info.kept, exits):
        ctx.bind((node, k), ex, streamy=True)
    for k in info.moved:        # a moved carry's result is its init
        _bind_alias(ctx, (node, k), info.carries[k])


# ---------------------------------------------------------------------------
# One node
# ---------------------------------------------------------------------------
def _lower_node(ctx: _Ctx, gm, node) -> None:
    g, dtype = ctx.graph, ctx.dtype
    is_int = np.issubdtype(dtype, np.integer)
    name, base = _op_name(node), _base(node)

    if node.op == "get_attr":
        val = getattr(gm, node.target)
        if not hasattr(val, "shape"):
            return                      # a loop's cond/body graph
        if tuple(val.shape) != ():
            raise LoweringError(
                f"closure constant of shape {tuple(val.shape)} cannot "
                "ride a scalar-token arc (fabric tokens are 0-d)")
        ctx.bind_lit(node, val.item())
        return
    if name not in SUPPORTED:
        raise _err(node, "has no fabric lowering")
    if base == "while_loop":
        _lower_while(ctx, gm, node)
        return
    if base == "getitem":
        src = node.args[0]
        if not (hasattr(src, "op") and _base(src) == "while_loop"):
            raise _err(node, "reads a result of an op that is not a loop")
        _bind_alias(ctx, node, (src, node.args[1]))
        return
    _check_shape(node)
    out = node

    if base in _CONSTS:
        ctx.bind_lit(out, _const_value(gm, node))
        return

    if base in _ALIAS:
        _bind_alias(ctx, out, node.args[0])
        return

    if name in ("_to_copy.default", "to.dtype"):
        x = node.args[0]
        if _convert_kind(ctx, node) == "alias":
            _bind_alias(ctx, out, x)
        else:                     # dtype -> bool: x != 0
            arc = ctx.fresh()
            g.add(Op.IFDF, [ctx.use(x), ctx.lit(0)], [arc])
            ctx.bind(out, arc, ctx.is_streamy(x))
        return

    if base == "clamp":
        x, lo, hi = _clamp_bounds(node)
        _check_operands(ctx, node, [a for a in (x, lo, hi)
                                    if a is not None])
        if lo is None or hi is None:      # one bound: a plain MAX / MIN
            op, b = (Op.MIN, hi) if lo is None else (Op.MAX, lo)
            a = x
            if not ctx.is_streamy(a) and ctx.is_streamy(b):
                a, b = b, a
            arc = ctx.fresh()
            g.add(op, [ctx.use(a), ctx.use(b)], [arc])
            ctx.bind(out, arc, ctx.is_streamy(a) or ctx.is_streamy(b))
            return
        t, arc = ctx.fresh(), ctx.fresh()   # lax.clamp(min, operand, max)
        g.add(Op.MAX, [ctx.use(x), ctx.use(lo)], [t])
        g.add(Op.MIN, [t, ctx.use(hi)], [arc])
        ctx.bind(out, arc, any(ctx.is_streamy(v) for v in (lo, x, hi)))
        return

    if base in _BINOP or base in ("div", "rsub"):
        a, b = node.args[:2]
        if node.kwargs.get("alpha", 1) != 1:
            raise _err(node, "has a scale (alpha) operand; write the "
                             "multiply out")
        if node.kwargs.get("rounding_mode") is not None:
            raise _err(node, "is rounding integer division; the fabric "
                             "DIV is float-only — use shifts for powers "
                             "of two")
        if base == "div":
            if is_int or any(np.issubdtype(np.dtype(_atom_dtype(v)),
                                           np.integer)
                             for v in (a, b) if _is_ref(v)):
                raise _err(node, "is true division of integers (torch "
                                 "promotes it to float); the fabric DIV "
                                 "is float-only — use shifts for powers "
                                 "of two")
            op = Op.DIV
        elif base == "rsub":
            op = Op.SUB
            a, b = b, a                   # rsub(x, y) = y - x
        else:
            op = _BINOP[base]
        _check_operands(ctx, node, [a, b])
        if base in _SHIFTS and not is_int:
            raise _err(node, "needs an integer dtype")
        if (base in _COMMUTATIVE and not ctx.is_streamy(a)
                and ctx.is_streamy(b)):
            a, b = b, a          # const operand on the b side (passes
            #                      splice identities off inputs[1])
        streamy = ctx.is_streamy(a) or ctx.is_streamy(b)
        arc = ctx.fresh()
        g.add(op, [ctx.use(a), ctx.use(b)], [arc])
        ctx.bind(out, arc, streamy)
        return

    x = node.args[0]
    if base == "bitwise_not":
        if _atom_dtype(x) == np.bool_:
            raise _err(node, "is a logical not of a bool; the fabric NOT "
                             "is bitwise — write `x == 0`")
        _check_operands(ctx, node, [x])
        arc = ctx.fresh()
        g.add(Op.NOT, [ctx.use(x)], [arc])
        ctx.bind(out, arc, ctx.is_streamy(x))
        return

    if base == "neg":
        _check_operands(ctx, node, [x])
        arc = ctx.fresh()
        if is_int:
            g.add(Op.SUB, [ctx.lit(0), ctx.use(x)], [arc])
        else:           # 0.0 - x flips -0.0; x * -1.0 is bit-exact
            g.add(Op.MUL, [ctx.use(x), ctx.lit(-1)], [arc])
        ctx.bind(out, arc, ctx.is_streamy(x))
        return

    if base == "abs":
        _check_operands(ctx, node, [x])
        x0, x1 = ctx.use(x), ctx.use(x)
        nn = ctx.fresh()
        if is_int:
            g.add(Op.SUB, [ctx.lit(0), x1], [nn])
        else:
            g.add(Op.MUL, [x1, ctx.lit(-1)], [nn])
        arc = ctx.fresh()
        g.add(Op.MAX, [x0, nn], [arc])    # MAX(+0,-0)=+0 matches |−0.0|
        ctx.bind(out, arc, ctx.is_streamy(x))
        return

    if base == "pow":
        y = _pow_y(node)
        _check_operands(ctx, node, [x])
        if y < 0:
            raise _err(node, f"has negative exponent y={y}")
        if y == 0:
            ctx.bind_lit(out, 1)
            return
        if y == 1:
            _bind_alias(ctx, out, x)
            return
        if not is_int:
            raise _err(node, "expands to a MUL tree whose rounding "
                             "order is only bit-exact for integer "
                             "dtypes — spell out float powers as "
                             "explicit multiplies")
        arcs = [ctx.use(x) for _ in range(y)]
        arc = ctx.fresh()
        _reduce_tree(g, arcs, Op.MUL, arc + "p", final=arc)
        ctx.bind(out, arc, ctx.is_streamy(x))
        return

    if base == "where":
        pred, tv, fv = node.args[:3]      # where(cond, self, other)
        if _atom_dtype(pred) != np.bool_:
            raise _err(node, "has a non-boolean selector")
        _check_operands(ctx, node, [tv, fv])
        c_t, c_f, c_m = ctx.use(pred), ctx.use(pred), ctx.use(pred)
        t_live, t_dead = ctx.fresh(), ctx.fresh()
        f_live, f_dead = ctx.fresh(), ctx.fresh()
        g.add(Op.BRANCH, [ctx.use(tv), c_t], [t_live, t_dead])
        g.add(Op.SINK, [t_dead], [])
        g.add(Op.BRANCH, [ctx.use(fv), c_f], [f_dead, f_live])
        g.add(Op.SINK, [f_dead], [])
        arc = ctx.fresh()
        g.add(Op.DMERGE, [t_live, f_live, c_m], [arc])
        ctx.bind(out, arc, any(ctx.is_streamy(v) for v in (pred, tv, fv)))
        return

    raise _err(node, "has no fabric lowering")


def lower_graph(ctx: _Ctx, gm, in_arcs, keep=None
                ) -> list[tuple[str, bool]]:
    """Lower one fx graph scope onto ctx.graph.

    in_arcs: one ``(arc, streamy)`` pair (or None: a placeholder nothing
    reads) per placeholder — or None (top level) to create an environment
    input arc ``in{i}`` on demand, recording the created names (None for
    unused args) in ``ctx.created_inputs``.  ``keep``: the indices of the
    graph's results to lower (all by default).  Returns ``(arc,
    streamy)`` per kept result; placeholders handed an arc that nothing
    reads are SINKed so every token still finds a receiver.
    """
    nodes = list(gm.graph.nodes)
    phs = [n for n in nodes if n.op == "placeholder"]
    outs = _outputs(gm)
    if keep is not None:
        outs = [outs[k] for k in keep]
    body = [n for n in nodes if n.op in ("call_function", "get_attr")]
    # 1. demand counting, in reverse so alias chains see their own
    #    consumers before charging their inputs
    uses: dict = {}

    def charge(atom, m):
        if _is_ref(atom) and m:
            uses[atom] = uses.get(atom, 0) + m

    for v in outs:
        charge(v, 1)
    for node in reversed(body):
        for atom, m in _operands(ctx, gm, node, uses):
            charge(atom, m)
    ctx.uses.update(uses)

    # 2. bind arguments
    if in_arcs is None:                 # top level: environment streams
        created: list[str | None] = []
        for i, var in enumerate(phs):
            if i in ctx.const_args:     # sticky const bus, not a stream
                if ctx.uses.get(var, 0):
                    ctx.bind_const(var, ctx.lit(ctx.const_args[i]))
                continue
            if ctx.uses.get(var, 0) == 0:
                created.append(None)    # unused argument: no arc at all
                continue
            arc = f"in{i}"
            ctx.env_inputs.add(arc)
            created.append(arc)
            ctx.bind(var, arc, streamy=True)
        ctx.created_inputs = created
    else:                               # a loop's graph: arcs handed in
        for var, sup in zip(phs, in_arcs):
            if sup is None:
                if ctx.uses.get(var, 0):
                    raise LoweringError(
                        f"loop graph placeholder {var.name} is read but "
                        "was handed no value")
                continue
            arc, streamy = sup
            if arc in ctx.graph.consts:
                ctx.bind_const(var, arc)
            else:
                ctx.bind(var, arc, streamy)

    # 3. nodes in program order
    for node in body:
        _lower_node(ctx, gm, node)

    # 4. results
    results = []
    for v in outs:
        if _is_literal(v):
            results.append((ctx.lit(v), False))
        else:
            results.append((ctx.use(v), ctx.is_streamy(v)))
    return results
