"""Assembler language for dataflow graphs (paper Listing 1).

Syntax, one node per statement::

    [lineno.] opcode arg, arg, ... ;     # comment

Arguments are arc labels: inputs first, then outputs, per the opcode
arity (e.g. ``add s10, dadoe, s11`` reads s10 and dadoe, writes s11;
``branch s9, s8, s10, pf`` reads data s9 and control s8, writes t-output
s10 and f-output pf; ``dmerge s2, dadoc, s1, s3`` reads a=s2, b=dadoc,
ctrl=s1, writes s3).

``const <arc> = <number>;`` declares a sticky environment bus (the FPGA
input bus that always presents its value, e.g. the `dadoe` increment in
the paper's Fibonacci graph).  Values may be integers (any Python int
literal base) or floats — float fabrics from the JAX package's tracing
frontend carry non-integral coefficients, and ``emit`` must round-trip
them exactly for the serving layer's signature cache (the text is the
same in both packages, so a fabric crosses between them as asm text).

``init <arc> = <number>;`` declares an *initial-token annotation*
(DESIGN.md §10): the arc starts full with the given one-shot value —
the synchronous-dataflow delay marking on a loop back-edge register.
Cyclic fabrics synthesized by the loop-lowering frontend carry these,
so they must survive serialize/deserialize like everything else (the
serving signature cache hashes the emission).

Errors: malformed statements, unknown opcodes, wrong argument counts,
bad/duplicate const declarations raise :class:`SyntaxError` naming the
offending statement; structural violations (an arc with two producers
or two receivers, a const arc that is also produced) surface as the
:class:`ValueError` of :meth:`repro_torch.core.graph.Graph.validate`.
"""
from __future__ import annotations

import re

import numpy as np

from repro_torch.core.graph import ARITY, Graph, Op

_ALIASES = {
    "gtdecider": Op.IFGT,
    "gedecider": Op.IFGE,
    "ltdecider": Op.IFLT,
    "ledecider": Op.IFLE,
    "eqdecider": Op.IFEQ,
    "dfdecider": Op.IFDF,
}

_STMT = re.compile(r"^(?:\d+\s*\.)?\s*(\w+)\s+(.*)$")


def _parse_const(raw: str, stmt: str):
    """int (any base) or float const value; SyntaxError otherwise."""
    try:
        return int(raw, 0)
    except ValueError:
        try:
            return float(raw)
        except ValueError:
            raise SyntaxError(
                f"bad const value {raw!r} in {stmt!r}") from None


def _emit_const(val) -> str:
    """Round-trippable text for a const value: ints (and integral
    floats, which cast identically at any execution dtype) as ints,
    everything else through repr — float32-exact, and -0.0 / inf / nan
    keep their bit patterns."""
    if isinstance(val, (int, np.integer)):
        return str(int(val))
    f = float(val)
    if f.is_integer() and not (f == 0.0 and np.signbit(f)):
        return str(int(f))
    return repr(f)


def parse(text: str, name: str = "asm") -> Graph:
    g = Graph(name=name)
    # strip comments, split on ';'
    lines = []
    for raw in text.splitlines():
        raw = raw.split("#", 1)[0].split("//", 1)[0]
        lines.append(raw)
    for stmt in " ".join(lines).split(";"):
        stmt = stmt.strip()
        if not stmt:
            continue
        m = _STMT.match(stmt)
        if not m:
            raise SyntaxError(f"bad statement: {stmt!r}")
        opname, rest = m.group(1).lower(), m.group(2)
        if opname in ("const", "init"):
            arc, eq, val = rest.partition("=")
            arc, val = arc.strip(), val.strip()
            if not eq or not arc or not val:
                raise SyntaxError(
                    f"bad {opname} declaration {stmt!r} "
                    f"(want '{opname} <arc> = <number>;')")
            decls = g.consts if opname == "const" else g.inits
            if arc in decls:
                raise SyntaxError(f"{opname} arc {arc!r} redeclared "
                                  f"in {stmt!r}")
            if arc in g.consts or arc in g.inits:
                raise SyntaxError(
                    f"arc {arc!r} declared both const and init "
                    f"in {stmt!r}")
            decls[arc] = _parse_const(val, stmt)
            continue
        if opname in _ALIASES:
            op = _ALIASES[opname]
        else:
            try:
                op = Op[opname.upper()]
            except KeyError:
                raise SyntaxError(f"unknown opcode {opname!r} in {stmt!r}")
        args = [a.strip() for a in rest.split(",") if a.strip()]
        n_in, n_out = ARITY[op]
        if len(args) != n_in + n_out:
            raise SyntaxError(
                f"{opname} wants {n_in}+{n_out} args, got {args!r}")
        g.add(op, args[:n_in], args[n_in:])
    g.validate()
    return g


def emit(g: Graph) -> str:
    """Graph -> assembler text (round-trips through :func:`parse`)."""
    out = []
    for arc, val in g.consts.items():
        out.append(f"const {arc} = {_emit_const(val)};")
    for arc, val in g.inits.items():
        out.append(f"init {arc} = {_emit_const(val)};")
    for i, n in enumerate(g.nodes, start=1):
        args = ", ".join((*n.inputs, *n.outputs))
        out.append(f"{i}. {n.op.name.lower()} {args};")
    return "\n".join(out) + "\n"
