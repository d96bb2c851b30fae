"""Interval arithmetic and sign analysis over scalar-expression ASTs.

The expression grammar (`core.expr`) parses to plain tuples —
``("num", 1.5)``, ``("name", "rz")``, ``("neg", x)``, ``("call", fn,
x)``, ``("cmp", op, a, b)``, ``("+", a, b)`` … — which makes abstract
interpretation a small recursive fold. Two abstractions:

* `interval_of(node, env)` — a conservative ``[lo, hi]`` range with
  ``env`` mapping names to known `Interval`s (loop counters, literal
  lets). Anything unprovable widens to ``(-inf, inf)``; the stack
  bounds pass (RV206) stays silent on fully-unknown indices and only
  speaks when a *finite* bound violates the slot range.

* `is_nonneg(node, nonneg)` — a syntactic proof that the value is
  ``>= 0``: literals, squares (``x * x``), ``abs``/``sqrt`` results,
  and sums/products of nonnegatives. Drives the sqrt-safety pass
  (RV302) without false alarms on the Givens-rotation norm
  ``sqrt(hjj*hjj + hsub*hsub)``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional

_INF = math.inf


@dataclasses.dataclass(frozen=True)
class Interval:
    lo: float
    hi: float

    @property
    def is_top(self) -> bool:
        return self.lo == -_INF and self.hi == _INF

    def __contains__(self, v: float) -> bool:
        return self.lo <= v <= self.hi


TOP = Interval(-_INF, _INF)


def _mul_bound(a: float, b: float) -> float:
    # inf * 0 is nan under IEEE; the conservative product bound is 0
    if (a == 0 and math.isinf(b)) or (b == 0 and math.isinf(a)):
        return 0.0
    return a * b


def interval_of(node, env: Mapping[str, Interval]) -> Interval:
    tag = node[0]
    if tag == "num":
        v = float(node[1])
        return Interval(v, v)
    if tag == "name":
        return env.get(node[1], TOP)
    if tag == "neg":
        x = interval_of(node[1], env)
        return Interval(-x.hi, -x.lo)
    if tag == "call":
        x = interval_of(node[2], env)
        if node[1] == "abs":
            if x.lo >= 0:
                return x
            if x.hi <= 0:
                return Interval(-x.hi, -x.lo)
            return Interval(0.0, max(-x.lo, x.hi))
        if node[1] == "sqrt":
            # negative inputs give NaN at runtime; the sign pass
            # (RV302) reports those — bound-wise clamp at 0
            hi = math.sqrt(x.hi) if 0 <= x.hi < _INF else _INF
            lo = math.sqrt(x.lo) if x.lo > 0 else 0.0
            return Interval(lo, hi)
        return TOP
    if tag == "cmp":
        return TOP   # booleans carry no useful scalar range
    a = interval_of(node[1], env)
    b = interval_of(node[2], env)
    if tag == "+":
        return Interval(a.lo + b.lo, a.hi + b.hi)
    if tag == "-":
        return Interval(a.lo - b.hi, a.hi - b.lo)
    if tag == "*":
        cands = [_mul_bound(a.lo, b.lo), _mul_bound(a.lo, b.hi),
                 _mul_bound(a.hi, b.lo), _mul_bound(a.hi, b.hi)]
        return Interval(min(cands), max(cands))
    if tag == "/":
        # only divide through an exactly-known nonzero denominator;
        # anything else (runtime value, range spanning 0) widens
        if b.lo == b.hi and b.lo != 0 and not math.isinf(b.lo):
            cands = sorted((a.lo / b.lo, a.hi / b.lo))
            return Interval(cands[0], cands[1])
        return TOP
    return TOP


def const_value(node) -> Optional[float]:
    """Fold a literal-only expression to its value, else None."""
    iv = interval_of(node, {})
    if iv.lo == iv.hi and not math.isinf(iv.lo):
        return iv.lo
    return None


def _same_ast(a, b) -> bool:
    return a == b   # plain tuples compare structurally


def is_nonneg(node, nonneg: frozenset) -> bool:
    """True if the expression is provably >= 0. `nonneg` names values
    already proven nonnegative (e.g. literal-nonneg let bindings)."""
    tag = node[0]
    if tag == "num":
        return node[1] >= 0
    if tag == "name":
        return node[1] in nonneg
    if tag == "neg":
        inner = node[1]
        return inner[0] == "num" and inner[1] <= 0
    if tag == "call":
        # abs is nonneg by construction; sqrt yields NaN on negative
        # input, but NaN-propagation is RV302's finding, not this one's
        return node[1] in ("abs", "sqrt")
    if tag == "+":
        return is_nonneg(node[1], nonneg) and is_nonneg(node[2], nonneg)
    if tag == "*":
        if _same_ast(node[1], node[2]):
            return True   # x * x
        return is_nonneg(node[1], nonneg) and is_nonneg(node[2], nonneg)
    if tag == "/":
        # library division is sdiv: 0 on a zero denominator, so a
        # quotient of nonnegatives stays nonnegative
        return is_nonneg(node[1], nonneg) and is_nonneg(node[2], nonneg)
    return False
