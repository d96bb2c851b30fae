"""Tiny validated scalar-expression grammar for loop specs.

Iteration scalars (`alpha = rz / pq`, `beta = rz_next / rz`) are
*described* in the JSON spec rather than hand-written in Python glue,
so the expression language is deliberately minimal and fully validated
at parse time — identifiers, float literals, `+ - * /`, unary minus,
and parentheses. There is no `eval`, no attribute access, no calls:
anything outside the grammar is a parse error.

Division uses `sdiv`, the library-wide safe divide (0 instead of
inf/NaN on a zero denominator), matching what the hand-written solvers
do for step lengths so that a converged-in-body iteration cannot
poison the loop carry.

    expr := term (('+'|'-') term)*
    term := unary (('*'|'/') unary)*
    unary := '-' unary | atom
    atom := NUMBER | IDENT | FUNC '(' expr ')' | '(' expr ')'
    FUNC := 'sqrt' | 'abs'

Conditional stages (`cond` in a loop body) additionally need a boolean
*predicate*; `parse_pred` accepts exactly one comparison between two
arithmetic expressions:

    pred := expr ('<=' | '<' | '>=' | '>' | '==' | '!=') expr

Comparisons are only legal in predicates — `parse_expr` keeps
rejecting them — and a predicate must be a comparison, so a scalar
cannot be silently truthiness-tested.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Mapping, Optional, Tuple

import torch


class ExprError(ValueError):
    """Raised for any token or construct outside the grammar."""


def sdiv(a, b):
    """a / b that yields 0 instead of inf/NaN on a zero denominator."""
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    return torch.where(b == 0, 0.0, a / torch.where(b == 0, 1.0, b))


_TOKEN = re.compile(
    r"\s*(?:(?P<num>\d+\.?\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?)"
    r"|(?P<name>[A-Za-z_][A-Za-z0-9_]*)"
    r"|(?P<cmp><=|>=|==|!=|<|>)"
    r"|(?P<op>[-+*/()]))")

# unary functions the grammar admits (no eval, no attribute access —
# a fixed whitelist keeps the language closed)
_FUNCS = {
    "sqrt": torch.sqrt,
    "abs": torch.abs,
}


def _tokenize(src: str):
    pos, out = 0, []
    while pos < len(src):
        m = _TOKEN.match(src, pos)
        if m is None:
            raise ExprError(
                f"invalid token at column {pos} in scalar expression "
                f"{src!r}")
        if m.group("num") is not None:
            out.append(("num", float(m.group("num"))))
        elif m.group("name") is not None:
            out.append(("name", m.group("name")))
        elif m.group("cmp") is not None:
            out.append(("cmp", m.group("cmp")))
        else:
            out.append(("op", m.group("op")))
        pos = m.end()
        if pos < len(src) and src[pos:].strip() == "":
            break
    return out


# AST nodes are plain tuples:
#   ("num", 1.5) | ("name", "rz") | ("neg", node) | ("+", a, b) | ...


class _Parser:
    def __init__(self, src: str):
        self.src = src
        self.toks = _tokenize(src)
        self.i = 0

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self):
        t = self.peek()
        if t is None:
            raise ExprError(f"unexpected end of scalar expression "
                            f"{self.src!r}")
        self.i += 1
        return t

    def compare(self):
        node = self.expr()
        t = self.peek()
        if t is not None and t[0] == "cmp":
            op = self.next()[1]
            return ("cmp", op, node, self.expr())
        raise ExprError(
            f"predicate {self.src!r} must be a comparison "
            f"(<=, <, >=, >, ==, !=) between two scalar expressions")

    def expr(self):
        node = self.term()
        while self.peek() in (("op", "+"), ("op", "-")):
            op = self.next()[1]
            node = (op, node, self.term())
        return node

    def term(self):
        node = self.unary()
        while self.peek() in (("op", "*"), ("op", "/")):
            op = self.next()[1]
            node = (op, node, self.unary())
        return node

    def unary(self):
        if self.peek() == ("op", "-"):
            self.next()
            return ("neg", self.unary())
        return self.atom()

    def atom(self):
        kind, val = self.next()
        if kind == "num":
            return ("num", val)
        if kind == "name":
            if self.peek() == ("op", "("):
                if val not in _FUNCS:
                    raise ExprError(
                        f"unknown function {val!r} in scalar expression "
                        f"{self.src!r}; available: {sorted(_FUNCS)}")
                self.next()
                node = self.expr()
                if self.next() != ("op", ")"):
                    raise ExprError(
                        f"unbalanced parentheses in {self.src!r}")
                return ("call", val, node)
            return ("name", val)
        if (kind, val) == ("op", "("):
            node = self.expr()
            if self.next() != ("op", ")"):
                raise ExprError(f"unbalanced parentheses in {self.src!r}")
            return node
        raise ExprError(f"unexpected {val!r} in scalar expression "
                        f"{self.src!r}")


def _collect_names(node, acc):
    tag = node[0]
    if tag == "name":
        acc.add(node[1])
    elif tag == "neg":
        _collect_names(node[1], acc)
    elif tag == "call":
        _collect_names(node[2], acc)
    elif tag == "cmp":
        _collect_names(node[2], acc)
        _collect_names(node[3], acc)
    elif tag in ("+", "-", "*", "/"):
        _collect_names(node[1], acc)
        _collect_names(node[2], acc)


_CMP = {
    "<=": lambda a, b: a <= b,
    "<": lambda a, b: a < b,
    ">=": lambda a, b: a >= b,
    ">": lambda a, b: a > b,
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
}


def _evaluate(node, env):
    tag = node[0]
    if tag == "num":
        return torch.tensor(node[1], dtype=torch.float32)
    if tag == "name":
        return env[node[1]]
    if tag == "neg":
        return -_evaluate(node[1], env)
    if tag == "call":
        return _FUNCS[node[1]](_evaluate(node[2], env))
    if tag == "cmp":
        return _CMP[node[1]](_evaluate(node[2], env),
                             _evaluate(node[3], env))
    a, b = _evaluate(node[1], env), _evaluate(node[2], env)
    if tag == "+":
        return a + b
    if tag == "-":
        return a - b
    if tag == "*":
        return a * b
    return sdiv(a, b)   # "/"


@dataclasses.dataclass(frozen=True)
class Expr:
    """A parsed, validated scalar expression."""
    src: str
    ast: Optional[Tuple] = dataclasses.field(repr=False, default=None)
    names: frozenset = frozenset()

    def evaluate(self, env: Mapping):
        """Evaluate against name -> torch scalar bindings (safe divide)."""
        missing = [n for n in self.names if n not in env]
        if missing:
            raise ExprError(
                f"expression {self.src!r} references undefined names "
                f"{missing}")
        return _evaluate(self.ast, env)

    @property
    def bare_name(self) -> Optional[str]:
        """The identifier if this expression is a lone name, else None.

        A bare name may reference a value of any kind (vector state
        init like `"init": "r0"`); a composite expression is scalar
        arithmetic only.
        """
        return self.ast[1] if self.ast[0] == "name" else None


def parse_expr(src) -> Expr:
    """Parse one scalar expression; raises ExprError outside the
    grammar."""
    if isinstance(src, (int, float)) and not isinstance(src, bool):
        return Expr(src=repr(float(src)), ast=("num", float(src)))
    if not isinstance(src, str):
        raise ExprError(f"scalar expression must be a string or number, "
                        f"got {type(src).__name__}")
    p = _Parser(src)
    node = p.expr()
    if p.peek() is not None:
        raise ExprError(
            f"trailing tokens after scalar expression {src!r}")
    names = set()
    _collect_names(node, names)
    return Expr(src=src, ast=node, names=frozenset(names))


def parse_pred(src) -> Expr:
    """Parse one boolean predicate (exactly one comparison between two
    scalar expressions); raises ExprError outside the grammar."""
    if not isinstance(src, str):
        raise ExprError(f"predicate must be a string, got "
                        f"{type(src).__name__}")
    p = _Parser(src)
    node = p.compare()
    if p.peek() is not None:
        raise ExprError(f"trailing tokens after predicate {src!r}")
    names = set()
    _collect_names(node, names)
    return Expr(src=src, ast=node, names=frozenset(names))
