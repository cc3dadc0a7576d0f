"""Tensor functor: HPAC-ML's symbolic slice DSL (paper Fig. 3, top).

A functor declares, for symbolic sweep coordinates (s-constants), how
application-memory elements form one tensor entry:

    ifn = tensor_functor("ifnctr: [i, j, 0:5] = ([i-1,j],[i+1,j],[i,j-1:j+2])")

The string grammar mirrors the paper's pragma:
    ss-specifier ::= '[' s-slice, ... ']'
    s-slice      ::= s-expr [ ':' [s-expr] [ ':' [s-expr] ] ]
    s-expr       ::= s-constant | int | s-expr ('+'|'-'|'*') s-expr

Functors can also be built programmatically from ``sym`` objects.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Optional, Sequence, Union


# ------------------------------ symbolic expressions -----------------------
@dataclass(frozen=True)
class SymExpr:
    """affine expression: sum_i coeff[s_i] * s_i + const"""
    coeffs: tuple  # tuple[(name, coeff), ...] sorted
    const: int = 0

    @staticmethod
    def of(x) -> "SymExpr":
        if isinstance(x, SymExpr):
            return x
        if isinstance(x, int):
            return SymExpr((), x)
        raise TypeError(x)

    def __add__(self, o):
        o = SymExpr.of(o)
        d = dict(self.coeffs)
        for n, c in o.coeffs:
            d[n] = d.get(n, 0) + c
        return SymExpr(tuple(sorted((n, c) for n, c in d.items() if c)),
                       self.const + o.const)

    def __radd__(self, o):
        return self.__add__(o)

    def __sub__(self, o):
        return self + SymExpr.of(o) * -1

    def __rsub__(self, o):
        return SymExpr.of(o) + self * -1

    def __mul__(self, k: int):
        if isinstance(k, SymExpr):
            if k.coeffs and self.coeffs:
                raise ValueError("non-affine symbolic expression")
            if k.coeffs:  # constant * symbol
                return k * self.const
            k = k.const
        return SymExpr(tuple((n, c * k) for n, c in self.coeffs),
                       self.const * k)

    __rmul__ = __mul__

    @property
    def symbols(self):
        return tuple(n for n, _ in self.coeffs)

    def evaluate(self, env: dict) -> int:
        return self.const + sum(c * env[n] for n, c in self.coeffs)

    def __repr__(self):
        parts = [f"{'' if c == 1 else c}{n}" for n, c in self.coeffs]
        if self.const or not parts:
            parts.append(str(self.const))
        return "+".join(parts).replace("+-", "-")


def sym(name: str) -> SymExpr:
    """An s-constant: a placeholder concretized when the functor is mapped."""
    return SymExpr(((name, 1),), 0)


@dataclass(frozen=True)
class SSlice:
    """One s-slice: a point (stop None) or a [start:stop:step) range."""
    start: SymExpr
    stop: Optional[SymExpr] = None
    step: int = 1

    @property
    def is_point(self):
        return self.stop is None

    def n_elements(self) -> int:
        """Static element count (start/stop must differ by a constant)."""
        if self.is_point:
            return 1
        diff = self.stop - self.start
        if diff.coeffs:
            raise ValueError(f"slice extent must be constant, got {diff}")
        return max(0, -(-diff.const // self.step))


def _as_sslice(x) -> SSlice:
    if isinstance(x, SSlice):
        return x
    if isinstance(x, slice):
        return SSlice(SymExpr.of(x.start if x.start is not None else 0),
                      SymExpr.of(x.stop) if x.stop is not None else None,
                      x.step if x.step is not None else 1)
    return SSlice(SymExpr.of(x))


# ------------------------------ grammar parser -----------------------------
_TOK = re.compile(r"\s*(\d+|[A-Za-z_]\w*|[\[\]():,+\-*=])")


def _tokens(s: str):
    out, i = [], 0
    while i < len(s):
        m = _TOK.match(s, i)
        if not m:
            raise SyntaxError(f"bad functor syntax at: {s[i:i+20]!r}")
        out.append(m.group(1))
        i = m.end()
    return out


class _Parser:
    def __init__(self, toks):
        self.toks, self.i = toks, 0

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else None

    def eat(self, t=None):
        cur = self.peek()
        if t is not None and cur != t:
            raise SyntaxError(f"expected {t!r}, got {cur!r}")
        self.i += 1
        return cur

    def expr(self):
        # term (('+'|'-') term)*
        e = self.term()
        while self.peek() in ("+", "-"):
            op = self.eat()
            t = self.term()
            e = e + t if op == "+" else e - t
        return e

    def term(self):
        f = self.factor()
        while self.peek() == "*":
            self.eat()
            g = self.factor()
            e = f * g if isinstance(g, (int, SymExpr)) else None
            f = e
        return f

    def factor(self):
        t = self.peek()
        if t == "-":
            self.eat()
            return self.factor() * -1
        if t == "(":
            self.eat("(")
            e = self.expr()
            self.eat(")")
            return e
        self.eat()
        if t.isdigit():
            return SymExpr.of(int(t))
        return sym(t)

    def sslice(self):
        start = self.expr()
        stop, step = None, 1
        if self.peek() == ":":
            self.eat()
            stop = self.expr()
            if self.peek() == ":":
                self.eat()
                step = self.expr().const
        return SSlice(start, stop, step)

    def ss_specifier(self):
        self.eat("[")
        slices = [self.sslice()]
        while self.peek() == ",":
            self.eat()
            slices.append(self.sslice())
        self.eat("]")
        return tuple(slices)


@dataclass(frozen=True)
class TensorFunctor:
    """LHS shape spec + RHS element-access slices (paper §III-B)."""
    name: str
    lhs: tuple  # tuple[SSlice]
    rhs: tuple  # tuple[tuple[SSlice]]

    @property
    def sweep_symbols(self):
        """Symbols defining the sweep (point slices of the LHS)."""
        out = []
        for s in self.lhs:
            for n in s.start.symbols:
                if n not in out:
                    out.append(n)
            if s.stop is not None:
                for n in s.stop.symbols:
                    if n not in out:
                        out.append(n)
        return tuple(out)

    @property
    def n_features(self):
        return sum(_slice_elems(sl) for sl in self.rhs)

    def map(self, array, ranges, direction="to"):
        from repro_torch.core.tensor_map import TensorMap
        return TensorMap(self, array, ranges, direction)

    def __repr__(self):
        return f"TensorFunctor({self.name}: {list(self.lhs)} = {list(self.rhs)})"


def _slice_elems(slice_group: Sequence[SSlice]) -> int:
    n = 1
    for s in slice_group:
        n *= s.n_elements()
    return n


def tensor_functor(decl: Union[str, None] = None, *, name=None, lhs=None,
                   rhs=None) -> TensorFunctor:
    """Declare a functor from the pragma-style string or from DSL objects.

    String form:  "name: [i, j, 0:5] = ([i-1,j], [i+1,j], [i,j-1:j+2])"
    """
    if decl is not None:
        head, _, body = decl.partition(":")
        name = head.strip()
        lhs_s, _, rhs_s = body.partition("=")
        p = _Parser(_tokens(lhs_s.strip()))
        lhs_t = p.ss_specifier()
        p = _Parser(_tokens(rhs_s.strip()))
        p.eat("(")
        groups = [p.ss_specifier()]
        while p.peek() == ",":
            p.eat()
            groups.append(p.ss_specifier())
        p.eat(")")
        return TensorFunctor(name, lhs_t, tuple(groups))
    lhs_t = tuple(_as_sslice(s) for s in lhs)
    rhs_t = tuple(tuple(_as_sslice(s) for s in grp) for grp in rhs)
    return TensorFunctor(name or "functor", lhs_t, rhs_t)
