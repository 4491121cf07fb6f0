"""Lexer + recursive-descent parser for the noir subset
(ref: noir/compiler/parser/grammar.hpp — expressions with C precedence,
typed declarations, arrays, for-in-range loops, functions).

AST nodes are plain tuples (kind, ...); see compiler.py for consumption.

Port of aztec_tpu/noir/parser.py.
"""

from __future__ import annotations

import re
from typing import List, Optional, Tuple

KEYWORDS = {"for", "in", "return", "true", "false", "bool", "field",
            "uint8", "uint16", "uint32", "uint64", "if", "else"}

TOKEN_RE = re.compile(r"""
    (?P<ws>\s+|//[^\n]*|/\*.*?\*/)
  | (?P<num>0x[0-9a-fA-F]+|\d+)
  | (?P<ident>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<op>>>>|<<|>>|==|!=|<=|>=|\.\.|&&|\|\||[-+*/%^&|~!<>=(){}\[\],;])
""", re.VERBOSE | re.DOTALL)


def tokenize(src: str) -> List[Tuple[str, str]]:
    out, pos = [], 0
    while pos < len(src):
        m = TOKEN_RE.match(src, pos)
        if not m:
            raise SyntaxError(f"noir: bad character {src[pos]!r} at {pos}")
        pos = m.end()
        if m.lastgroup == "ws":
            continue
        kind, text = m.lastgroup, m.group()
        if kind == "ident" and text in KEYWORDS:
            kind = text
        out.append((kind, text))
    out.append(("eof", ""))
    return out


class Parser:
    def __init__(self, tokens):
        self.toks = tokens
        self.i = 0

    def peek(self, k=0):
        return self.toks[min(self.i + k, len(self.toks) - 1)]

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, kind_or_text):
        t = self.next()
        if t[0] != kind_or_text and t[1] != kind_or_text:
            raise SyntaxError(f"noir: expected {kind_or_text}, got {t}")
        return t

    def accept(self, kind_or_text) -> bool:
        t = self.peek()
        if t[0] == kind_or_text or t[1] == kind_or_text:
            self.i += 1
            return True
        return False

    # ---- types -------------------------------------------------------------

    TYPE_NAMES = ("bool", "field", "uint8", "uint16", "uint32", "uint64")

    def at_type(self) -> bool:
        return self.peek()[0] in self.TYPE_NAMES

    def parse_type(self):
        base = self.next()[0]
        size: Optional[int] = None
        is_array = False
        if self.accept("["):
            is_array = True
            if not self.accept("]"):
                size = int(self.expect("num")[1], 0)
                self.expect("]")
        return ("type", base, is_array, size)

    # ---- program -----------------------------------------------------------

    def parse_program(self):
        globals_, functions = [], []
        while self.peek()[0] != "eof":
            ty = self.parse_type()
            name = self.expect("ident")[1]
            if self.peek()[1] == "(":
                functions.append(self.parse_function(ty, name))
            else:
                self.expect("=")
                init = self.parse_expr()
                self.expect(";")
                globals_.append(("global", ty, name, init))
        return ("program", globals_, functions)

    def parse_function(self, ret_ty, name):
        self.expect("(")
        params = []
        if not self.accept(")"):
            while True:
                pty = self.parse_type()
                pname = self.expect("ident")[1]
                params.append((pty, pname))
                if not self.accept(","):
                    break
            self.expect(")")
        body = self.parse_block()
        return ("function", ret_ty, name, params, body)

    def parse_block(self):
        self.expect("{")
        stmts = []
        while not self.accept("}"):
            stmts.append(self.parse_stmt())
        return stmts

    # ---- statements --------------------------------------------------------

    def parse_stmt(self):
        t = self.peek()
        if t[0] == "for":
            self.next()
            self.expect("(")
            var = self.expect("ident")[1]
            self.expect("in")
            lo = self.parse_expr()
            self.expect("..")
            hi = self.parse_expr()
            self.expect(")")
            body = self.parse_block()
            return ("for", var, lo, hi, body)
        if t[0] == "return":
            self.next()
            e = self.parse_expr()
            self.expect(";")
            return ("return", e)
        if t[0] == "if":
            self.next()
            self.expect("(")
            cond = self.parse_expr()
            self.expect(")")
            then = self.parse_block()
            els = self.parse_block() if self.accept("else") else []
            return ("if", cond, then, els)
        if self.at_type():
            ty = self.parse_type()
            name = self.expect("ident")[1]
            init = None
            if self.accept("="):
                init = self.parse_expr()
            self.expect(";")
            return ("decl", ty, name, init)
        # assignment or bare expression
        e = self.parse_expr()
        if self.accept("="):
            rhs = self.parse_expr()
            self.expect(";")
            return ("assign", e, rhs)
        self.expect(";")
        return ("expr", e)

    # ---- expressions (precedence climbing) ---------------------------------

    BINOPS = [  # lowest to highest
        ("||",), ("&&",), ("|",), ("^",), ("&",),
        ("==", "!="), ("<", ">", "<=", ">="),
        ("<<", ">>", ">>>"), ("+", "-"), ("*", "/", "%"),
    ]

    def parse_expr(self, level: int = 0):
        if level == len(self.BINOPS):
            return self.parse_unary()
        lhs = self.parse_expr(level + 1)
        while self.peek()[1] in self.BINOPS[level] \
                and self.peek()[0] == "op":
            op = self.next()[1]
            rhs = self.parse_expr(level + 1)
            lhs = ("bin", op, lhs, rhs)
        return lhs

    def parse_unary(self):
        t = self.peek()
        if t[1] in ("~", "!", "-") and t[0] == "op":
            self.next()
            return ("un", t[1], self.parse_unary())
        return self.parse_postfix()

    def parse_postfix(self):
        e = self.parse_primary()
        while True:
            if self.accept("["):
                idx = self.parse_expr()
                self.expect("]")
                e = ("index", e, idx)
            elif self.peek()[1] == "(" and e[0] == "var":
                self.next()
                args = []
                if not self.accept(")"):
                    while True:
                        args.append(self.parse_expr())
                        if not self.accept(","):
                            break
                    self.expect(")")
                e = ("call", e[1], args)
            else:
                return e

    def parse_primary(self):
        t = self.next()
        if t[0] == "num":
            return ("num", int(t[1], 0))
        if t[0] == "true":
            return ("num", 1)
        if t[0] == "false":
            return ("num", 0)
        if t[0] == "ident":
            return ("var", t[1])
        if t[1] == "(":
            e = self.parse_expr()
            self.expect(")")
            return e
        if t[1] == "[":
            elems = []
            if not self.accept("]"):
                while True:
                    elems.append(self.parse_expr())
                    if not self.accept(","):
                        break
                self.expect("]")
            return ("array", elems)
        raise SyntaxError(f"noir: unexpected token {t}")


def parse(src: str):
    return Parser(tokenize(src)).parse_program()
