"""noir -> TurboComposer code generation
(ref: noir/compiler/code_gen/ — the reference walks the AST emitting
stdlib types; uint ops become range/logic gates, bool becomes bool_t).

Execution model (matching the reference):
- every loop bound / array size / index is a compile-time constant,
- uintN values lower to stdlib UIntN (witness accumulators + turbo
  range/logic gates), bool to BoolT, field to FieldT,
- integer literals stay host ints until they meet a witness (then they
  are lifted as constants),
- functions are inlined at call sites (the reference generates one flat
  circuit per program).

compile_program(composer, src, inputs) runs `main(inputs...)`; scalar/
array inputs become witnesses.  Returns the (flattened) result values.

Port of aztec_tpu/noir/compiler.py.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from ..stdlib.field_t import BoolT, FieldT
from ..stdlib.uint import UInt8, UInt16, UInt64, UIntBase
from ..stdlib.uint32 import UInt32
from .parser import parse

UINT_CLASSES = {"uint8": UInt8, "uint16": UInt16, "uint32": UInt32,
                "uint64": UInt64}


class NoirError(Exception):
    pass


@dataclasses.dataclass
class CompiledProgram:
    composer: Any
    result: Any          # value or list of values (host-visible ints)
    result_vals: Any     # raw circuit objects


class Scope:
    def __init__(self, parent: Optional["Scope"] = None):
        self.vars: Dict[str, Any] = {}
        self.parent = parent

    def get(self, name: str):
        s = self
        while s:
            if name in s.vars:
                return s.vars[name]
            s = s.parent
        raise NoirError(f"undefined variable {name}")

    def set(self, name: str, value, declare=False):
        if declare:
            self.vars[name] = value
            return
        s = self
        while s:
            if name in s.vars:
                s.vars[name] = value
                return
            s = s.parent
        raise NoirError(f"assignment to undeclared variable {name}")


class _Return(Exception):
    def __init__(self, value):
        self.value = value


class Compiler:
    def __init__(self, composer, program):
        self.ctx = composer
        _, globals_, functions = program
        self.functions = {f[2]: f for f in functions}
        self.globals = Scope()
        for (_, ty, name, init) in globals_:
            self.globals.set(name, self._coerce(ty, self._const_eval(init)),
                             declare=True)

    # ---- value lowering ----------------------------------------------------

    def _lift(self, ty, v, as_witness: bool):
        """Host int -> circuit value of declared type."""
        base = ty[1]
        if base in UINT_CLASSES:
            cls = UINT_CLASSES[base]
            return (cls.from_witness(self.ctx, v) if as_witness
                    else cls.from_constant(self.ctx, v))
        if base == "bool":
            return (BoolT.from_witness(self.ctx, bool(v)) if as_witness
                    else BoolT.constant(bool(v)))
        if base == "field":
            return (FieldT.from_witness(self.ctx, v) if as_witness
                    else FieldT.constant(v))
        raise NoirError(f"unknown type {base}")

    def _coerce(self, ty, value):
        """Recursively lift host ints/lists per declared type (constants)."""
        if ty[2]:  # array
            elem_ty = ("type", ty[1], False, None)
            return [self._coerce(elem_ty, v) for v in value]
        if isinstance(value, int):
            return value  # keep constants host-side until used
        return value

    def _const_eval(self, node):
        """Host-side evaluation for global initializers / loop bounds."""
        v = self.eval(node, self.globals)
        return v

    # ---- function execution ------------------------------------------------

    def run(self, name: str, inputs: List[Any]):
        fn = self.functions.get(name)
        if fn is None:
            raise NoirError(f"no function {name}")
        _, ret_ty, _, params, body = fn
        scope = Scope(self.globals)
        if len(params) != len(inputs):
            raise NoirError(f"{name} expects {len(params)} args")
        for (pty, pname), val in zip(params, inputs):
            if pty[2]:  # array parameter: each element becomes a witness
                elem_ty = ("type", pty[1], False, None)
                if pty[3] is not None and len(val) != pty[3]:
                    raise NoirError(f"array arg {pname} length mismatch")
                scope.set(pname, [
                    v if not isinstance(v, int)
                    else self._lift(elem_ty, v, as_witness=True)
                    for v in val], declare=True)
            else:
                v = val if not isinstance(val, int) \
                    else self._lift(pty, val, as_witness=True)
                scope.set(pname, v, declare=True)
        try:
            self.exec_block(body, scope)
        except _Return as r:
            return r.value
        return None

    def exec_block(self, stmts, scope: Scope):
        for s in stmts:
            self.exec_stmt(s, scope)

    def exec_stmt(self, s, scope: Scope):
        kind = s[0]
        if kind == "decl":
            _, ty, name, init = s
            if init is None:
                if ty[2]:  # uninitialized array needs a static size
                    if ty[3] is None:
                        raise NoirError(f"unsized array {name} needs init")
                    val = [0] * ty[3]
                else:
                    val = 0
            else:
                val = self.eval(init, scope)
            scope.set(name, val, declare=True)
        elif kind == "assign":
            _, lhs, rhs = s
            value = self.eval(rhs, scope)
            self.assign(lhs, value, scope)
        elif kind == "for":
            _, var, lo, hi, body = s
            lo_v = self.eval(lo, scope)
            hi_v = self.eval(hi, scope)
            if not isinstance(lo_v, int) or not isinstance(hi_v, int):
                raise NoirError("loop bounds must be compile-time constants")
            for i in range(lo_v, hi_v):
                inner = Scope(scope)
                inner.set(var, i, declare=True)
                self.exec_block(body, inner)
        elif kind == "if":
            _, cond, then, els = s
            c = self.eval(cond, scope)
            if isinstance(c, BoolT):
                c = c.get_value()  # static only; ref noir has no phi nodes
            self.exec_block(then if c else els, Scope(scope))
        elif kind == "return":
            raise _Return(self.eval(s[1], scope))
        elif kind == "expr":
            self.eval(s[1], scope)
        else:
            raise NoirError(f"bad stmt {kind}")

    def assign(self, lhs, value, scope: Scope):
        if lhs[0] == "var":
            scope.set(lhs[1], value)
        elif lhs[0] == "index":
            arr = self.eval(lhs[1], scope)
            idx = self.eval(lhs[2], scope)
            if not isinstance(idx, int):
                raise NoirError("array indices must be constants")
            arr[idx] = value
        else:
            raise NoirError("bad assignment target")

    # ---- expressions -------------------------------------------------------

    def eval(self, e, scope: Scope):
        kind = e[0]
        if kind == "num":
            return e[1]
        if kind == "var":
            return scope.get(e[1])
        if kind == "array":
            return [self.eval(x, scope) for x in e[1]]
        if kind == "index":
            arr = self.eval(e[1], scope)
            idx = self.eval(e[2], scope)
            if not isinstance(idx, int):
                raise NoirError("array indices must be constants")
            return arr[idx]
        if kind == "call":
            args = [self.eval(a, scope) for a in e[2]]
            return self.run(e[1], args)
        if kind == "un":
            v = self.eval(e[2], scope)
            op = e[1]
            if isinstance(v, int):
                return {"~": lambda x: ~x, "!": lambda x: int(not x),
                        "-": lambda x: -x}[op](v)
            if op in ("~", "!"):
                return ~v
            if op == "-":
                return v * (-1) if isinstance(v, FieldT) else \
                    type(v).from_constant(self.ctx, 0) - v
        if kind == "bin":
            return self.binop(e[1], self.eval(e[2], scope),
                              self.eval(e[3], scope))
        raise NoirError(f"bad expr {kind}")

    def binop(self, op, a, b):
        if isinstance(a, int) and isinstance(b, int):
            return {
                "+": a + b, "-": a - b, "*": a * b,
                "/": a // b if b else 0, "%": a % b if b else 0,
                "^": a ^ b, "&": a & b, "|": a | b,
                "<<": a << b, ">>": a >> b,
                ">>>": a >> b,  # host ror needs a width; forbid on ints
                "==": int(a == b), "!=": int(a != b),
                "<": int(a < b), ">": int(a > b),
                "<=": int(a <= b), ">=": int(a >= b),
                "&&": int(bool(a) and bool(b)),
                "||": int(bool(a) or bool(b)),
            }[op]
        # lift the int side to the circuit type of the other side
        if isinstance(a, int):
            a = self._lift_like(b, a)
        if isinstance(b, int) and op not in ("<<", ">>", ">>>"):
            b = self._lift_like(a, b)
        if op == "+":
            return a + b
        if op == "-":
            return a - b
        if op == "*":
            return a * b
        if op == "^":
            return a ^ b
        if op == "&":
            return a & b
        if op == "|":
            return a | b
        if op == "<<":
            return a << b
        if op == ">>":
            return a >> b
        if op == ">>>":
            return a.ror(b)
        if op in ("==", "!="):
            if isinstance(a, UIntBase):
                fa = FieldT(a.ctx, a.witness_index, 0, 1)
                fb = FieldT(b.ctx, b.witness_index, 0, 1)
                eq = (fa - fb).is_zero()
            else:
                eq = (a - b).is_zero()
            return ~eq if op == "!=" else eq
        raise NoirError(f"unsupported circuit operator {op}")

    def _lift_like(self, template, v: int):
        if isinstance(template, UIntBase):
            return type(template).from_constant(self.ctx, v)
        if isinstance(template, FieldT):
            return FieldT.constant(v)
        raise NoirError("cannot lift constant")


def compile_program(composer, src: str, inputs: List[Any],
                    entry: str = "main") -> CompiledProgram:
    """Parse + run `entry` over the inputs, emitting gates into
    `composer` (ref: noir/cli/main.cpp:27-50)."""
    c = Compiler(composer, parse(src))
    result_vals = c.run(entry, inputs)

    def host(v):
        if isinstance(v, list):
            return [host(x) for x in v]
        if hasattr(v, "get_value"):
            return v.get_value()
        return v

    return CompiledProgram(composer, host(result_vals), result_vals)
