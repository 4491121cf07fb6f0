"""noir DSL (ref: noir/ — the reference's early Noir: a C-like typed
language compiled to TurboComposer gates via Boost.Spirit parser + code
gen; noir/compiler/code_gen/fixtures/sha256.noir is the canonical
program).

Python re-implementation: hand-written lexer + recursive-descent parser
(parser.py) and a tree-walking compiler (compiler.py) that lowers typed
expressions onto the circuit stdlib (UInt8/16/32/64, BoolT, FieldT) with
static for-loop unrolling — the same execution model as the reference's
code_gen (every loop bound is a compile-time constant).

Port of aztec_tpu/noir/: the same dialect and gates, over the port's
stdlib on the port's composers.
"""

from .parser import parse
from .compiler import compile_program, CompiledProgram
