"""What the compiled kernels issue, read from their SASS listing, and the
registers and local memory they hold.

``kernels(lib)`` runs ``cuobjdump -sass`` on a built library of
``csrc/`` and returns, for each kernel instantiation, its opcode
histogram, the instructions of its largest loop and its instruction count.
The microbenchmarks bound their kernels by these counts at the SM's issue
rate, so the bound follows whatever the compiler made of each chain; a
missing listing is an error, not a bound.  ``resources(lib)`` reads
``cuobjdump -res-usage``: registers a thread and the stack and local bytes
a thread spills to.

A kernel is keyed by its name and its template arguments: integers, a
field (``"Fr"``, ``"Fq"``) and booleans (0, 1) in their order, so
``vpu_kernel<1, 4>`` is ``("vpu_kernel", (1, 4))`` and
``proj_add_kernel<Fq, true>`` is ``("proj_add_kernel", ("Fq", 1))``.
"""

from __future__ import annotations

import collections
import dataclasses
import re
import subprocess

from .. import native

# a kernel template of csrc/ (every kernel's name ends in "_kernel")
_FUNC = re.compile(r"Function\s*:?\s*(\S+?_kernel)I(\S*?)EEv")
_TARG = re.compile(r"Li(\d+)E|2(Fr|Fq)E|Lb([01])E")
_RES = re.compile(r"(\w+(?:\[\d+\])?):(\d+)")
_INSTR = re.compile(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)"
                    r"(.*)")
_LABEL = re.compile(r"\s*(\.L_x_\d+):")
_TARGET = re.compile(r"`\((\.L_x_\d+)\)|\b(0x[0-9a-f]+)\b")


@dataclasses.dataclass
class Kernel:
    hist: collections.Counter   # opcode -> count, NOPs included
    loop: int                   # instructions of the largest loop, 0 if none
    count: int                  # instructions, less NOPs and the tail branch


def _key(m: re.Match) -> tuple:
    """(kernel, template arguments) of a _FUNC match.  The mangled name
    ends in <length><name>: the shortest tail that its length prefix
    spells is the kernel's name (the namespaces before it may hold
    digits)."""
    head = m.group(1)
    name = next(head[-n:] for n in range(1, len(head))
                if head[-n].isalpha() and head[:-n].endswith(str(n)))
    args = tuple(int(i) if i else (f or int(b))
                 for i, f, b in _TARG.findall(m.group(2) + "E"))
    return name, args


def parse(text: str) -> dict:
    """{(kernel, template args): Kernel} of a ``cuobjdump -sass`` listing.
    A loop is the span from a branch's target back up to the branch; the
    tail's branch to itself is not one."""
    out, key, instrs, labels = {}, None, [], {}

    def close():
        if key is None:
            return
        addrs = {a: i for i, (a, _, _) in enumerate(instrs)}
        loop, count = 0, 0
        for i, (addr, op, rest) in enumerate(instrs):
            if op == "NOP":
                continue
            target = None
            if op == "BRA":
                m = _TARGET.search(rest)
                if m:
                    target = (labels.get(m.group(1)) if m.group(1)
                              else int(m.group(2), 16))
            if target == addr:
                continue                      # the tail's BRA to itself
            count += 1
            if target is not None and target < addr and target in addrs:
                body = instrs[addrs[target]:i + 1]
                loop = max(loop, sum(o != "NOP" for _, o, _ in body))
        hist = collections.Counter(op for _, op, _ in instrs)
        out[key] = Kernel(hist, loop, count)

    pending = []                              # labels awaiting an address
    for line in text.splitlines():
        m = _FUNC.search(line)
        if m or "Function : " in line:
            close()
            key = _key(m) if m else None
            instrs, labels, pending = [], {}, []
            continue
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSTR.match(line)
        if key and m:
            addr = int(m.group(1), 16)
            for label in pending:
                labels[label] = addr
            pending = []
            instrs.append((addr, m.group(2).split(".")[0], m.group(3)))
    close()
    return out


def parse_resources(text: str) -> dict:
    """{(kernel, template args): {"REG": .., "STACK": .., "LOCAL": .., ...}}
    of a ``cuobjdump -res-usage`` listing (each ``Function`` line followed
    by its ``KEY:value`` line)."""
    out, key = {}, None
    for line in text.splitlines():
        m = _FUNC.search(line)
        if m:
            key = _key(m)
            continue
        if key is not None:
            res = {k: int(v) for k, v in _RES.findall(line)}
            if "REG" in res:
                out[key] = res
                key = None
    return out


def listing(lib: str, what: str = "-sass") -> str:
    """``cuobjdump <what>`` of ``csrc/<lib>.cu``'s library, built if need
    be."""
    path = native.library_path(lib)
    if not path.exists():
        native.build((lib,))
    tool = native.nvcc().replace("nvcc", "cuobjdump")
    return subprocess.run([tool, what, str(path)], capture_output=True,
                          text=True, check=True).stdout


def kernels(lib: str = "microbench") -> dict:
    """``parse(listing(lib))``; raises where the listing holds no kernel."""
    found = parse(listing(lib))
    if not found:
        raise RuntimeError(f"no kernel in the SASS of {lib}")
    return found


def resources(lib: str) -> dict:
    """``parse_resources`` of ``cuobjdump -res-usage``; raises where the
    listing holds no kernel."""
    found = parse_resources(listing(lib, "-res-usage"))
    if not found:
        raise RuntimeError(f"no kernel in the resource usage of {lib}")
    return found
