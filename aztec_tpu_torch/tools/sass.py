"""What the compiled kernels issue, read from their SASS listing.

``kernels(lib)`` runs ``cuobjdump -sass`` on a built library of
``csrc/`` and returns, for each ``vpu_kernel`` and ``dissect_kernel``
instantiation, its opcode histogram, the instructions of its largest loop
and its instruction count.  The microbenchmarks bound their kernels by
these counts at the SM's issue rate, so the bound follows whatever the
compiler made of each chain; a missing listing is an error, not a bound.
"""

from __future__ import annotations

import collections
import dataclasses
import re
import subprocess

from .. import native

_FUNC = re.compile(r"Function : \S*?(vpu_kernel|dissect_kernel)I(\S*?)EEv")
_INSTR = re.compile(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)"
                    r"(.*)")
_LABEL = re.compile(r"\s*(\.L_x_\d+):")
_TARGET = re.compile(r"`\((\.L_x_\d+)\)|\b(0x[0-9a-f]+)\b")


@dataclasses.dataclass
class Kernel:
    hist: collections.Counter   # opcode -> count, NOPs included
    loop: int                   # instructions of the largest loop, 0 if none
    count: int                  # instructions, less NOPs and the tail branch


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
            key = ((m.group(1), tuple(int(v) for v in
                                      re.findall(r"Li(\d+)E?", m.group(2))))
                   if m else None)
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


def listing(lib: str) -> str:
    """``cuobjdump -sass`` of ``csrc/<lib>.cu``'s library, built if need be."""
    path = native.library_path(lib)
    if not path.exists():
        native.build((lib,))
    tool = native.nvcc().replace("nvcc", "cuobjdump")
    return subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, check=True).stdout


def kernels(lib: str = "microbench") -> dict:
    """``parse(listing(lib))``; raises where the listing holds no kernel."""
    found = parse(listing(lib))
    if not found:
        raise RuntimeError(f"no microbenchmark kernel in the SASS of {lib}")
    return found
