"""Reading the SASS of the port's built kernels: ``cuobjdump -sass`` of a
library, split by function, parsed into instructions, and the common path
of a function's main loop (:func:`loop_path`) or of a loop-free kernel's
16-byte body (:func:`vector_path`) counted.  ``chip_smoke.py`` takes
kernel B2's issue term, kernel B3's instruction count and the
tensor-core instructions of B4's and B6's 16-bit arms
(:func:`tensor_core_count`) from it, and ``csrc/probes/sass_mix.py``
prints instruction mixes with it.  Needs the
CUDA toolkit's ``cuobjdump`` to disassemble, nothing to parse."""

import collections
import os
import re
import subprocess

LINE = re.compile(r"/\*([0-9a-f]{4,6})\*/\s+(?:@!?U?P[T\d]\s+)?([A-Z0-9_.]+)"
                  r"\s*(.*?);")
PRED = re.compile(r"/\*[0-9a-f]{4,6}\*/\s+@(!?U?P[T\d])\s")
LABEL = re.compile(r"^\s*([.$][\w$.]+):\s*$")
TARGET = re.compile(r"`\(([^)]+)\)|0x([0-9a-f]+)")
#: bits a global load or store moves, by a width suffix of its opcode
#: (``LDG.E.128``, ``STG.E.EF.64``, ``LDG.E.U8.CONSTANT``); 32 without one
WIDTH_BITS = {"U8": 8, "S8": 8, "U16": 16, "S16": 16, "64": 64, "128": 128}


def cuda_tool(tool):
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", tool)


#: the tensor cores' matrix instructions: ``mma.sync`` (HMMA) and
#: ``wgmma`` (HGMMA)
TENSOR_CORE_OPS = ("HMMA", "HGMMA")


def tensor_core_count(body):
    """Tensor-core matrix instructions (:data:`TENSOR_CORE_OPS`) in one
    function's SASS."""
    ops, _ = parse(body)
    return sum(op.split(".")[0] in TENSOR_CORE_OPS for _, op, _, _ in ops)


def opcode_mix(ops):
    return dict(collections.Counter(op.split(".")[0]
                                    for _, op, _ in ops).most_common())


def functions(sass):
    """``{mangled name: SASS text of its body}`` of a ``cuobjdump -sass``
    listing."""
    out = {}
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        name, _, body = part.partition("\n")
        out[name.strip()] = body
    return out


def parse(body):
    """One function's SASS -> ``(ops, labels)``: ``ops`` a list of
    ``(address, opcode, operands, predicated)``, ``labels`` each label's
    address (cuobjdump names branch targets by label, ``.L_x_3``, or by
    address)."""
    ops, labels, pending = [], {}, []
    for line in body.splitlines():
        lab = LABEL.match(line)
        if lab:
            pending.append(lab.group(1))
            continue
        m = LINE.search(line)
        if not m:
            continue
        addr = int(m.group(1), 16)
        for name in pending:
            labels[name] = addr
        pending = []
        pred = PRED.search(line)
        ops.append((addr, m.group(2), m.group(3),
                    bool(pred) and pred.group(1) != "PT"))
    return ops, labels


def _target(args, labels):
    m = TARGET.search(args)
    if not m:
        return None
    if m.group(1) is not None:
        return labels.get(m.group(1))
    return int(m.group(2), 16)


def width_bits(op):
    """Bits one ``LDG`` / ``STG`` of opcode ``op`` moves a thread."""
    for part in op.split(".")[1:]:
        if part in WIDTH_BITS:
            return WIDTH_BITS[part]
    return 32


def _store_floats(op):
    return width_bits(op) // 32 if op.startswith("STG") else 0


def _vector_floats(op):
    return 4 if op.startswith("STG") and width_bits(op) == 128 else 0


def _best_path(ops, labels, start, stop_at=None, end="RET",
               floats=_store_floats):
    """Bellman-Ford over the instructions from address ``start``: the path
    that stores the most floats (``floats(opcode)`` a store), and of those
    issues the fewest instructions, ending at the instruction at
    ``stop_at`` (inclusive) or, without it, at a ``RET`` (or ``end``).  A
    ``CALL`` costs its callee's shortest path to ``RET``.  Returns
    ``(floats, instructions, addresses)`` or None."""
    index = {a: i for i, (a, _, _, _) in enumerate(ops)}
    if start not in index:
        return None
    call_cost = {}

    def succ(i):
        addr, op, args, pred = ops[i]
        if stop_at is not None and addr == stop_at:
            return []
        nxt = [i + 1] if i + 1 < len(ops) else []
        if op.startswith("BRA"):
            t = _target(args, labels)
            jump = [index[t]] if t in index else []
            return jump + (nxt if pred else [])
        if op.startswith(("EXIT", "RET")):
            return nxt if pred else []
        return nxt

    def cost(i):
        addr, op, args, _ = ops[i]
        if not op.startswith("CALL"):
            return 1
        t = _target(args, labels)
        if t not in call_cost:
            call_cost[t] = None          # guards against recursion
            sub = _best_path(ops, labels, t) if t in index else None
            call_cost[t] = 1 + (sub[1] if sub else 0)
        return call_cost[t] or 1

    def better(a, b):
        return b is None or (a[0], -a[1]) > (b[0], -b[1])

    best = {index[start]: (floats(ops[index[start]][1]),
                           cost(index[start]), None)}
    changed, passes = True, 0
    while changed:
        changed, passes = False, passes + 1
        if passes > len(ops) + 1:
            raise ValueError("a cycle inside the loop stores floats")
        for i in list(best):
            stored, n, _ = best[i]
            for j in succ(i):
                cand = (stored + floats(ops[j][1]), n + cost(j), i)
                if better(cand, best.get(j)):
                    best[j] = cand
                    changed = True
    if stop_at is not None:
        ends = [index[stop_at]] if index.get(stop_at) in best else []
    else:
        ends = [i for i in best if ops[i][1].startswith(end)]
    if not ends:
        return None
    end = max(ends, key=lambda i: (best[i][0], -best[i][1]))
    path, i = [], end
    while i is not None:
        path.append(ops[i][0])
        i = best[i][2]
    return best[end][0], best[end][1], path[::-1]


def _ranges(addresses, ops):
    """Consecutive runs of instruction addresses as ``[first, last]`` hex
    pairs."""
    step = {a: b for (a, *_), (b, *_) in zip(ops, ops[1:])}
    runs = []
    for a in addresses:
        if runs and step.get(runs[-1][1]) == a:
            runs[-1][1] = a
        else:
            runs.append([a, a])
    return [[hex(a), hex(b)] for a, b in runs]


def loop_path(body):
    """The common path of one iteration of a function's main loop.

    The main loop is closed by the conditional backward branch that spans
    the most code (a grid-stride loop's ``@P BRA head``).  Its common path
    is the one from the loop head to that branch that stores the most
    floats (every element an iteration covers is stored once), and of
    those issues the fewest instructions: the special-case branches of the
    math library (``sqrtf``'s slow-path call, ``cosf``'s large-argument
    reduction) lengthen a path and are not taken, the tail guards that
    skip a store are.  Predicated instructions count, as they take an
    issue slot whether they execute or not.  Returns a dict with
    ``instructions`` and ``floats`` of the path, ``per_element`` (their
    ratio), ``constant_loads`` (the path's ``LDC`` / ``ULDC``: reads of
    the constant bank, which holds the kernel's parameters and launch
    sizes, the same values in every iteration), the path's SASS address
    ``ranges``, its opcode ``mix``, and the loop's ``head`` and
    ``back_edge`` addresses."""
    ops, labels = parse(body)
    back = [(addr - t, addr, t) for addr, op, args, pred in ops
            if op.startswith("BRA") and pred
            for t in [_target(args, labels)] if t is not None and t <= addr]
    if not back:
        raise ValueError("no conditional backward branch: no loop found")
    _, edge, head = max(back)
    found = _best_path(ops, labels, head, stop_at=edge)
    if found is None or found[0] == 0:
        raise ValueError("no path through the loop stores a float")
    floats, n, path = found
    by_addr = {a: op for a, op, _, _ in ops}
    return {"instructions": n, "floats": floats, "per_element": n / floats,
            "constant_loads": sum(1 for a in path
                                  if by_addr[a].startswith(("LDC", "ULDC"))),
            "head": hex(head), "back_edge": hex(edge),
            "ranges": _ranges(path, ops),
            "mix": opcode_mix([(a, by_addr[a], "") for a in path]),
            "loop_span_instructions": sum(1 for a, *_ in ops
                                          if head <= a <= edge)}


def vector_path(body):
    """The path of a thread through a loop-free kernel that moves a whole
    vector body: from the function's first instruction to an ``EXIT``, the
    path that stores the most floats with 128-bit stores and, of those,
    issues the fewest instructions.  That is a thread of a block with no
    ragged edge, which skips the scalar head and tail and the early exits.
    Predicated instructions count, as in :func:`loop_path`.  Returns a
    dict with ``instructions``, ``floats`` (stored by the 128-bit stores),
    ``per_element`` (their ratio: the kernel's whole issue cost an element,
    set-up included), ``constant_loads``, ``loads`` and ``stores`` (the
    path's ``LDG`` / ``STG`` by width in bits), ``ranges`` and ``mix``."""
    ops, labels = parse(body)
    if not ops:
        raise ValueError("no instructions")
    found = _best_path(ops, labels, ops[0][0], end="EXIT",
                       floats=_vector_floats)
    if found is None or found[0] == 0:
        raise ValueError("no path to EXIT stores a 128-bit vector")
    floats, n, path = found
    by_addr = {a: op for a, op, _, _ in ops}

    def widths(prefix):
        return dict(collections.Counter(
            width_bits(by_addr[a]) for a in path
            if by_addr[a].startswith(prefix)))

    return {"instructions": n, "floats": floats, "per_element": n / floats,
            "constant_loads": sum(1 for a in path
                                  if by_addr[a].startswith(("LDC", "ULDC"))),
            "loads": widths("LDG"), "stores": widths("STG"),
            "ranges": _ranges(path, ops),
            "mix": opcode_mix([(a, by_addr[a], "") for a in path])}


def disassemble(path):
    """``cuobjdump -sass`` of a cubin or of a shared library that embeds
    one."""
    return subprocess.run([cuda_tool("cuobjdump"), "-sass", path], check=True,
                          capture_output=True, text=True).stdout
