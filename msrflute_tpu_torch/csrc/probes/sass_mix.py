#!/usr/bin/env python3
"""Instruction mix of the port's compiled kernels, from the SASS.

    python3 msrflute_tpu_torch/csrc/probes/sass_mix.py [source.cu] [name ...]
    python3 msrflute_tpu_torch/csrc/probes/sass_mix.py --loop lib.so name

Compiles ``source.cu`` (default ``../flash_attention.cu``) for ``sm_90a``
with the port's flags, disassembles it with ``cuobjdump -sass`` and prints
one JSON line for each entry function whose mangled name holds one of the
``name`` pieces (default: the D = 32 instances of the flash-attention
backward): its instruction count, its opcode counts, and the opcode counts
of each basic block of 200 instructions or more, which are the unrolled
bodies a thread runs once a tile.  Needs the CUDA toolkit, no card.  The
share of FFMA among a body's instructions is the most of the FMA pipes'
time that body can use: every instruction takes a slot of a scheduler.

``--loop`` reads an already built library (or cubin) instead and prints
:func:`loop_path` of the named entry function: the instructions a thread
issues on the common path of one iteration of its main loop, and the
floats that path stores; ``chip_smoke.py`` takes kernel B2's issue term
from the same function (``msrflute_tpu_torch/ops/sass.py``).
"""

import json
import os
import re
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "..", ".."))

from msrflute_tpu_torch.ops.sass import (  # noqa: E402
    LINE, cuda_tool, disassemble, functions, loop_path, opcode_mix)

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3")


def _blocks(ops):
    """Split ``[(address, opcode, operands)]`` at branch targets and after
    branches."""
    targets = {int(m.group(1), 16) for _, op, args in ops
               if op.startswith("BRA")
               for m in [re.search(r"0x([0-9a-f]+)", args)] if m}
    blocks, cur = [], []
    for addr, op, args in ops:
        if addr in targets and cur:
            blocks.append(cur)
            cur = []
        cur.append((addr, op, args))
        if op.startswith(("BRA", "EXIT", "RET")):
            blocks.append(cur)
            cur = []
    return blocks + ([cur] if cur else [])


def main(argv):
    if argv[:1] == ["--loop"]:
        lib, name = argv[1], argv[2]
        for fn, body in functions(disassemble(lib)).items():
            if name in fn:
                print(json.dumps({"function": fn, **loop_path(body)}))
        return 0
    source = argv[0] if argv else os.path.join(HERE, "..",
                                               "flash_attention.cu")
    names = argv[1:] or ["flash_dq_kernelILi32E", "flash_dkv_kernelILi32E"]
    with tempfile.TemporaryDirectory() as tmp:
        cubin = os.path.join(tmp, "kernels.cubin")
        subprocess.run([cuda_tool("nvcc"), *NVCC_FLAGS, "-cubin", "-o", cubin,
                        source], check=True, capture_output=True)
        sass = disassemble(cubin)
    for name, body in functions(sass).items():
        if not any(n in name for n in names):
            continue
        ops = [(int(m.group(1), 16), m.group(2), m.group(3))
               for m in map(LINE.search, body.splitlines()) if m]
        print(json.dumps({
            "function": name, "instructions": len(ops), "mix": opcode_mix(ops),
            "bodies": [{"at": hex(b[0][0]), "instructions": len(b),
                        "mix": opcode_mix(b)}
                       for b in _blocks(ops) if len(b) >= 200]}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
