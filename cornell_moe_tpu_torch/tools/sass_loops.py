"""What the compiled descent kernels spend per (draw, training point) pair,
read from their SASS, and the time each pipe of the card needs for it.

Run on a machine with the CUDA toolkit (it builds the kernel library first):

    python -m cornell_moe_tpu_torch.tools.sass_loops [--lib PATH] [filter ...]

It disassembles the library with ``cuobjdump -sass``, finds the innermost
loops of every kernel whose mangled name holds one of the filters (default:
``descent_run``), counts each loop's instructions by opcode, and takes the
loop's ``MUFU.EX2`` count as its pairs (the field evaluates one exp per
pair).  For the main path's cold launch (S16 B200 M128 Np512, 6 steps) it
prints the time each pipe of one H100 needs at its per-SM rate: instruction
issue (4 warp instructions a clock), FP32 (128 lanes a clock), MUFU (16
lanes a clock) and shared-memory wavefronts (one a clock; an ``LDS.64`` of
a warp takes 2, an ``LDS.128`` 4), at the card's maximum SM clock from
``nvidia-smi``.  The registers and spills of each kernel come from the
build's ``ptxas -v``.  One JSON line per loop, then one per kernel with
a hash of its SASS (opcodes and operands), so that two builds of a kernel
can be compared.  ``--lib`` reads another built library instead (no
``ptxas`` report then).
"""

from __future__ import annotations

import hashlib
import json
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

from cornell_moe_tpu_torch.ops import _build

SMS = 132
MAIN_COLD_PAIRS = 16 * 200 * 128 * 512 * 6
FP32 = {"FFMA", "FADD", "FMUL", "FMNMX", "FSEL", "FSETP", "FCHK"}
INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                   r"([A-Z][A-Z0-9_.]*)([^;]*);")


def disassemble(lib: Path) -> dict:
    """{mangled kernel name: [(address, opcode, operands)]}."""
    cuobjdump = Path(_build.find_nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = INSTR.search(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2), m.group(3)))
    return funcs


def innermost_loops(code):
    """[(start, end)] of the backward branches' ranges that hold no other
    such range."""
    loops = []
    for addr, op, args in code:
        m = re.search(r"0x([0-9a-f]+)", args)
        if op.startswith("BRA") and m and int(m.group(1), 16) <= addr:
            loops.append((int(m.group(1), 16), addr))
    return [(a, b) for a, b in loops
            if not any((c, e) != (a, b) and a <= c and e <= b
                       for c, e in loops)]


def wavefronts(op: str) -> int:
    return 4 if op.endswith(".128") else 2 if op.endswith(".64") else 1


def loop_report(name, code, start, end, clock_hz) -> dict:
    body = [(op, args) for addr, op, args in code if start <= addr <= end]
    ops = Counter(op for op, _ in body)
    pairs = ops.get("MUFU.EX2", 0)
    per_pair = {k: v / pairs for k, v in ops.items()} if pairs else {}
    groups = {"total": len(body),
              "fp32": sum(v for k, v in ops.items()
                          if k.split(".")[0] in FP32),
              "mufu": sum(v for k, v in ops.items() if k.startswith("MUFU")),
              "lds_wavefronts": sum(v * wavefronts(k) for k, v in ops.items()
                                    if k.startswith("LDS")),
              "hmma": sum(v for k, v in ops.items() if k.startswith("HMMA"))}
    rec = {"kernel": name, "loop": [hex(start), hex(end)], "pairs": pairs,
           "instructions": groups, "opcodes": dict(ops.most_common())}
    if pairs:
        p = MAIN_COLD_PAIRS / SMS / pairs       # thread iterations per SM
        clocks = {"issue": groups["total"] * p / 32 / 4,
                  "fp32": groups["fp32"] * p / 128,
                  "mufu": groups["mufu"] * p / 16,
                  "shared_memory": groups["lds_wavefronts"] * p / 32}
        rec["per_pair"] = {k: round(v, 3) for k, v in per_pair.items()}
        rec["main_path_cold_ms_by_pipe"] = {
            k: v / clock_hz * 1e3 for k, v in clocks.items()}
    return rec


def main(argv) -> int:
    lib, ptxas = None, {}
    if argv[:1] == ["--lib"]:
        lib, argv = Path(argv[1]), argv[2:]
    filters = argv or ["descent_run"]
    if lib is None:
        lib = _build.build()
        ptxas = _build.ptxas_report()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    clock_hz = float(smi.split(",")[-1]) * 1e6
    for name, code in sorted(disassemble(lib).items()):
        if not any(f in name for f in filters):
            continue
        for start, end in innermost_loops(code):
            rec = loop_report(name, code, start, end, clock_hz)
            if rec["pairs"] or rec["instructions"]["hmma"]:
                print(json.dumps(rec), flush=True)
        sass = "\n".join(f"{op}{args}" for _, op, args in code)
        print(json.dumps({"kernel": name, "library": lib.name,
                          "sass_instructions": len(code),
                          "sass_sha256": hashlib.sha256(
                              sass.encode()).hexdigest()[:16],
                          "ptxas": ptxas.get(name)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
