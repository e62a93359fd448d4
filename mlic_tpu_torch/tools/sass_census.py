"""The instruction mix of the port's CUDA kernels, read from their SASS.

No profiler traces inside a kernel on the card this port is measured on,
so the machine code is what shows where a kernel's issue slots go.  For
each ``__global__`` function of a kernel's library this prints one JSON
line: its instruction count and, for its hot loop (the backward branch
whose body holds the most FFMAs), the body's instruction count, its FFMAs,
their share and the most frequent opcodes (shared loads by width).

    python -m mlic_tpu_torch.tools.sass_census --kernel invariant_matmul
    python -m mlic_tpu_torch.tools.sass_census --source other.cu --match halo

``--kernel`` reads the library that ``ops._build`` builds (building it if
missing); ``--source`` compiles a .cu file with the same flags into a
temporary directory.  Needs the CUDA toolkit (``nvcc``, ``cuobjdump``).
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                    r"([A-Z][A-Z0-9_.]+)([^;]*);")


def _opcode(op: str) -> str:
    """The opcode without its modifiers, shared and global loads with
    their width (``LDS.128``)."""
    parts = op.split(".")
    if parts[0] in ("LDS", "LDG", "LDGSTS"):
        widths = [p for p in parts[1:] if p.isdigit()]
        return parts[0] + ("." + widths[0] if widths else "")
    return parts[0]


def census(sass: str) -> list:
    """[{function, instructions, loop_instructions, loop_ffma,
    loop_ffma_share, loop_top}] of a ``cuobjdump -sass`` listing, in its
    order (names as listed: mangled)."""
    out = []
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        name = part.split("\n", 1)[0].strip()
        ins = [(int(m.group(1), 16), m.group(2), m.group(3))
               for m in _INSTR.finditer(part)]
        best = None
        for addr, op, args in ins:
            target = re.search(r"0x([0-9a-f]+)", args)
            if not op.startswith("BRA") or not target:
                continue
            lo = int(target.group(1), 16)
            if lo >= addr:
                continue
            body = [o for a, o, _ in ins if lo <= a <= addr]
            n_ffma = sum(o.startswith("FFMA") for o in body)
            if best is None or n_ffma > best[0]:
                best = (n_ffma, body)
        row = {"function": name, "instructions": len(ins)}
        if best:
            top = collections.Counter(_opcode(o) for o in best[1])
            row.update(loop_instructions=len(best[1]), loop_ffma=best[0],
                       loop_ffma_share=best[0] / len(best[1]),
                       loop_top=top.most_common(12))
        out.append(row)
    return out


def _demangle(names: list) -> list:
    if not shutil.which("c++filt"):
        return names
    res = subprocess.run(["c++filt"], input="\n".join(names),
                         capture_output=True, text=True, check=True)
    return res.stdout.split("\n")[:len(names)]


def _cuobjdump() -> str:
    from mlic_tpu_torch.ops._build import _nvcc
    return str(Path(_nvcc()).with_name("cuobjdump"))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--kernel", help="a kernel of ops._build.KERNELS")
    src.add_argument("--source", help="a .cu file, built with the same "
                                      "flags")
    p.add_argument("--match", default="",
                   help="only functions whose demangled name holds this "
                        "regular expression")
    args = p.parse_args(argv)
    from mlic_tpu_torch.ops import _build
    with tempfile.TemporaryDirectory() as tmp:
        if args.kernel:
            lib = _build.KERNELS[args.kernel].library_path()
            if not lib.exists():
                _build.build([_build.KERNELS[args.kernel]])
        else:
            lib = Path(tmp) / "lib.so"
            subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                            str(_build.CSRC), "-o", str(lib), args.source],
                           check=True)
        sass = subprocess.run([_cuobjdump(), "-sass", str(lib)],
                              capture_output=True, text=True,
                              check=True).stdout
    rows = census(sass)
    for row, name in zip(rows, _demangle([r["function"] for r in rows])):
        row["function"] = name.replace("(anonymous namespace)::", "")
        if re.search(args.match, row["function"]):
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
