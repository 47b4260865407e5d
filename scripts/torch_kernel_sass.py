"""Count instructions in the SASS of the torch port's CUDA kernels.

Builds the named kernels of ``src/repro_torch/csrc`` as the port does
(``repro_torch.kernels.build``), dumps each library's SASS with
``cuobjdump -sass`` and counts the given opcodes in every kernel
function, beside the ``-Xptxas -v`` register and spill lines of the
build.  Needs the CUDA toolkit (``nvcc``, ``cuobjdump``), not a card:

    PYTHONPATH=src python3 scripts/torch_kernel_sass.py flash_attention \\
        --ops HMMA LDGSTS

prints one JSON object per kernel: ``{"kernel", "functions": {name:
{opcode: count}}, "total": {opcode: count}, "ptxas": [lines]}``.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
from pathlib import Path

from repro_torch import kernels

# "/*0a30*/  @!P0 HMMA.1688.F32.TF32 R4, R8, R12, R4 ;"
_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)")


def _cuobjdump() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "cuobjdump"
    found = str(cand) if cand.is_file() else shutil.which("cuobjdump")
    if found is None:
        raise SystemExit("cuobjdump not found (set CUDA_HOME)")
    return found


def count(sass: str, ops) -> dict:
    """{function: {opcode: count}} over a ``cuobjdump -sass`` listing,
    an opcode matching its base name (``HMMA`` counts
    ``HMMA.1688.F32.TF32``)."""
    out, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            out[fn] = dict.fromkeys(ops, 0)
            continue
        m = _INSN.search(line)
        if fn is not None and m and m.group(1) in out[fn]:
            out[fn][m.group(1)] += 1
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("names", nargs="+", choices=kernels.KERNELS)
    ap.add_argument("--ops", nargs="+", default=["HMMA", "LDGSTS"])
    args = ap.parse_args()
    kernels.build(args.names)
    for name in args.names:
        lib = kernels.library_path(name)
        sass = subprocess.run([_cuobjdump(), "-sass", str(lib)],
                              capture_output=True, text=True, check=True,
                              timeout=300).stdout
        fns = count(sass, args.ops)
        log = lib.with_suffix(".log").read_text()
        print(json.dumps({
            "kernel": name,
            "functions": fns,
            "total": {op: sum(f[op] for f in fns.values())
                      for op in args.ops},
            "ptxas": [l.strip() for l in log.splitlines()
                      if "registers" in l or "spill" in l
                      or "Compiling entry" in l]}), flush=True)


if __name__ == "__main__":
    main()
