"""The SASS of the kernels two kernel libraries share, compared with their
parameter offsets aside.

    python -m fora_tpu_torch.probes.sass_diff LIB_A LIB_B [--match SUB ...]

For each kernel (a ``Function :`` of ``cuobjdump -sass``) whose mangled
name is in both libraries and holds one of the ``--match`` substrings (all
kernels by default), it prints whether its instructions are identical,
or their counts and the number of lines that differ.  An instruction is
its text without address and encoding, each ``c[0x0][0x...]`` (a
reference into the kernel's parameter block) read as ``c[0x0][P]``, so a
struct of arguments that grew or moved changes nothing; the names are
matched with the anonymous namespace's file hash aside.  It needs
``cuobjdump`` (the CUDA toolkit's) and exits 1 if a matched kernel
differs.
"""

from __future__ import annotations

import argparse
import difflib
import re
import shutil
import subprocess
import sys

_PARAM = re.compile(r"c\[0x0\]\[0x[0-9a-f]+\]")
# the anonymous namespace's tag in a mangled name, which hashes the file
_ANON = re.compile(r"_GLOBAL__N__[0-9a-f]{8}_\d+_\w+?_cu_[0-9a-f]{8}")
_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;")


def functions(lib: str) -> dict:
    """{mangled name: [normalised instructions]} of ``lib``'s SASS."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            name = _ANON.sub("_GLOBAL__N_", line.split("Function :")[1].strip())
            out[name] = []
        elif name is not None:
            m = _INSN.search(line)
            if m:
                out[name].append(_PARAM.sub("c[0x0][P]", m.group(1)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("lib_a")
    ap.add_argument("lib_b")
    ap.add_argument("--match", nargs="*", default=[""])
    args = ap.parse_args(argv)
    a, b = functions(args.lib_a), functions(args.lib_b)
    differ = 0
    for name in sorted(set(a) & set(b)):
        if not any(m in name for m in args.match):
            continue
        if a[name] == b[name]:
            print(f"identical ({len(a[name])} instructions): {name}")
            continue
        differ += 1
        changed = sum(1 for d in difflib.ndiff(a[name], b[name])
                      if d[:1] in "+-")
        print(f"DIFFERS ({len(a[name])} against {len(b[name])} "
              f"instructions, {changed} lines changed): {name}")
    only = sorted(n for n in set(a) ^ set(b)
                  if any(m in n for m in args.match))
    for name in only:
        print(f"in one library only: {name}")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
