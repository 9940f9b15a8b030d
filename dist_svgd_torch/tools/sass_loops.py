"""The loops of a kernel's SASS: their sizes and instruction mix, from the
output of ``cuobjdump -sass`` (which sits beside ``nvcc`` on the card).

    cuobjdump -sass build/dist_svgd_torch/libphi_big_d-<hash>.so > sass.txt
    python -m dist_svgd_torch.tools.sass_loops sass.txt [FUNCTION-SUBSTRING]

A loop is a backward branch: its body is every instruction from the
branch's target to the branch.  Bodies nest (an outer loop contains its
inner loops once), so instructions a pair are counted from a body and its
trip count, not from the listing's total.  One JSON row a function that
matches: its instruction count and each loop's address range, size and
most frequent opcodes (predicates and modifiers stripped).
"""

from __future__ import annotations

import argparse
import collections
import json
import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence

_INSTRUCTION = re.compile(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);")
_BACKWARD = re.compile(r"\bBRA\b.*?(0x[0-9a-f]+)")


def opcode(text: str) -> str:
    """The opcode of one SASS instruction, without its predicate and
    modifiers: ``@!P0 FFMA.FTZ R1, ...`` → ``FFMA``."""
    return re.sub(r"^@!?U?P\w+\s+", "", text).split()[0].split(".")[0]


def loops(sass: str, want: str = "", top: int = 12) -> List[Dict]:
    """One row a function of ``sass`` whose name contains ``want``."""
    rows = []
    for block in re.split(r"\n\s+Function : ", sass)[1:]:
        name = block.split("\n", 1)[0].strip()
        if want not in name:
            continue
        code = [(int(m.group(1), 16), m.group(2).strip())
                for m in _INSTRUCTION.finditer(block)]
        found = []
        for addr, text in code:
            branch = _BACKWARD.search(text)
            if branch and int(branch.group(1), 16) < addr:
                start = int(branch.group(1), 16)
                body = [t for a, t in code if start <= a <= addr]
                mix = collections.Counter(opcode(t) for t in body)
                found.append({"start": hex(start), "end": hex(addr), "instructions": len(body),
                              "opcodes": dict(mix.most_common(top))})
        rows.append({"function": name, "instructions": len(code), "loops": found})
    return rows


def main(argv: Optional[Sequence[str]] = None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sass", type=Path, help="the output of cuobjdump -sass")
    ap.add_argument("function", nargs="?", default="",
                    help="a substring of the (mangled) function names to report")
    args = ap.parse_args(argv)
    rows = loops(args.sass.read_text(), args.function)
    for row in rows:
        print(json.dumps(row))
    return rows


if __name__ == "__main__":
    main()
