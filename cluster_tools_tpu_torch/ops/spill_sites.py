"""Where a kernel library's register spills sit in the source.

Compiles ``csrc/<name>.cu`` to a cubin with the build's own flags plus
``-lineinfo`` (which changes no code), disassembles it with ``nvdisasm -g``
and prints, per kernel, each source line that carries local-memory loads or
stores (``LDL``/``STL``, the spill traffic ``ptxas -v`` reports in bytes),
with the counts of each and the phase comment (``// -- ...``) above the
line.  Needs the CUDA toolkit::

    python -m cluster_tools_tpu_torch.ops.spill_sites dtws
"""

from __future__ import annotations

import collections
import os
import re
import subprocess
import sys

from . import _build

_FILE_LINE = re.compile(r'//## File "([^"]+)", line (\d+)')
_FUNC = re.compile(r"^\s*\.text\.(\S+):")


def _phase(path: str, line: int) -> str:
    """The last ``// -- `` comment at or above ``line`` of ``path``."""
    try:
        with open(path) as f:
            lines = f.readlines()
    except OSError:
        return ""
    for k in range(min(line, len(lines)) - 1, -1, -1):
        if lines[k].lstrip().startswith("// -- "):
            return lines[k].strip()[6:].strip(" -")
    return ""


def spill_sites(name: str) -> dict:
    """{kernel: {(file, line): Counter(LDL=..., STL=...)}} of ``csrc/<name>.cu``."""
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    cubin = os.path.join(_build.BUILD_DIR, f"{name}-lineinfo.cubin")
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    subprocess.run([_build.nvcc(), *flags, "-lineinfo", "-cubin", "-o", cubin,
                    os.path.join(_build.CSRC, name + ".cu")], check=True,
                   stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    nvdisasm = os.path.join(os.path.dirname(_build.nvcc()), "nvdisasm")
    sass = subprocess.run([nvdisasm, "-g", "-c", cubin], check=True, capture_output=True,
                          text=True).stdout
    sites: dict = collections.defaultdict(lambda: collections.defaultdict(collections.Counter))
    func, where = "?", ("?", 0)
    for text in sass.splitlines():
        m = _FUNC.match(text)
        if m:
            func = m.group(1)
            continue
        m = _FILE_LINE.search(text)
        if m:
            where = (m.group(1), int(m.group(2)))
            continue
        for op in ("LDL", "STL"):
            if re.search(rf"\b{op}\b", text):
                sites[func][where][op] += 1
    return sites


def main(argv) -> int:
    for name in argv or ["dtws"]:
        for func, lines in spill_sites(name).items():
            print(f"{name}: {func}")
            for (path, line), n in sorted(lines.items()):
                print(f"  {os.path.basename(path)}:{line} LDL {n['LDL']} STL {n['STL']}"
                      f"  [{_phase(path, line)}]")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
