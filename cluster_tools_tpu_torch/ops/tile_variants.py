"""Other choices of the tile kernels' design (kernels 3 and 5,
``csrc/tile_scan.cuh``), written out as checkouts for ``chip_smoke.py
--compare``.

Each variant is a copy of this package whose CUDA sources differ from the
kept design in one choice, by a textual substitution that must match its
source exactly once:

- ``k3_T512``: kernel 3 at 512 threads per CTA (kept: 256);
- ``k5_T256``: kernel 5 at 256 threads per CTA (kept: 128);
- ``run4``: runs of at most 4 elements, so 32 lanes (a warp) sweep a row
  of 128 and 16 a column of 64 (kept: runs of 16, 8 and 4 lanes);
- ``run8``: runs of at most 8 (16 lanes per row of 128, 8 per column);
- ``every_line``: every line of the tile swept in every round (kept: only
  the lines that another axis changed since their last sweep);
- ``two_pass``: a line swept forward, then backward from what the forward
  sweep stored (kept: both at once from one load, the lesser of the two).

Every variant computes the same function, and kernel 3 the same rounds per
tile, so ``chip_smoke.py --compare`` holds each to the kept design's output
while it times them in turns.  The variants' libraries are built here, one
``nvcc`` per source of each, all at once.  Needs the CUDA toolkit::

    python -m cluster_tools_tpu_torch.ops.tile_variants build/variants
    python3 chip_smoke.py --kernels-only --compare build/variants/run4 ...
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
from typing import Dict, Sequence, Tuple

_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# name -> (csrc file, text of the kept design, text of the variant)
VARIANTS: Dict[str, Tuple[str, str, str]] = {
    "k3_T512": ("flood3d.cuh", "#define CTT_K3_THREADS 256", "#define CTT_K3_THREADS 512"),
    "k5_T256": ("cc.cuh", "#define CTT_K5_THREADS 128", "#define CTT_K5_THREADS 256"),
    "run4": ("tile_scan.cuh", "#define CTT_TS_RUN 16", "#define CTT_TS_RUN 4"),
    "run8": ("tile_scan.cuh", "#define CTT_TS_RUN 16", "#define CTT_TS_RUN 8"),
    "every_line": ("tile_scan.cuh", "stamp[i] >= rr;", "rr >= 0;"),
    "two_pass": ("tile_scan.cuh", "if (nseg == 1) {", "if (false) {"),
}
BUILD = r"""
from cluster_tools_tpu_torch.ops import _build
_build.build_all(["flood3d", "cc"])
"""


def write(root: str, names: Sequence[str] = tuple(VARIANTS)) -> Dict[str, str]:
    """Writes each variant's checkout under ``root`` (replacing an older
    one) and returns its directory."""
    dirs = {}
    for name in names:
        src, kept, other = VARIANTS[name]
        d = os.path.join(os.path.abspath(root), name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_PACKAGE, os.path.join(d, "cluster_tools_tpu_torch"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        path = os.path.join(d, "cluster_tools_tpu_torch", "csrc", src)
        with open(path) as f:
            text = f.read()
        if text.count(kept) != 1:
            raise ValueError(f"{name}: {kept!r} occurs {text.count(kept)} times in {src}")
        with open(path, "w") as f:
            f.write(text.replace(kept, other))
        dirs[name] = d
    return dirs


def build(dirs: Dict[str, str]) -> None:
    """Builds every checkout's kernels 3 and 5 (and the 3d flood), all at
    once; raises with the compiler's log where one fails."""
    procs = {name: subprocess.Popen([sys.executable, "-c", BUILD], cwd=d, text=True,
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for name, d in dirs.items()}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"{name}: build failed:\n{log[-4000:]}")


def main(argv: Sequence[str]) -> int:
    if len(argv) != 1:
        print(__doc__)
        return 2
    dirs = write(argv[0])
    build(dirs)
    print(" ".join(dirs.values()))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
