"""Fix a raw SMPL npz kintree so the root's parent is -1 (the twin of
``scripts/npz_fixer.py``, on ``smpltpu_torch.io.fix_kintree``).

    python -m smpltpu_torch.tools.npz_fixer <model.npz> [out.npz]

Raw SMPL npz files store the root's parent as itself or garbage; this
rewrites kintree_table row 0 and saves <name>_fixed.npz (or out.npz).
"""

import os
import sys

import numpy as np

from smpltpu_torch.io import fix_kintree


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("Usage: python npz_fixer.py <model.npz> [out.npz]")
        return 1
    src = argv[0]
    dst = argv[1] if len(argv) > 1 else (
        os.path.splitext(src)[0] + "_fixed.npz")

    model = dict(np.load(src, allow_pickle=True))
    model["kintree_table"] = fix_kintree(model["kintree_table"])
    np.savez(dst, **model)
    print(f"wrote {dst}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
