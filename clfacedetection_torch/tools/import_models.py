"""Compile Haar-cascade XMLs into ``.npz`` cascade artifacts.

    python -m clfacedetection_torch.tools.import_models [--src DIR] \\
        --dst DIR [names...]

Reads old- or new-format OpenCV cascade XMLs from ``--src`` (default:
``$CLFD_CASCADE_DIR``; required when that is unset) and writes each as a
``CascadeSpec`` artifact (``CascadeSpec.save``, the JAX package's field
names and dtypes) into ``--dst``.  Without names it takes every ``.xml``
in ``--src``.  Port of ``scripts/import_models.py``.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

from ..models.haar_xml import parse_haar_xml


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    src_default = os.environ.get("CLFD_CASCADE_DIR")
    ap.add_argument("--src", default=src_default,
                    required=src_default is None,
                    help="directory of cascade XMLs (default "
                         "$CLFD_CASCADE_DIR)")
    ap.add_argument("--dst", required=True,
                    help="directory to write the .npz artifacts into")
    ap.add_argument("names", nargs="*", default=None)
    args = ap.parse_args(argv)

    os.makedirs(args.dst, exist_ok=True)
    names = args.names or [fn[:-4] for fn in sorted(os.listdir(args.src))
                           if fn.endswith(".xml")]
    for name in names:
        spec = parse_haar_xml(os.path.join(args.src, name + ".xml"),
                              name=name)
        dst = os.path.join(args.dst, name + ".npz")
        spec.save(dst)
        kb = os.path.getsize(dst) / 1024
        print(f"{name}: {spec.n_stages} stages, {spec.n_nodes} nodes "
              f"-> {dst} ({kb:.0f} KiB)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
