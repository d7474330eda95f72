"""Export CLI of the port (the counterpart of ``scripts/export.py``): the
serving retrieve path as one ``torch.export`` artifact with the trained
weights and the catalog inside.

Usage:
  python -m recsys_tpu_torch.export --model_dir outputs/.../serving \\
      [--output <model_dir>/retrieve.pt2] [--k 10] [--device cuda|cpu]

Prints the artifact's metadata JSON (also written to ``<output>.json``).
``--device cuda``, the default, traces on the card and raises without one.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> int:
    from recsys_tpu_torch.serve.export import DEFAULT_ARTIFACT

    ap = argparse.ArgumentParser(description="AOT-export the retrieve path "
                                             "(PyTorch/CUDA port)")
    ap.add_argument("--model_dir", required=True)
    ap.add_argument("--output", default=None,
                    help=f"default: <model_dir>/{DEFAULT_ARTIFACT}")
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the program is traced (cuda raises if no card "
                         "is present); the artifact answers on either")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s: %(message)s")
    from recsys_tpu_torch.serve.export import export_retrieve

    out = args.output or os.path.join(args.model_dir, DEFAULT_ARTIFACT)
    meta = export_retrieve(args.model_dir, out, k=args.k, device=args.device)
    print(json.dumps(meta, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
