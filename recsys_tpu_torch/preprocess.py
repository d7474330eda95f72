"""Preprocessing CLI of the port (the counterpart of
``scripts/preprocess.py``): raw MovieLens files -> the training bundle,
in numpy only.

Usage:
  python -m recsys_tpu_torch.preprocess --data_dir data/raw \\
      --output data/processed/processed_data.npz [--implicit_threshold 4] \\
      [--synthetic_ratings 1000209] [--synthetic_seed 1]

The flags and defaults are those of ``scripts/preprocess.py`` (from
``DataConfig``), so one argv writes the same arrays in both packages.
Without a real ``ratings.dat`` the ratings are synthesized from the seed.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> int:
    from recsys_tpu_torch.config import DataConfig

    dc = DataConfig()
    ap = argparse.ArgumentParser(description="Preprocess MovieLens-1M data "
                                             "(PyTorch/CUDA port)")
    ap.add_argument("--data_dir", default=dc.data_dir,
                    help="directory with ratings.dat/movies.dat/users.dat")
    ap.add_argument("--output", default=dc.processed_path,
                    help="output bundle path (.npz)")
    ap.add_argument("--implicit_threshold", type=float, default=dc.implicit_threshold,
                    help="rating >= threshold defines the positive label")
    ap.add_argument("--synthetic_ratings", type=int, default=dc.synthetic_num_ratings,
                    help="synthesize N ratings when ratings.dat is absent")
    ap.add_argument("--synthetic_seed", type=int, default=dc.synthetic_seed)
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s: %(message)s")
    from recsys_tpu_torch.data.preprocessing import check_preprocessing_quality, run

    bundle = run(args.data_dir, args.output, implicit_threshold=args.implicit_threshold,
                 synthetic_ratings=args.synthetic_ratings,
                 synthetic_seed=args.synthetic_seed)
    print(json.dumps(check_preprocessing_quality(bundle)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
