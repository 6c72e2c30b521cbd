"""Prediction CLI (port of `ssl4gie_tpu/cli/predict.py`, the reference's
predict_*.py): renders the masks, the depth and error colormaps or the box
overlays of test-split images into Predictions/:
  python -m ssl4gie_tpu_torch.cli.predict --task detection --arch vit_b \\
      --dataset Kvasir --data-root /path/Kvasir-SEG --idx 0,1
Runs on the card unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import os

from ssl4gie_tpu_torch.cli.args import add_common, to_train_config
from ssl4gie_tpu_torch.cli.evaluate import load_eval_state, make_test_source
from ssl4gie_tpu_torch.core.config import Task
from ssl4gie_tpu_torch.tasks import predict as P

PREDICTORS = {Task.SEGMENTATION: P.predict_segmentation,
              Task.DEPTH: P.predict_depth,
              Task.DETECTION: P.predict_detection}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    add_common(p)
    p.add_argument("--ckpt-dir", type=str, default="Trained models",
                   dest="ckpt_dir")
    p.add_argument("--idx", type=str, default=None,
                   help="comma-separated test indices (default: all)")
    p.add_argument("--out-dir", type=str, default=None, dest="out_dir")
    args = p.parse_args(argv)
    args.epochs = 1
    cfg = to_train_config(args)
    if cfg.task not in PREDICTORS:
        raise NotImplementedError(f"predict for {cfg.task} (classification "
                                  "has no predict script in the reference "
                                  "either, README.md:172)")
    model, _ = load_eval_state(cfg)
    src = make_test_source(cfg)
    indices = [int(i) for i in args.idx.split(",")] if args.idx else None
    out_dir = args.out_dir or os.path.join("Predictions",
                                           cfg.data.dataset or "synthetic")
    written = PREDICTORS[cfg.task](cfg, model, src, out_dir, indices)
    print(f"wrote {len(written)} files to {out_dir}")
    return written


if __name__ == "__main__":
    main()
