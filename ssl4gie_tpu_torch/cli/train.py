"""Finetune training CLI (port of `ssl4gie_tpu/cli/train.py`).

Usage (the reference's train_*.py grammar, plus --task and --device):
  python -m ssl4gie_tpu_torch.cli.train --task segmentation \\
      --architecture vit_b --dataset Kvasir --data-root /path/Kvasir-SEG
  python -m ssl4gie_tpu_torch.cli.train --task classification \\
      --synthetic --device cpu --compute-dtype float32 --epochs 1

Runs on the card unless `--device cpu`; on N GPUs under torchrun (or
SLURM / OpenMPI), one process each, with data parallelism, `--tp` and
`--fsdp`:
  torchrun --nproc-per-node 4 -m ssl4gie_tpu_torch.cli.train \\
      --task classification --synthetic --batch-size 64 --tp 2
On a preemption signal (to any rank) the state is saved and every process
exits with code 42; relaunching the same command resumes.
"""

from __future__ import annotations

import argparse

from ssl4gie_tpu_torch.cli.args import add_common, add_train, to_train_config
from ssl4gie_tpu_torch.core.mesh import maybe_init_distributed
from ssl4gie_tpu_torch.core.preempt import REQUEUE_EXIT_CODE, Preempted
from ssl4gie_tpu_torch.tasks.build import build_trainer


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    add_common(p)
    add_train(p)
    args = p.parse_args(argv)
    maybe_init_distributed(args.device)
    trainer = build_trainer(to_train_config(args))
    trainer.logger.write_args(vars(args))
    try:
        best = trainer.fit()
    except Preempted:
        # state saved; the supervisor relaunches this command and
        # maybe_resume continues (core/preempt.py)
        raise SystemExit(REQUEUE_EXIT_CODE)
    print(f"best val performance: {best}")


if __name__ == "__main__":
    main()
