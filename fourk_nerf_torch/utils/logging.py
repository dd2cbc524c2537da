"""Experiment logging: a scalar writer and the provenance dump.

Scalars go to a plain ``scalars.tsv`` in the log directory, and to
TensorBoard as well when ``torch.utils.tensorboard`` imports (the
reference's SummaryWriter, frozoul/4K-NeRF run.py:695-696). The run
directory gets the arguments and the resolved config (run.py:641-646).
"""

from __future__ import annotations

import os
import time

from fourk_nerf_torch.config import dump_config


class ScalarWriter:
    def __init__(self, logdir: str):
        self.logdir = logdir
        os.makedirs(logdir, exist_ok=True)
        self._tsv = open(os.path.join(logdir, "scalars.tsv"), "a")
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:  # tensorboard is optional
            return
        self._tb = SummaryWriter(logdir)

    def scalar(self, tag: str, value: float, step: int) -> None:
        self._tsv.write(f"{time.time():.3f}\t{step}\t{tag}\t{value}\n")
        self._tsv.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, value, global_step=step)

    def close(self) -> None:
        self._tsv.close()
        if self._tb is not None:
            self._tb.close()


def dump_provenance(cfg, args, rundir: str) -> None:
    """Write ``args.txt`` and the resolved ``config.py`` into ``rundir``."""
    os.makedirs(rundir, exist_ok=True)
    with open(os.path.join(rundir, "args.txt"), "w") as f:
        for k in sorted(vars(args)):
            f.write(f"{k} = {getattr(args, k)}\n")
    dump_config(cfg, os.path.join(rundir, "config.py"))
