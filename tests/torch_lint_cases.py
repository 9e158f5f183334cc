"""Shared, jax-free helper of the port's lint and concurrency tests: one
whole-tree run of the port's engine lint per process (it builds the lock
model over every module, several seconds), from the repository root so
that the run also exercises the rebase onto the package."""

import functools
import os

from nds_tpu_torch.analysis import lint as TL

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@functools.lru_cache(maxsize=1)
def port_tree_findings():
    return tuple(TL.run_lint(ROOT))
