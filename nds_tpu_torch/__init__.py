"""nds-tpu-torch: the PyTorch/CUDA port of the nds_tpu engine, for one
NVIDIA H100 (sm_90a).

A package of its own beside `nds_tpu`, which stays the reference: it imports
torch and never jax, and nothing of `nds_tpu` (it keeps its own copies of
the device-free modules). Layout mirrors `nds_tpu` so every module's
counterpart is easy to find:

  dtypes / schema     - typed TPC-DS schema registry (copies)
  engine              - SQL frontend (copies) -> plan -> torch columnar
                        execution (engine/{columnar,expr,exec,session}.py)
  ops                 - relational primitives in torch (ops/kernels.py) and
                        the hand-written Hopper kernels (ops/gpu_kernels.py,
                        ops/csrc/*.cu, built by ops/_build.py)
  obs                 - event tracing, live metrics, the flight recorder and
                        the post-run profiler's readers (cli/profile.py)
"""

__version__ = "0.1.0"
