"""recbole_gnn_tpu_torch — the PyTorch/CUDA port of recbole_gnn_tpu.

Runs on an NVIDIA H100; its SpMM kernel is written by hand in CUDA
(``csrc/``).  It imports neither JAX nor the JAX package.  Ported so
far: the LightGCN serving path (config, atomic data, graph build,
propagation, checkpoint load, export, ``RecServer``).
"""

__version__ = "0.1.0"
