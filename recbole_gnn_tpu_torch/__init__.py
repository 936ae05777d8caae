"""recbole_gnn_tpu_torch — the PyTorch/CUDA port of recbole_gnn_tpu.

Runs on an NVIDIA H100; its SpMM kernel is written by hand in CUDA
(``csrc/``) and serves the forward and, over the reverse CSR, the
transpose backward.  It imports neither JAX nor the JAX package.
Ported so far: LightGCN and BPR training with full-sort and uniN/popN
evaluation (``run_recbole_gnn_tpu``, ``python -m
recbole_gnn_tpu_torch.run``) and the serving path (export,
``RecServer``, HTTP).
"""

__version__ = "0.1.0"
