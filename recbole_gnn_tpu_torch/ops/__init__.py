"""Kernel layer: graph propagation and top-k.

``segment_spmm.segment_spmm`` launches the port's hand-written CUDA
kernel (the Pallas streaming SpMM's counterpart), and
``segment_spmm_transpose`` launches it over the reverse CSR as the
backward of ``spmm``; the rest is plain PyTorch.
"""

from recbole_gnn_tpu_torch.ops.spmm import (
    BipartiteDenseGraph, Graph, spmm, spmm_any, spmm_coo)
from recbole_gnn_tpu_torch.ops.topk import full_sort_topk, masked_topk

__all__ = ["spmm", "spmm_coo", "spmm_any", "Graph", "BipartiteDenseGraph",
           "full_sort_topk", "masked_topk"]
