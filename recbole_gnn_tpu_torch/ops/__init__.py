"""Kernel layer: graph propagation and top-k.

The port's hand-written CUDA kernels, each launched by a wrapper that
takes its plain PyTorch version for CPU tensors only:

  * ``segment_spmm.segment_spmm`` — the Pallas streaming SpMM's
    counterpart (K1), and ``segment_spmm_transpose`` over the reverse
    CSR as its backward (``sparse_spmm_impl: pallas``);
  * ``gather.row_gather`` (D2) and ``segment_sum.block_segment_sum``
    (D1) — the two halves of ``sparse_spmm_impl: xla``
    (``spmm.xla_spmm``), forward and backward;
  * ``nce.nce_lse`` — the all-node InfoNCE's logsumexp and its
    gradient (SGL, NCL), with no (B, n) logits in memory.

The rest is plain PyTorch.
"""

from recbole_gnn_tpu_torch.ops.spmm import (
    BipartiteDenseGraph, Graph, spmm, spmm_any, spmm_coo, xla_spmm)
from recbole_gnn_tpu_torch.ops.topk import full_sort_topk, masked_topk

__all__ = ["spmm", "spmm_coo", "spmm_any", "xla_spmm", "Graph",
           "BipartiteDenseGraph", "full_sort_topk", "masked_topk"]
