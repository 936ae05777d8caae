"""Shared social-model helpers: scipy sparse → device-matrix dispatch.

Port of ``recbole_gnn_tpu/models/social/common.py``.  The social
family's precomputed matrices (motif channels, friend / sharing views,
row-normalised net and interest blocks) are built on the host with
scipy sparse algebra and must not densify on their way to the device
at web scale (an n_users² dense matrix is 40 GB at 100k users).  The
device form is chosen by size: a dense tensor (cuBLAS) under
``dense_graph_max_entries``, a sparse :class:`Graph` (the SpMM kernels)
above it or with ``enable_sparse: True``.
``ops/spmm.matvec_any`` dispatches at apply time, so the models do not
depend on the representation.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from recbole_gnn_tpu_torch.ops.spmm import build_graph, graph_impl


def to_device_matrix(m, config, *, device: torch.device | str):
    """scipy sparse (n_rows, n_cols) → a dense tensor or a :class:`Graph`
    on ``device``.

    The Graph's dst indexes rows and src columns, so ``matvec_any(g, x)``
    computes ``m @ x`` for either representation.  It runs with the
    config's ``sparse_spmm_impl`` and ``pallas_spmm_precision``, has the
    segment layout unless ``use_pallas_spmm`` is False (``pallas``
    without it runs the segment sum, as the JAX package dispatches) and
    the ELL layouts exactly when the impl is ``ell``; it may be
    rectangular (``n_src_nodes`` = n_cols)."""
    m = sp.coo_matrix(m)
    n_rows, n_cols = m.shape
    max_entries = int(config.get("dense_graph_max_entries", 3e8))
    if (config["enable_sparse"] is not True
            and n_rows * n_cols <= max_entries):
        return torch.from_numpy(
            np.asarray(m.todense(), dtype=np.float32)).to(device)
    with_pallas = config["use_pallas_spmm"] is not False
    impl = str(config.get("sparse_spmm_impl", "ell"))
    return build_graph(m.col.astype(np.int64), m.row.astype(np.int64),
                       m.data.astype(np.float32), n_rows, n_cols,
                       device=device, with_pallas=with_pallas,
                       impl=graph_impl(impl, with_pallas),
                       precision=str(config.get("pallas_spmm_precision",
                                                "f32x2")),
                       with_ell=impl == "ell")


def row_normalize(m) -> sp.csr_matrix:
    """Sparse row normalisation x → x / (row_sum + 1e-7) (reference
    mhcn.py row norms, the same epsilon)."""
    m = sp.csr_matrix(m, dtype=np.float64)
    rs = np.asarray(m.sum(axis=1)).ravel()
    return sp.diags(1.0 / (rs + 1e-7)).dot(m).tocsr()


def sym_normalize_support(m) -> sp.csr_matrix:
    """Binary-support symmetric normalisation: the weights come from
    the UNWEIGHTED degree of the support (reference sept.py
    get_norm_edge_weight :84-90 rebuilds the views from indices only)."""
    m = sp.csr_matrix(m)
    m_bin = sp.csr_matrix(
        (np.ones_like(m.data), m.indices, m.indptr), shape=m.shape)
    m_bin.sum_duplicates()
    m_bin.data = np.ones_like(m_bin.data)
    deg = np.asarray(m_bin.sum(axis=1)).ravel()
    dinv = 1.0 / np.sqrt(np.where(deg == 0, 1.0, deg))
    coo = m_bin.tocoo()
    vals = dinv[coo.row] * dinv[coo.col]
    return sp.csr_matrix((vals, (coo.row, coo.col)), shape=m.shape)
