"""H100 probes of the port's kernels at the shapes of the JAX package's
TPU diagnostics (``scripts/diag``), runnable as

    python -m recbole_gnn_tpu_torch.diag.pallas_floor   # D1
    python -m recbole_gnn_tpu_torch.diag.row_gather     # D2

They run on the card unless ``--device cpu`` is given (then the plain
versions run, on the host clock), and raise without a card otherwise.
K2's probe, ``python -m recbole_gnn_tpu_torch.diag.ell_l2``, runs on the
card only: it times the bucketed-ELL SpMM in four L2 states at the
LightGCN slice shape, and A/B-tests variants of its source in one run.
"""
