"""H100 probes of the port's kernels at the shapes of the JAX package's
TPU diagnostics (``scripts/diag``), runnable as

    python -m recbole_gnn_tpu_torch.diag.pallas_floor   # D1
    python -m recbole_gnn_tpu_torch.diag.row_gather     # D2

They run on the card unless ``--device cpu`` is given (then the plain
versions run, on the host clock), and raise without a card otherwise.
"""
