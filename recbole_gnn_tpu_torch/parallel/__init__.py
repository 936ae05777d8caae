"""Parallelism on ``torch.distributed``: the process group
(``launch``), the rank mesh (``mesh``), the collectives (``comm``), the
dp × tp sharded training step (``sharded_train``), the edge-sharded ELL
SpMM (``sharded_spmm``) and the item-sharded top-k (``topk``) — the port
of ``recbole_gnn_tpu/parallel/``."""
