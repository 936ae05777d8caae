"""Shared session-graph machinery — dense batched form.

Port of ``recbole_gnn_tpu/models/sequential/common.py``.  A session
graph has at most L = MAX_ITEM_LIST_LENGTH nodes, so each batch carries
dense per-session adjacencies (B, L, L) and every propagation step is
one batched matmul (``torch.bmm``), built on the device from the
dataset's padded edge arrays (``data/session.py``).

Semantics: A_in is row-normalised over *distinct* in-neighbours, PyG's
mean aggregation over deduped edges (reference SRGNNConv,
layers.py:69-79); A_out is the same for the reversed edges.

:func:`session_union_graphs` builds the same two operators as sparse
:class:`~recbole_gnn_tpu_torch.ops.spmm.Graph` s over the batch's
disjoint union (node ``row · L + slot``) for the sparse
``layers.srgnn_cell``, which runs on the SpMM kernels.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from recbole_gnn_tpu_torch.models.init import linear, linear_params, split_keys
from recbole_gnn_tpu_torch.models.layers import srgnn_gate
from recbole_gnn_tpu_torch.ops.spmm import build_graph


def embed(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows ``table[ids]`` by ``F.embedding``: the same values as
    indexing, but a backward that sums each row's gradient by a sorted
    segment reduction.  Indexing's backward (``indexing_backward_kernel``,
    an accumulating ``index_put_``) took 38 ms of a 44 ms SR-GNN step on
    an H100 at the diginetica batch (4,096 × 20 ids into 29,455 rows,
    Zipf-popular items repeated many times)."""
    return F.embedding(ids, table)


def node_embeddings(item_emb: torch.Tensor, batch) -> torch.Tensor:
    """(B, L, D) embeddings of the per-session node slots; the PAD slots
    (item 0) are zeroed (``padding_idx=0``)."""
    x = batch["x"]
    return torch.where((x > 0)[:, :, None], embed(item_emb, x), 0.0)


def seq_mask(batch) -> torch.Tensor:
    """(B, L) bool — valid sequence positions."""
    L = batch["alias_inputs"].shape[1]
    pos = torch.arange(L, device=batch["item_seq_len"].device)
    return pos[None, :] < batch["item_seq_len"][:, None]


def node_mask(batch) -> torch.Tensor:
    """(B, L) bool — valid node slots."""
    L = batch["x"].shape[1]
    pos = torch.arange(L, device=batch["n_nodes"].device)
    return pos[None, :] < batch["n_nodes"][:, None]


def session_dense_adj(batch) -> tuple[torch.Tensor, torch.Tensor]:
    """(A_in, A_out): (B, L, L) row-normalised dense session adjacencies.

    A_in[b, i, j] = 1/in_deg(i) where a deduped consecutive-pair edge
    j→i exists; A_out is the reverse direction (the edges' 0/1 mask by
    :func:`edge_masks`)."""
    a = edge_masks(batch["edge_src"], batch["edge_dst"], batch["n_edges"],
                   batch["x"].shape[1])[..., 0]

    def row_norm(m):
        return m / m.sum(-1, keepdim=True).clamp_min(1.0)

    return row_norm(a), row_norm(a.transpose(1, 2))


def edge_masks(src: torch.Tensor, dst: torch.Tensor, n_edges: torch.Tensor,
               L: int, attr: torch.Tensor | None = None,
               n_types: int = 1) -> torch.Tensor:
    """(B, L, L, n_types) float masks, 1 at [b, dst, src, attr] for each
    of a row's first ``n_edges`` edge slots (``attr`` 0 when None): the
    max-scatter of the edges' validity as a plain fill of ones: the
    padded slots go to one spare cell past the end instead of cell
    (0, 0), so no write lands on a real 0→0 edge (session [a, a, b])
    and every write to a cell writes the same value."""
    B, E = src.shape
    pos = torch.arange(E, device=src.device)[None, :]
    rows = torch.arange(B, device=src.device)[:, None]
    cell = ((rows * L + dst) * L + src) * n_types
    if attr is not None:
        cell = cell + attr
    n = B * L * L * n_types
    cell = torch.where(pos < n_edges[:, None], cell, n)
    m = torch.zeros(n + 1, device=src.device).index_fill_(
        0, cell.reshape(-1).long(), 1.0)
    return m[:n].reshape(B, L, L, n_types)


def srgnn_cell_dense(p: dict, hidden: torch.Tensor, a_in: torch.Tensor,
                     a_out: torch.Tensor) -> torch.Tensor:
    """SRGNN gated cell on dense batched session graphs (reference
    SRGNNCell, layers.py:82-114: dual mean-aggregation linear convs and
    the GRU-style gate)."""
    input_in = torch.bmm(a_in, linear(p["in_conv"], hidden))
    input_out = torch.bmm(a_out, linear(p["out_conv"], hidden))
    return srgnn_gate(p, hidden, input_in, input_out)


def gather_slots(hidden: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, L_out, D) = hidden[b, idx[b, l], :], an exact gather.  Its
    backward is the scatter-add of ``torch.gather``: the same values as
    the JAX package's one-hot matmul at full precision, with no matmul
    that TF32 could round."""
    return torch.gather(hidden, 1,
                        idx[:, :, None].expand(-1, -1, hidden.shape[-1]))


def gather_seq_hidden(hidden: torch.Tensor, batch) -> torch.Tensor:
    """(B, L, D) node states re-scattered to sequence positions via
    ``alias_inputs`` (reference srgnn.py:95)."""
    return gather_slots(hidden, batch["alias_inputs"])


def last_hidden(seq_hidden: torch.Tensor, item_seq_len: torch.Tensor
                ) -> torch.Tensor:
    """(B, D) state at the last valid position."""
    idx = (item_seq_len - 1).clamp_min(0)
    return gather_slots(seq_hidden, idx[:, None])[:, 0]


def srgnn_attention_readout(p: dict, seq_hidden: torch.Tensor,
                            ht: torch.Tensor, mask: torch.Tensor
                            ) -> torch.Tensor:
    """Soft-attention session readout (reference srgnn.py:96-101):
    α = w₃·σ(W₁ht + W₂h_p); s = Σ α·h_p·mask; out = W₄[s; ht]."""
    q1 = linear(p["linear_one"], ht)[:, None, :]
    q2 = linear(p["linear_two"], seq_hidden)
    alpha = linear(p["linear_three"], torch.sigmoid(q1 + q2))
    a = (alpha * seq_hidden * mask[:, :, None].to(seq_hidden.dtype)).sum(1)
    return linear(p["linear_transform"], torch.cat([a, ht], dim=-1))


def srgnn_readout_params(gen: torch.Generator, d: int, stdv: float, *,
                         device: torch.device | str = "cpu") -> dict:
    k1, k2, k3, k4 = split_keys(gen, 4)
    return {
        "linear_one": linear_params(k1, d, d, stdv=stdv, device=device),
        "linear_two": linear_params(k2, d, d, stdv=stdv, device=device),
        "linear_three": linear_params(k3, d, 1, bias=False, stdv=stdv,
                                      device=device),
        "linear_transform": linear_params(k4, 2 * d, d, stdv=stdv,
                                          device=device),
    }


def session_union_graphs(batch, *, device: torch.device | str,
                         impl: str = "ell", precision: str = "f32x2"):
    """(in_graph, out_graph): the batch's session graphs as one
    disjoint union of B·L nodes (node ``row · L + slot``), the sparse
    counterparts of :func:`session_dense_adj`'s A_in and A_out, built on
    the host from a numpy batch for ``impl``'s kernels.

    in_graph: edge j→i of a session with weight 1/in_deg(i); out_graph:
    the reversed edges, weight 1/out_deg.  The edge arrays are deduped
    per session, so each degree counts distinct neighbours."""
    src = np.asarray(batch["edge_src"], dtype=np.int64)
    dst = np.asarray(batch["edge_dst"], dtype=np.int64)
    B, E = src.shape
    L = np.asarray(batch["x"]).shape[1]
    valid = np.arange(E)[None, :] < np.asarray(batch["n_edges"])[:, None]
    base = (np.arange(B, dtype=np.int64) * L)[:, None]
    s = (base + src)[valid]
    d = (base + dst)[valid]
    n = B * L
    in_deg = np.bincount(d, minlength=n).astype(np.float64)
    out_deg = np.bincount(s, minlength=n).astype(np.float64)
    kw = dict(device=device, with_pallas=impl == "pallas", impl=impl,
              precision=precision)
    in_graph = build_graph(s, d, 1.0 / in_deg[d], n, **kw)
    out_graph = build_graph(d, s, 1.0 / out_deg[s], n, **kw)
    return in_graph, out_graph
