"""GCE-GNN — local session graph + global co-occurrence context.

Port of ``recbole_gnn_tpu/models/sequential/gcegnn.py`` (reference
gcegnn.py): edge-type-aware local attention (LocalAggregator :28-43),
the model-built global top-``sample_num`` co-occurrence neighbour table
(construct_global_graph :134-156, in consts), ``hop`` session-aware
GlobalAggregator levels (:46-73, :174-232) and the reverse-position
fusion readout (:158-172).

Dense form: the typed local adjacency becomes four (B, L, L) masks and
the attention is batched matmuls; the edge message x_j⊙x_i collapses to
out_i = Σ α·x_j.

The dropout masks come from a generator derived from the trainer's;
``keeps`` takes the JAX ones in the tests, in this order: the
``dropout_gcn`` mask of each global aggregation (per level, per hop),
then ``dropout_local``'s (B, L, D), then ``dropout_global``'s
(B, L, D); a rate of 0 takes no mask.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from recbole_gnn_tpu_torch.models.base import (SequentialRecommender,
                                               device_generator)
from recbole_gnn_tpu_torch.models.init import (linear, linear_params,
                                               split_keys, uniform_pm)
from recbole_gnn_tpu_torch.models.layers import KeepStream
from recbole_gnn_tpu_torch.models.losses import bpr_loss, cross_entropy
from recbole_gnn_tpu_torch.models.sequential.common import (
    edge_masks, embed, gather_slots, node_embeddings)


def global_graph(seqs: np.ndarray, tgt: np.ndarray, n_items: int,
                 sample_num: int) -> tuple[np.ndarray, np.ndarray]:
    """Co-occurrence neighbours: counts of (target, first-4-history)
    pairs both ways, the top ``sample_num`` by count per item (reference
    :134-156), ties in ``np.lexsort``'s order → (adj, weight), each
    (n_items, sample_num)."""
    src4 = seqs[:, :4]
    t_rep = np.repeat(tgt, 4)
    s_flat = src4.reshape(-1)
    valid = s_flat > 0
    a = np.concatenate([t_rep[valid], s_flat[valid]])
    b = np.concatenate([s_flat[valid], t_rep[valid]])
    key = a.astype(np.int64) * n_items + b
    uniq, counts = np.unique(key, return_counts=True)
    rows = (uniq // n_items).astype(np.int64)
    cols = (uniq % n_items).astype(np.int64)
    S = sample_num
    adj = np.zeros((n_items, S), dtype=np.int64)
    wout = np.zeros((n_items, S), dtype=np.float32)
    order = np.lexsort((-counts, rows))
    rows_s, cols_s, cnt_s = rows[order], cols[order], counts[order]
    starts = np.searchsorted(rows_s, np.arange(n_items))
    pos = np.arange(len(rows_s)) - starts[rows_s]
    keep = pos < S
    adj[rows_s[keep], pos[keep]] = cols_s[keep]
    wout[rows_s[keep], pos[keep]] = cnt_s[keep]
    return adj, wout


class GCEGNN(SequentialRecommender):

    def __init__(self, config, dataset, device=None):
        super().__init__(config, dataset, device)
        self.embedding_size = int(config.get("embedding_size", 64))
        self.leakyrelu_alpha = float(config.get("leakyrelu_alpha", 0.2))
        self.dropout_local = float(config.get("dropout_local", 0.0))
        self.dropout_global = float(config.get("dropout_global", 0.5))
        self.dropout_gcn = float(config.get("dropout_gcn", 0.0))
        self.loss_type = str(config.or_default("loss_type", "CE"))
        self.sample_num = int(config.get("sample_num", 12))
        self.hop = int(config.get("hop", 1))
        if config["build_global_graph"] is not False:
            adj, w = global_graph(dataset.inter[dataset.item_list_field],
                                  dataset.inter[dataset.iid_field],
                                  self.n_items, self.sample_num)
            self.consts["global_adj"] = torch.from_numpy(adj).to(self.device)
            self.consts["global_weight"] = torch.from_numpy(w).to(
                self.device)

    def init_params(self, gen):
        d, dev = self.embedding_size, self.device
        stdv = 1.0 / math.sqrt(d)
        ks = split_keys(gen, 7 + self.hop)
        return {
            "item_emb": uniform_pm(ks[0], (self.n_items, d), stdv, device=dev),
            "pos_emb": uniform_pm(ks[1], (self.max_seq_len, d), stdv,
                                  device=dev),
            "edge_emb": uniform_pm(ks[2], (4, d), stdv, device=dev),
            "w1": linear_params(ks[3], 2 * d, d, bias=False, stdv=stdv,
                                device=dev),
            "w2": linear_params(ks[4], d, 1, bias=False, stdv=stdv,
                                device=dev),
            "glu1": linear_params(ks[5], d, d, stdv=stdv, device=dev),
            "glu2": linear_params(ks[6], d, d, bias=False, stdv=stdv,
                                  device=dev),
            "global_agg": [
                dict(zip(("w_1", "w_2", "w_3", "bias"), (
                    uniform_pm(k, shape, stdv, device=dev)
                    for k, shape in zip(split_keys(ks[7 + i], 4),
                                        ((d + 1, d), (d, 1), (2 * d, d),
                                         (d,))))))
                for i in range(self.hop)],
        }

    def _local_agg(self, params, h, batch):
        """Typed-edge attention (LocalAggregator :28-43), dense: a joint
        softmax over each node's incident (neighbour, type) pairs; a node
        with no incident edge gets 0 (its logits are all −1e30, not −inf,
        so the softmax stays finite and the mask zeroes it)."""
        B, L, D = h.shape
        mstack = edge_masks(batch["edge_src"], batch["edge_dst"],
                            batch["n_edges"], L, batch["edge_attr"], 4)
        logits = [F.leaky_relu(torch.bmm(h * params["edge_emb"][t],
                                         h.transpose(1, 2)),
                               self.leakyrelu_alpha) for t in range(4)]
        big = torch.where(mstack > 0, torch.stack(logits, dim=-1), -1e30)
        alpha = torch.softmax(big.reshape(B, L, L * 4), dim=-1)
        w = (alpha.reshape(B, L, L, 4) * mstack).sum(-1)  # (B, L, L)
        return torch.bmm(w, h)

    def _global_agg(self, params, consts, batch, stream):
        """Session-aware neighbour aggregation over the global table
        (reference forward :190-232), ``hop`` levels; the (B, L·S^k, D)
        neighbour rows come by ``F.embedding``."""
        B = batch["alias_inputs"].shape[0]
        L, D, S = self.max_seq_len, self.embedding_size, self.sample_num
        adj, gw = consts["global_adj"], consts["global_weight"]
        item_emb = params["item_emb"]
        seq_items = gather_slots(batch["x"][:, :, None],
                                 batch["alias_inputs"])[:, :, 0]
        mask = seq_items > 0
        item_neighbors = [seq_items]
        weight_neighbors = []
        support = L
        for _ in range(self.hop):
            flat = item_neighbors[-1].reshape(-1)
            support *= S
            item_neighbors.append(F.embedding(flat, adj).reshape(B, support))
            weight_neighbors.append(F.embedding(flat, gw).reshape(B, support))
        entity_vectors = [embed(item_emb, n) for n in item_neighbors]
        item_e = entity_vectors[0] * mask[:, :, None]
        sum_item = item_e.sum(1) / mask.sum(1, keepdim=True).clamp_min(1.0)

        for n_hop in range(self.hop):
            p = params["global_agg"][n_hop]
            nxt = []
            for hop_i in range(self.hop - n_hop):
                self_vec = entity_vectors[hop_i]           # (B, M, D)
                neigh = entity_vectors[hop_i + 1].reshape(B, -1, S, D)
                nw = weight_neighbors[hop_i].reshape(B, -1, S)
                extra = sum_item[:, None, None, :]
                alpha = torch.matmul(
                    torch.cat([extra * neigh, nw[..., None]], dim=-1),
                    p["w_1"])
                alpha = F.leaky_relu(alpha, 0.2)
                alpha = torch.matmul(alpha, p["w_2"])[..., 0]
                alpha = torch.softmax(alpha, dim=-1)[..., None]
                neigh_v = (alpha * neigh).sum(-2)          # (B, M, D)
                out = torch.cat([self_vec, neigh_v], dim=-1)
                if stream is not None and self.dropout_gcn > 0:
                    out = stream.dropout(out, self.dropout_gcn)
                nxt.append(torch.relu(torch.matmul(out, p["w_3"])))
            entity_vectors = nxt
        return entity_vectors[0][:, :L, :]                  # (B, L, D)

    def _fusion(self, params, hidden, mask):
        """Reverse-position fusion readout (reference :158-172)."""
        B, L, D = hidden.shape
        pos = params["pos_emb"][None, :L, :].expand(B, L, D)
        m = mask[:, :, None].to(hidden.dtype)
        hs = (hidden * m).sum(1) / m.sum(1).clamp_min(1.0)
        nh = torch.tanh(linear(params["w1"], torch.cat([pos, hidden], -1)))
        nh = torch.sigmoid(linear(params["glu1"], nh)
                           + linear(params["glu2"], hs)[:, None, :])
        beta = linear(params["w2"], nh) * m
        return (beta * hidden).sum(1)

    def seq_output(self, params, consts, batch, rng, train, keeps=None):
        stream = (KeepStream.of(keeps,
                                lambda: device_generator(rng, self.device))
                  if train else None)
        h = node_embeddings(params["item_emb"], batch)
        h_local = self._local_agg(params, h, batch)
        h_global = self._global_agg(params, consts, batch, stream)
        if train and self.dropout_local > 0:
            h_local = stream.dropout(h_local, self.dropout_local)
        if train and self.dropout_global > 0:
            h_global = stream.dropout(h_global, self.dropout_global)
        h_local_seq = gather_slots(h_local, batch["alias_inputs"])
        seq_items = gather_slots(batch["x"][:, :, None],
                                 batch["alias_inputs"])[:, :, 0]
        return self._fusion(params, h_local_seq + h_global, seq_items > 0)

    def full_scores(self, params, consts, extras, batch, rng, train,
                    keeps=None):
        out = self.seq_output(params, consts, batch, rng, train, keeps)
        return out @ params["item_emb"].T

    def calculate_loss(self, params, consts, extras, batch, rng, mode=0,
                       keeps=None):
        w = batch.get("weight")
        if self.loss_type == "BPR":
            out = self.seq_output(params, consts, batch, rng, True, keeps)
            loss = bpr_loss(
                (out * embed(params["item_emb"], batch["item_id"])).sum(-1),
                (out * embed(params["item_emb"], batch["neg_item_id"])).sum(-1),
                w)
        else:
            logits = self.full_scores(params, consts, extras, batch, rng,
                                      True, keeps)
            loss = cross_entropy(logits, batch["item_id"], w)
        return loss, {"loss": loss}
