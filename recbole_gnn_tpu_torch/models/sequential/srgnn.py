"""SR-GNN — gated session-graph propagation + attention readout.

Port of ``recbole_gnn_tpu/models/sequential/srgnn.py`` (reference
srgnn.py): ``step`` SRGNN cells over the dense session graph, the alias
re-scatter, last state + soft-attention readout (:86-101), CE over the
catalog or BPR (:103-122).
"""

from __future__ import annotations

import math

from recbole_gnn_tpu_torch.models.base import SequentialRecommender
from recbole_gnn_tpu_torch.models.init import split_keys, uniform_pm
from recbole_gnn_tpu_torch.models.layers import srgnn_cell_params
from recbole_gnn_tpu_torch.models.losses import bpr_loss, cross_entropy
from recbole_gnn_tpu_torch.models.sequential.common import (
    embed, gather_seq_hidden, last_hidden, node_embeddings, seq_mask,
    session_dense_adj, srgnn_attention_readout, srgnn_cell_dense,
    srgnn_readout_params)


class SRGNN(SequentialRecommender):

    def __init__(self, config, dataset, device=None):
        super().__init__(config, dataset, device)
        self.embedding_size = int(config.get("embedding_size", 64))
        self.step = int(config.get("step", 1))
        self.loss_type = str(config.or_default("loss_type", "CE"))

    def init_params(self, gen):
        d, dev = self.embedding_size, self.device
        stdv = 1.0 / math.sqrt(d)
        k1, k2, k3 = split_keys(gen, 3)
        return {
            "item_emb": uniform_pm(k1, (self.n_items, d), stdv, device=dev),
            "cell": srgnn_cell_params(k2, d, device=dev),
            "readout": srgnn_readout_params(k3, d, stdv, device=dev),
        }

    def seq_output(self, params, batch):
        hidden = node_embeddings(params["item_emb"], batch)
        a_in, a_out = session_dense_adj(batch)
        for _ in range(self.step):
            hidden = srgnn_cell_dense(params["cell"], hidden, a_in, a_out)
        seq_hidden = gather_seq_hidden(hidden, batch)
        ht = last_hidden(seq_hidden, batch["item_seq_len"])
        return srgnn_attention_readout(params["readout"], seq_hidden, ht,
                                       seq_mask(batch))

    def full_scores(self, params, consts, extras, batch, rng, train):
        return self.seq_output(params, batch) @ params["item_emb"].T

    def calculate_loss(self, params, consts, extras, batch, rng, mode=0):
        w = batch.get("weight")
        if self.loss_type == "BPR":
            out = self.seq_output(params, batch)
            pos_e = embed(params["item_emb"], batch["item_id"])
            neg_e = embed(params["item_emb"], batch["neg_item_id"])
            loss = bpr_loss((out * pos_e).sum(-1), (out * neg_e).sum(-1), w)
        else:
            logits = self.full_scores(params, consts, extras, batch, rng,
                                      True)
            loss = cross_entropy(logits, batch["item_id"], w)
        return loss, {"loss": loss}
