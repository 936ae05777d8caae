"""NISER+ — normalised item/session representations over SR-GNN.

Port of ``recbole_gnn_tpu/models/sequential/niser.py`` (reference
niser.py:64-110): item-embedding dropout and L2-normalised node
embeddings before propagation, positional embeddings added to the
sequence states, a normalised session output and σ-scaled logits on
the normalised item embeddings.

The dropout mask comes from a generator derived from the trainer's;
``keeps`` takes the JAX one in the tests (one (B, L, D) mask).
"""

from __future__ import annotations

import math

from recbole_gnn_tpu_torch.models.base import (SequentialRecommender,
                                               device_generator)
from recbole_gnn_tpu_torch.models.init import (l2_normalize, split_keys,
                                               uniform_pm)
from recbole_gnn_tpu_torch.models.layers import KeepStream, srgnn_cell_params
from recbole_gnn_tpu_torch.models.losses import bpr_loss, cross_entropy
from recbole_gnn_tpu_torch.models.sequential.common import (
    embed, gather_seq_hidden, last_hidden, node_embeddings, seq_mask,
    session_dense_adj, srgnn_attention_readout, srgnn_cell_dense,
    srgnn_readout_params)


class NISER(SequentialRecommender):

    def __init__(self, config, dataset, device=None):
        super().__init__(config, dataset, device)
        self.embedding_size = int(config.get("embedding_size", 64))
        self.step = int(config.get("step", 1))
        self.sigma = float(config.get("sigma", 16.0))
        self.item_dropout = float(config.get("item_dropout", 0.1))
        self.loss_type = str(config.or_default("loss_type", "CE"))

    def init_params(self, gen):
        d, dev = self.embedding_size, self.device
        stdv = 1.0 / math.sqrt(d)
        k1, k2, k3, k4 = split_keys(gen, 4)
        return {
            "item_emb": uniform_pm(k1, (self.n_items, d), stdv, device=dev),
            "pos_emb": uniform_pm(k2, (self.max_seq_len, d), stdv,
                                  device=dev),
            "cell": srgnn_cell_params(k3, d, device=dev),
            "readout": srgnn_readout_params(k4, d, stdv, device=dev),
        }

    def seq_output(self, params, batch, rng, train, keeps=None):
        hidden = node_embeddings(params["item_emb"], batch)
        if train and self.item_dropout > 0:
            stream = KeepStream.of(
                keeps, lambda: device_generator(rng, self.device))
            hidden = stream.dropout(hidden, self.item_dropout)
        hidden = l2_normalize(hidden)
        a_in, a_out = session_dense_adj(batch)
        for _ in range(self.step):
            hidden = srgnn_cell_dense(params["cell"], hidden, a_in, a_out)
        seq_hidden = gather_seq_hidden(hidden, batch)
        L = seq_hidden.shape[1]
        seq_hidden = seq_hidden + params["pos_emb"][None, :L, :]
        ht = last_hidden(seq_hidden, batch["item_seq_len"])
        out = srgnn_attention_readout(params["readout"], seq_hidden, ht,
                                      seq_mask(batch))
        return l2_normalize(out)

    def full_scores(self, params, consts, extras, batch, rng, train,
                    keeps=None):
        out = self.seq_output(params, batch, rng, train, keeps)
        return self.sigma * (out @ l2_normalize(params["item_emb"]).T)

    def calculate_loss(self, params, consts, extras, batch, rng, mode=0,
                       keeps=None):
        w = batch.get("weight")
        if self.loss_type == "BPR":
            out = self.seq_output(params, batch, rng, True, keeps)
            pos_e = l2_normalize(embed(params["item_emb"], batch["item_id"]))
            neg_e = l2_normalize(embed(params["item_emb"], batch["neg_item_id"]))
            loss = bpr_loss(self.sigma * (out * pos_e).sum(-1),
                            self.sigma * (out * neg_e).sum(-1), w)
        else:
            logits = self.full_scores(params, consts, extras, batch, rng,
                                      True, keeps)
            loss = cross_entropy(logits, batch["item_id"], w)
        return loss, {"loss": loss}
