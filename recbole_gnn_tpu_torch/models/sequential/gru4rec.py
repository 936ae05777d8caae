"""GRU4Rec — GRU session encoder (RecBole-fallback baseline).

Port of ``recbole_gnn_tpu/models/sequential/gru4rec.py`` ([recbole]
gru4rec.py): item embedding → dropout → stacked masked GRU scans →
dense back to the embedding size; the state at the last valid position
scores the catalog.

The dropout mask comes from a generator derived from the trainer's;
``keeps`` takes the JAX one in the tests (one (B, L, D) mask).
"""

from __future__ import annotations

import torch

from recbole_gnn_tpu_torch.models.base import (SequentialRecommender,
                                               device_generator)
from recbole_gnn_tpu_torch.models.init import (linear, linear_params,
                                               split_keys, xavier_normal,
                                               xavier_uniform)
from recbole_gnn_tpu_torch.models.layers import (KeepStream, gru_params,
                                                 gru_scan)
from recbole_gnn_tpu_torch.models.losses import bpr_loss, cross_entropy
from recbole_gnn_tpu_torch.models.sequential.common import (embed,
                                                            last_hidden)


class GRU4Rec(SequentialRecommender):

    def __init__(self, config, dataset, device=None):
        super().__init__(config, dataset, device)
        self.embedding_size = int(config.get("embedding_size", 64))
        self.hidden_size = int(config.get("hidden_size", 128))
        self.num_layers = int(config.get("num_layers", 1))
        self.dropout_prob = float(config.get("dropout_prob", 0.3))
        self.loss_type = str(config.or_default("loss_type", "CE"))

    def init_params(self, gen):
        dev = self.device
        ks = split_keys(gen, 2 + self.num_layers)
        grus = []
        d_in = self.embedding_size
        for i in range(self.num_layers):
            grus.append(gru_params(ks[2 + i], d_in, self.hidden_size,
                                   device=dev))
            d_in = self.hidden_size
        return {
            "item_emb": xavier_normal(
                ks[0], (self.n_items, self.embedding_size), device=dev),
            "gru": grus,
            "dense": linear_params(ks[1], self.hidden_size,
                                   self.embedding_size, init=xavier_uniform,
                                   device=dev),
        }

    def seq_output(self, params, batch, rng, train, keeps=None):
        seq = batch["item_seq"]
        mask = seq > 0
        h = embed(params["item_emb"], seq)
        if train and self.dropout_prob > 0:
            stream = KeepStream.of(
                keeps, lambda: device_generator(rng, self.device))
            h = stream.dropout(h, self.dropout_prob)
        for gp in params["gru"]:
            h0 = torch.zeros((h.shape[0], self.hidden_size), device=h.device)
            h, _ = gru_scan(gp, h, h0, mask=mask)
        return linear(params["dense"], last_hidden(h, batch["item_seq_len"]))

    def full_scores(self, params, consts, extras, batch, rng, train,
                    keeps=None):
        out = self.seq_output(params, batch, rng, train, keeps)
        return out @ params["item_emb"].T

    def calculate_loss(self, params, consts, extras, batch, rng, mode=0,
                       keeps=None):
        w = batch.get("weight")
        if self.loss_type == "BPR":
            out = self.seq_output(params, batch, rng, True, keeps)
            loss = bpr_loss(
                (out * embed(params["item_emb"], batch["item_id"])).sum(-1),
                (out * embed(params["item_emb"], batch["neg_item_id"])).sum(-1), w)
        else:
            logits = self.full_scores(params, consts, extras, batch, rng,
                                      True, keeps)
            loss = cross_entropy(logits, batch["item_id"], w)
        return loss, {"loss": loss}
