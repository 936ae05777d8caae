"""NARM — neural attentive session recommendation (fallback baseline).

Port of ``recbole_gnn_tpu/models/sequential/narm.py`` ([recbole]
narm.py): a masked GRU encoder; the global representation is the last
state, the local one an attention over the states queried by it
(mask-gated sigmoid energies); concatenated, dropped out and projected
bilinearly to the embedding space.

The two dropout masks come from a generator derived from the
trainer's; ``keeps`` takes the JAX ones in the tests: the embeddings'
(B, L, D) mask, then the (B, 2H) one of the concatenation.
"""

from __future__ import annotations

import torch

from recbole_gnn_tpu_torch.models.base import (SequentialRecommender,
                                               device_generator)
from recbole_gnn_tpu_torch.models.init import (linear, linear_params,
                                               split_keys, xavier_normal)
from recbole_gnn_tpu_torch.models.layers import (KeepStream, gru_params,
                                                 gru_scan)
from recbole_gnn_tpu_torch.models.losses import bpr_loss, cross_entropy
from recbole_gnn_tpu_torch.models.sequential.common import (embed,
                                                            last_hidden)


class NARM(SequentialRecommender):

    def __init__(self, config, dataset, device=None):
        super().__init__(config, dataset, device)
        self.embedding_size = int(config.get("embedding_size", 64))
        self.hidden_size = int(config.get("hidden_size", 128))
        self.n_layers = int(config.get("n_layers", 1))
        dp = config.or_default("dropout_probs", [0.25, 0.5])
        self.emb_dropout, self.ct_dropout = float(dp[0]), float(dp[1])
        self.loss_type = str(config.or_default("loss_type", "CE"))

    def init_params(self, gen):
        dev, H = self.device, self.hidden_size
        ks = split_keys(gen, 5 + self.n_layers)
        grus = []
        d_in = self.embedding_size
        for i in range(self.n_layers):
            grus.append(gru_params(ks[5 + i], d_in, H, device=dev))
            d_in = H
        return {
            "item_emb": xavier_normal(ks[0], (self.n_items,
                                              self.embedding_size),
                                      device=dev),
            "gru": grus,
            "a1": linear_params(ks[1], H, H, bias=False, device=dev),
            "a2": linear_params(ks[2], H, H, bias=False, device=dev),
            "vt": linear_params(ks[3], H, 1, bias=False, device=dev),
            "b": linear_params(ks[4], 2 * H, self.embedding_size,
                               bias=False, device=dev),
        }

    def seq_output(self, params, batch, rng, train, keeps=None):
        seq = batch["item_seq"]
        mask = seq > 0
        h = embed(params["item_emb"], seq)
        stream = (KeepStream.of(keeps,
                                lambda: device_generator(rng, self.device))
                  if train else None)
        if train and self.emb_dropout > 0:
            h = stream.dropout(h, self.emb_dropout)
        for gp in params["gru"]:
            h0 = torch.zeros((h.shape[0], self.hidden_size), device=h.device)
            h, _ = gru_scan(gp, h, h0, mask=mask)
        ht = last_hidden(h, batch["item_seq_len"])
        q1 = linear(params["a1"], h)
        q2 = linear(params["a2"], ht)[:, None, :] * mask[:, :, None]
        alpha = linear(params["vt"], torch.sigmoid(q1 + q2))[:, :, 0]
        c_local = (alpha[:, :, None] * h).sum(1)
        c_t = torch.cat([c_local, ht], dim=-1)
        if train and self.ct_dropout > 0:
            c_t = stream.dropout(c_t, self.ct_dropout)
        return linear(params["b"], c_t)

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
