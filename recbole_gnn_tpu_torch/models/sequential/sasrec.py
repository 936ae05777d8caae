"""SASRec — causal self-attention sequence model (fallback baseline).

Port of ``recbole_gnn_tpu/models/sequential/sasrec.py`` ([recbole]
sasrec.py): item + positional embeddings → LayerNorm + dropout →
causal post-LN TransformerEncoder → the state at the last position
scores the catalog.

The dropout masks come from a generator derived from the trainer's;
``keeps`` takes the JAX ones in the tests: the input's (B, L, D) mask,
then per layer the attention probabilities', the attention output's
and the feed-forward output's.
"""

from __future__ import annotations

import torch

from recbole_gnn_tpu_torch.models.base import (SequentialRecommender,
                                               device_generator)
from recbole_gnn_tpu_torch.models.init import normal_init, split_keys
from recbole_gnn_tpu_torch.models.layers import (
    KeepStream, causal_additive_mask, layer_norm, transformer_encoder,
    transformer_params)
from recbole_gnn_tpu_torch.models.losses import bpr_loss, cross_entropy
from recbole_gnn_tpu_torch.models.sequential.common import (embed,
                                                            last_hidden)


class SASRec(SequentialRecommender):

    def __init__(self, config, dataset, device=None):
        super().__init__(config, dataset, device)
        self.n_layers = int(config.get("n_layers", 2))
        self.n_heads = int(config.get("n_heads", 2))
        self.hidden_size = int(config.get("hidden_size", 64))
        self.inner_size = int(config.get("inner_size", 256))
        self.hidden_dropout_prob = float(config.get("hidden_dropout_prob",
                                                    0.5))
        self.attn_dropout_prob = float(config.get("attn_dropout_prob", 0.5))
        self.initializer_range = float(config.get("initializer_range", 0.02))
        self.loss_type = str(config.or_default("loss_type", "CE"))

    def init_params(self, gen):
        dev, d = self.device, self.hidden_size
        k1, k2, k3 = split_keys(gen, 3)
        return {
            "item_emb": normal_init(k1, (self.n_items, d),
                                    self.initializer_range, device=dev),
            "pos_emb": normal_init(k2, (self.max_seq_len, d),
                                   self.initializer_range, device=dev),
            "transformer": transformer_params(
                k3, self.n_layers, self.n_heads, d, self.inner_size,
                device=dev),
            "ln_in": {"g": torch.ones(d, device=dev),
                      "b": torch.zeros(d, device=dev)},
        }

    def seq_output(self, params, batch, rng, train, keeps=None):
        seq = batch["item_seq"]
        L = seq.shape[1]
        h = embed(params["item_emb"], seq) + params["pos_emb"][None, :L, :]
        h = layer_norm(params["ln_in"], h)
        stream = (KeepStream.of(keeps,
                                lambda: device_generator(rng, self.device))
                  if train else None)
        if train and self.hidden_dropout_prob > 0:
            h = stream.dropout(h, self.hidden_dropout_prob)
        out = transformer_encoder(
            params["transformer"], h, causal_additive_mask(seq > 0),
            keeps=stream,
            dropout=self.hidden_dropout_prob if train else 0.0,
            n_heads=self.n_heads,
            attn_dropout=self.attn_dropout_prob if train else 0.0)
        return last_hidden(out, batch["item_seq_len"])

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
