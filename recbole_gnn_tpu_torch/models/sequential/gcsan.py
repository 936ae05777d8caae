"""GC-SAN — SR-GNN cell + causal self-attention.

Port of ``recbole_gnn_tpu/models/sequential/gcsan.py`` (reference
gcsan.py): SRGNN cells, then a [recbole] TransformerEncoder over the
alias sequence with a left-to-right mask (:92-106), output
weight·a_t + (1 − weight)·h_t (:108-122), CE or BPR + EmbLoss on the
item table.

The transformer's dropout masks come from a generator derived from the
trainer's; ``keeps`` takes the JAX ones in the tests, per layer the
attention probabilities, the attention output and the feed-forward
output.
"""

from __future__ import annotations

from recbole_gnn_tpu_torch.models.base import (SequentialRecommender,
                                               device_generator)
from recbole_gnn_tpu_torch.models.init import normal_init, split_keys
from recbole_gnn_tpu_torch.models.layers import (
    KeepStream, causal_additive_mask, srgnn_cell_params, transformer_encoder,
    transformer_params)
from recbole_gnn_tpu_torch.models.losses import (bpr_loss, cross_entropy,
                                                 emb_loss)
from recbole_gnn_tpu_torch.models.sequential.common import (
    embed, gather_seq_hidden, last_hidden, node_embeddings, seq_mask,
    session_dense_adj, srgnn_cell_dense)


class GCSAN(SequentialRecommender):

    def __init__(self, config, dataset, device=None):
        super().__init__(config, dataset, device)
        self.n_layers = int(config.get("n_layers", 1))
        self.n_heads = int(config.get("n_heads", 1))
        self.hidden_size = int(config.get("hidden_size", 64))
        self.inner_size = int(config.get("inner_size", 256))
        self.hidden_dropout_prob = float(config.get("hidden_dropout_prob",
                                                    0.2))
        self.attn_dropout_prob = float(config.get("attn_dropout_prob", 0.2))
        self.step = int(config.get("step", 1))
        self.weight = float(config.get("weight", 0.6))
        self.reg_weight = float(config.get("reg_weight", 5e-5))
        self.loss_type = str(config.or_default("loss_type", "CE"))
        self.initializer_range = float(config.get("initializer_range", 0.02))

    def init_params(self, gen):
        dev = self.device
        k1, k2, k3 = split_keys(gen, 3)
        return {
            "item_emb": normal_init(k1, (self.n_items, self.hidden_size),
                                    self.initializer_range, device=dev),
            "cell": srgnn_cell_params(k2, self.hidden_size, device=dev),
            "transformer": transformer_params(
                k3, self.n_layers, self.n_heads, self.hidden_size,
                self.inner_size, device=dev),
        }

    def seq_output(self, params, batch, rng, train, keeps=None):
        hidden = node_embeddings(params["item_emb"], batch)
        a_in, a_out = session_dense_adj(batch)
        for _ in range(self.step):
            hidden = srgnn_cell_dense(params["cell"], hidden, a_in, a_out)
        seq_hidden = gather_seq_hidden(hidden, batch)
        ht = last_hidden(seq_hidden, batch["item_seq_len"])
        stream = (KeepStream.of(keeps,
                                lambda: device_generator(rng, self.device))
                  if train else None)
        out = transformer_encoder(
            params["transformer"], seq_hidden,
            causal_additive_mask(seq_mask(batch)), keeps=stream,
            dropout=self.hidden_dropout_prob if train else 0.0,
            n_heads=self.n_heads,
            attn_dropout=self.attn_dropout_prob if train else 0.0)
        at = last_hidden(out, batch["item_seq_len"])
        return self.weight * at + (1.0 - self.weight) * ht

    def full_scores(self, params, consts, extras, batch, rng, train,
                    keeps=None):
        out = self.seq_output(params, batch, rng, train, keeps)
        return out @ params["item_emb"].T

    def calculate_loss(self, params, consts, extras, batch, rng, mode=0,
                       keeps=None):
        w = batch.get("weight")
        if self.loss_type == "BPR":
            out = self.seq_output(params, batch, rng, True, keeps)
            pos_e = embed(params["item_emb"], batch["item_id"])
            neg_e = embed(params["item_emb"], batch["neg_item_id"])
            loss = bpr_loss((out * pos_e).sum(-1), (out * neg_e).sum(-1), w)
        else:
            logits = self.full_scores(params, consts, extras, batch, rng,
                                      True, keeps)
            loss = cross_entropy(logits, batch["item_id"], w)
        # EmbLoss of the whole table divides by its row count ([recbole]
        # EmbLoss with a single argument)
        reg = emb_loss([params["item_emb"]], self.n_items)
        return loss + self.reg_weight * reg, {"loss": loss, "reg": reg}
