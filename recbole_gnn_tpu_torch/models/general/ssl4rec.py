"""SSL4REC — a DNN two-tower with item-dropout contrastive learning.

Port of ``recbole_gnn_tpu/models/general/ssl4rec.py``: user and item
towers emb → 1024 (ReLU) → 128 (tanh) over ID embeddings; in-batch
sampled-softmax rec loss + λ·InfoNCE between two dropped-out views of
the positive items through the item tower + EmbLoss; full-sort runs the
towers over every id.  No graph.

Dropout masks come from a generator derived from the trainer's;
``draws`` takes the JAX ones (keep₁, keep₂) in the tests.
"""

from __future__ import annotations

import torch

from recbole_gnn_tpu_torch.models.base import BaseRecommender, device_generator
from recbole_gnn_tpu_torch.models.layers import apply_dropout, dropout_keep
from recbole_gnn_tpu_torch.models.init import (linear, linear_params,
                                               split_keys, xavier_uniform)
from recbole_gnn_tpu_torch.models.losses import (batch_softmax_loss,
                                                 cl_nce_masked, emb_loss)
from recbole_gnn_tpu_torch.utils.enums import InputType, ModelType


class SSL4REC(BaseRecommender):

    model_type = ModelType.GENERAL
    input_type = InputType.PAIRWISE

    def __init__(self, config, dataset, device=None):
        super().__init__(config, dataset, device)
        self.emb_size = int(config.get("embedding_size", 64))
        self.tau = float(config.get("tau", 0.1))
        self.reg_weight = float(config.get("reg_weight", 1e-4))
        self.cl_rate = float(config.get("ssl_weight", 1e-5))
        self.drop_ratio = float(config.get("drop_ratio", 0.1))
        self.require_pow = bool(config["require_pow"])

    def init_params(self, gen):
        ks = split_keys(gen, 6)
        dev, d = self.device, self.emb_size
        return {
            "user_emb": xavier_uniform(ks[0], (self.n_users, d), device=dev),
            "item_emb": xavier_uniform(ks[1], (self.n_items, d), device=dev),
            "user_tower": [linear_params(ks[2], d, 1024, device=dev),
                           linear_params(ks[3], 1024, 128, device=dev)],
            "item_tower": [linear_params(ks[4], d, 1024, device=dev),
                           linear_params(ks[5], 1024, 128, device=dev)],
        }

    @staticmethod
    def _tower(tp, x):
        return torch.tanh(linear(tp[1], torch.relu(linear(tp[0], x))))

    def propagate(self, params, consts, extras):
        """The towers over the full catalogs (reference full-sort)."""
        return (self._tower(params["user_tower"], params["user_emb"]),
                self._tower(params["item_tower"], params["item_emb"]))

    def calculate_loss(self, params, consts, extras, batch, rng, mode=0,
                       draws: tuple | None = None):
        user, pos = batch["user_id"], batch["item_id"]
        w = batch.get("weight")
        u_e = self._tower(params["user_tower"], params["user_emb"][user])
        i_e = self._tower(params["item_tower"], params["item_emb"][pos])
        rec = batch_softmax_loss(u_e, i_e, self.tau, w)

        # item-dropout CL: two dropped views of the positive items' base
        # embeddings through the item tower (reference :146-163)
        base = params["item_emb"][pos]
        if draws is None:
            gen = device_generator(rng, self.device)
            draws = tuple(dropout_keep(gen, base.shape, self.drop_ratio)
                          for _ in range(2))
        v1, v2 = (self._tower(params["item_tower"],
                              apply_dropout(base, keep, self.drop_ratio))
                  for keep in draws)
        mask = (w > 0) if w is not None else torch.ones(
            pos.shape[0], dtype=torch.bool, device=pos.device)
        cl = cl_nce_masked(v1, v2, self.tau, mask, "mean")
        reg = emb_loss([u_e, i_e], user.shape[0],
                       require_pow=self.require_pow, weight=w)
        loss = rec + self.cl_rate * cl + self.reg_weight * reg
        return loss, {"rec": rec, "cl": cl, "reg": reg}
