"""DirectAU — alignment + uniformity with an MF or LightGCN encoder.

Port of ``recbole_gnn_tpu/models/general/directau.py``: loss =
mean‖u − i‖² + γ·(uniformity(u) + uniformity(i)) / 2 over the batch's
L2-normalised user and positive-item rows, uniformity = log mean
exp(−2·‖xᵢ − xⱼ‖²) over the pairs; full-sort scores the raw (MF) or
propagated (LightGCN) embeddings, unnormalised.  With the LightGCN
encoder a training step runs ``n_layers`` SpMMs forward and as many
transpose SpMMs back.  The config's ``weight_decay`` (1e-6) reaches
the trainer's optimizer as for every model.
"""

from __future__ import annotations

import torch

from recbole_gnn_tpu_torch.models.base import GeneralGraphRecommender
from recbole_gnn_tpu_torch.models.init import split_keys, xavier_normal
from recbole_gnn_tpu_torch.models.layers import lightgcn_propagate
from recbole_gnn_tpu_torch.models.losses import (alignment_loss,
                                                 uniformity_loss)


class DirectAU(GeneralGraphRecommender):

    def __init__(self, config, dataset, device=None):
        super().__init__(config, dataset, device)
        self.embedding_size = int(config.get("embedding_size", 64))
        self.gamma = float(config.get("gamma", 0.5))
        self.encoder_name = str(config.or_default("encoder", "MF"))
        if self.encoder_name not in ("MF", "LightGCN"):
            raise ValueError(f"Non-implemented encoder {self.encoder_name!r}")
        self.n_layers = int(config.get("n_layers", 3))

    def init_params(self, gen):
        ku, ki = split_keys(gen, 2)
        return {
            "user_emb": xavier_normal(ku, (self.n_users, self.embedding_size),
                                      device=self.device),
            "item_emb": xavier_normal(ki, (self.n_items, self.embedding_size),
                                      device=self.device),
        }

    def _all_embeddings(self, params, consts):
        if self.encoder_name == "MF":
            return params["user_emb"], params["item_emb"]
        ego = torch.cat([params["user_emb"], params["item_emb"]], dim=0)
        layers = lightgcn_propagate(consts["graph"], ego, self.n_layers)
        final = torch.stack(layers, dim=0).mean(dim=0)
        return final[:self.n_users], final[self.n_users:]

    def propagate(self, params, consts, extras):
        return self._all_embeddings(params, consts)

    def calculate_loss(self, params, consts, extras, batch, rng, mode=0):
        user, item = batch["user_id"], batch["item_id"]
        w = batch.get("weight")
        u_all, i_all = self._all_embeddings(params, consts)
        u_e, i_e = u_all[user], i_all[item]
        u_e = u_e / torch.clamp(torch.linalg.vector_norm(
            u_e, dim=-1, keepdim=True), min=1e-12)
        i_e = i_e / torch.clamp(torch.linalg.vector_norm(
            i_e, dim=-1, keepdim=True), min=1e-12)
        align = alignment_loss(u_e, i_e, w)
        uniform = self.gamma * (uniformity_loss(u_e, w)
                                + uniformity_loss(i_e, w)) / 2.0
        return align + uniform, {"align": align, "uniform": uniform}
