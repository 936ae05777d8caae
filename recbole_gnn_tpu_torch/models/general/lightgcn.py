"""LightGCN — linear propagation over the normalised U-I graph.

Port of ``recbole_gnn_tpu/models/general/lightgcn.py`` (``init_params``
and ``propagate``; the loss comes with the training slice).  The
forward is K SpMMs over the static dst-sorted adjacency and the mean of
the layer-0..K embeddings.
"""

from __future__ import annotations

import torch

from recbole_gnn_tpu_torch.models.base import GeneralGraphRecommender
from recbole_gnn_tpu_torch.models.init import xavier_uniform
from recbole_gnn_tpu_torch.models.layers import lightgcn_propagate


class LightGCN(GeneralGraphRecommender):

    def __init__(self, config, dataset, device=None):
        super().__init__(config, dataset, device)
        self.latent_dim = int(config.get("embedding_size", 64))
        self.n_layers = int(config.get("n_layers", 2))
        self.reg_weight = float(config.get("reg_weight", 1e-5))
        self.require_pow = bool(config["require_pow"])

    def init_params(self, gen: torch.Generator):
        return {
            "user_emb": xavier_uniform(gen, (self.n_users, self.latent_dim),
                                       device=self.device),
            "item_emb": xavier_uniform(gen, (self.n_items, self.latent_dim),
                                       device=self.device),
        }

    def propagate(self, params, consts, extras):
        ego = torch.cat([params["user_emb"], params["item_emb"]], dim=0)
        layers = lightgcn_propagate(consts["graph"], ego, self.n_layers)
        final = torch.stack(layers, dim=0).mean(dim=0)
        return final[:self.n_users], final[self.n_users:]
