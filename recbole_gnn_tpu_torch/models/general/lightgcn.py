"""LightGCN — linear propagation over the normalised U-I graph.

Port of ``recbole_gnn_tpu/models/general/lightgcn.py``.  The forward
is K SpMMs over the static dst-sorted adjacency and the mean of the
layer-0..K embeddings; the loss is BPR + reg_weight·EmbLoss on the
layer-0 embeddings of the batch.  On a sparse graph each training step
runs K forward SpMMs and, in the backward, K transpose SpMMs.
"""

from __future__ import annotations

import torch

from recbole_gnn_tpu_torch.models.base import GeneralGraphRecommender
from recbole_gnn_tpu_torch.models.init import xavier_uniform
from recbole_gnn_tpu_torch.models.layers import lightgcn_propagate
from recbole_gnn_tpu_torch.models.losses import bpr_loss, emb_loss


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

    def calculate_loss(self, params, consts, extras, batch, rng, mode=0):
        user = batch["user_id"]
        pos = batch["item_id"]
        neg = batch["neg_item_id"]
        w = batch.get("weight")

        user_all, item_all = self.propagate(params, consts, extras)
        u_e, p_e, n_e = user_all[user], item_all[pos], item_all[neg]
        pos_scores = (u_e * p_e).sum(-1)
        neg_scores = (u_e * n_e).sum(-1)
        mf = bpr_loss(pos_scores, neg_scores, w)

        reg = emb_loss(
            [params["user_emb"][user], params["item_emb"][pos],
             params["item_emb"][neg]],
            batch_size=user.shape[0], require_pow=self.require_pow, weight=w)
        loss = mf + self.reg_weight * reg
        return loss, {"mf": mf, "reg": reg}
