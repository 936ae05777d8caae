"""BPR — matrix factorization with the BPR pairwise loss.

Port of ``recbole_gnn_tpu/models/general/bpr.py``, the RecBole-fallback
baseline: user/item ID embeddings, xavier-normal init, BPR loss only.
"""

from __future__ import annotations

from recbole_gnn_tpu_torch.models.base import BaseRecommender
from recbole_gnn_tpu_torch.models.init import xavier_normal
from recbole_gnn_tpu_torch.models.losses import bpr_loss


class BPR(BaseRecommender):

    def __init__(self, config, dataset, device=None):
        super().__init__(config, dataset, device)
        self.embedding_size = int(config.get("embedding_size", 64))

    def init_params(self, gen):
        shape_u = (self.n_users, self.embedding_size)
        shape_i = (self.n_items, self.embedding_size)
        return {"user_emb": xavier_normal(gen, shape_u, device=self.device),
                "item_emb": xavier_normal(gen, shape_i, device=self.device)}

    def propagate(self, params, consts, extras):
        return params["user_emb"], params["item_emb"]

    def calculate_loss(self, params, consts, extras, batch, rng, mode=0):
        user, pos, neg = batch["user_id"], batch["item_id"], batch["neg_item_id"]
        w = batch.get("weight")
        u = params["user_emb"][user]
        loss = bpr_loss((u * params["item_emb"][pos]).sum(-1),
                        (u * params["item_emb"][neg]).sum(-1), w)
        return loss, {"mf": loss}
