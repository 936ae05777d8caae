"""DiffNet — recursive social influence diffusion.

Port of ``recbole_gnn_tpu/models/social/diffnet.py`` (reference
social_recommender/diffnet.py): the user tower is ``n_layers``
row-normalised social propagations summed over the layers, plus one
hop of item→user interest aggregation over the row-normalised U-I
matrix (:83-106); optional frozen pretrained review embeddings with a
distribution rescale (:64-81); BPR + EmbLoss.

Per training step: ``1 + n_layers`` products forward (the interest
aggregation and the social layers) and as many transposed products
back, through ``matvec_any`` (cuBLAS on a dense matrix, the SpMM
kernels on a sparse one).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F

from recbole_gnn_tpu_torch.models.base import SocialRecommender
from recbole_gnn_tpu_torch.models.init import (linear, linear_params,
                                               split_keys, xavier_uniform)
from recbole_gnn_tpu_torch.models.losses import bpr_loss, emb_loss
from recbole_gnn_tpu_torch.models.social.common import to_device_matrix
from recbole_gnn_tpu_torch.ops.spmm import matvec_any


class DiffNet(SocialRecommender):

    def __init__(self, config, dataset, device=None):
        super().__init__(config, dataset, device)
        self.embedding_size = int(config.get("embedding_size", 64))
        self.n_layers = int(config.get("n_layers", 2))
        self.reg_weight = float(config.get("reg_weight", 1e-5))
        self.pretrained_review = bool(config["pretrained_review"])
        dev = self.device
        if self.pretrained_review:
            # frozen review embeddings with distribution rescale
            # (reference diffnet.py:64-81), from the .user/.item
            # float_seq columns user_review_emb / item_review_emb
            u_rev = dataset.feat_matrix("user_feat", "user_review_emb")
            i_rev = dataset.feat_matrix("item_feat", "item_review_emb")
            if u_rev.shape[1] != self.embedding_size:
                raise ValueError(
                    "review embedding width must equal embedding_size")
            self.consts["user_review"] = torch.from_numpy(
                self._convert_distribution(u_rev)).to(dev)
            self.consts["item_review"] = torch.from_numpy(
                self._convert_distribution(i_rev)).to(dev)

        users, items = dataset.user_item_arrays()
        # U←I interest aggregation: A[u, i] = 1/deg(u) (reference
        # get_bipartite_inter_mat(row='user'), dataset.py:81-99)
        deg_u = np.bincount(users, minlength=self.n_users).astype(np.float64)
        a = sp.coo_matrix(
            ((1.0 / np.maximum(deg_u[users], 1.0)).astype(np.float32),
             (users, items)), shape=(self.n_users, self.n_items))
        self.consts["ui"] = to_device_matrix(a, config, device=dev)

        # social diffusion: new_u[s] = Σ_{(s,t)∈net} 1/deg(s) · u[t]
        # (reference forward :102, the conv over the flipped net)
        src, dst = dataset.net_edges()
        deg_s = np.bincount(src, minlength=self.n_users).astype(np.float64)
        s = sp.coo_matrix(
            ((1.0 / np.maximum(deg_s[src], 1.0)).astype(np.float32),
             (src, dst)), shape=(self.n_users, self.n_users))
        self.consts["net"] = to_device_matrix(s, config, device=dev)

    @staticmethod
    def _convert_distribution(x):
        """Rescale to mean 0, 0.2·std (reference convertDistribution
        :83-86)."""
        std = x.std()
        return (x - x.mean()) * 0.2 / (std if std > 0 else 1.0)

    def init_params(self, gen):
        d, dev = self.embedding_size, self.device
        ku, ki, kfu, kfi = split_keys(gen, 4)
        params = {
            "user_emb": xavier_uniform(ku, (self.n_users, d), device=dev),
            "item_emb": xavier_uniform(ki, (self.n_items, d), device=dev),
        }
        if self.pretrained_review:
            params["user_fusion"] = linear_params(kfu, d, d, device=dev)
            params["item_fusion"] = linear_params(kfi, d, d, device=dev)
        return params

    def propagate(self, params, consts, extras):
        u = params["user_emb"]
        items = params["item_emb"]
        if self.pretrained_review:
            def rescale(x):
                std = x.std(correction=0)
                return (x - x.mean()) * 0.2 / std.clamp_min(1e-12)

            u = u + rescale(torch.sigmoid(
                linear(params["user_fusion"], consts["user_review"])))
            items = items + rescale(torch.sigmoid(
                linear(params["item_fusion"], consts["item_review"])))
        from_items = matvec_any(consts["ui"], items)
        layers = [u]
        for _ in range(self.n_layers):
            u = matvec_any(consts["net"], u)
            layers.append(u)
        final_u = sum(layers) + from_items
        return final_u, items

    def calculate_loss(self, params, consts, extras, batch, rng, mode=0):
        user, pos, neg = (batch["user_id"], batch["item_id"],
                          batch["neg_item_id"])
        w = batch.get("weight")
        u_all, i_all = self.propagate(params, consts, extras)
        u_e = F.embedding(user, u_all)
        p_e, n_e = F.embedding(pos, i_all), F.embedding(neg, i_all)
        mf = bpr_loss((u_e * p_e).sum(-1), (u_e * n_e).sum(-1), w)
        reg = emb_loss([F.embedding(user, params["user_emb"]),
                        F.embedding(pos, params["item_emb"]),
                        F.embedding(neg, params["item_emb"])],
                       user.shape[0], weight=w)
        return mf + self.reg_weight * reg, {"mf": mf, "reg": reg}
