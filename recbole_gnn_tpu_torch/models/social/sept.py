"""SEPT — socially-aware self-supervised tri-training.

Port of ``recbole_gnn_tpu/models/social/sept.py`` (reference
social_recommender/sept.py): the main LightGCN forward over the joint
U-I graph with a per-layer L2 norm and a layer sum (:145-163); the
friend view (S·S)⊙S + I and the sharing view (R·Rᵀ)⊙S + I, built on
the host (:91-109); a per-epoch edge-dropout subgraph over the joint
inter + social graph (:111-133, from ``warm_up_epochs`` on: ``loss_mode``
1); the pseudo-label top-``instance_cnt`` neighbour-discrimination
InfoNCE (:189-209, :240-279).

The subgraph keeps its edge list: the fixed joint edges (interactions
both ways, the net one way) are re-weighted once per epoch
(``epoch_start``) from keep masks by ``sym_norm_weights``, kept in the
extras (``sub_weight``; on ``ell`` also the ELL slot weights
``sub_ell`` / ``sub_ell_r``, gathered once per epoch).  The layouts
made from them are kept on the model, keyed by the identity of the
extras' tensors, so they and their kernel arguments are made once per
epoch, not per step.  The subgraph is built without the segment layout
(as the JAX package builds it), so on ``pallas`` it runs the segment
sum (D2 + D1), not the streaming kernel.

Per training step in mode 1 with sparse views: 8 products forward at 2
layers (the graph, the subgraph, the friend and the sharing views) and
8 transposed products back; in mode 0 the graph's 2 and 2.

The keep masks come from a generator derived from the trainer's;
``init_extras``/``epoch_start`` take the JAX ones in the tests
(``keeps``: the interaction keep mask and the net keep mask).  The
pseudo-label top-k is ``torch.topk``, whose tie order may differ from
``lax.top_k``'s.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F

from recbole_gnn_tpu_torch.models.base import (SocialRecommender,
                                               device_generator)
from recbole_gnn_tpu_torch.models.init import (l2_normalize, split_keys,
                                               xavier_uniform)
from recbole_gnn_tpu_torch.models.losses import bpr_loss, emb_loss
from recbole_gnn_tpu_torch.models.social.common import (
    sym_normalize_support, to_device_matrix)
from recbole_gnn_tpu_torch.ops.ell_spmm import reweight_ws, with_ws
from recbole_gnn_tpu_torch.ops.graphops import sym_norm_weights
from recbole_gnn_tpu_torch.ops.spmm import (build_graph, graph_impl,
                                            matvec_any, spmm, spmm_any)


def user_views(dataset):
    """The friend view (S·S)⊙S + I and the sharing view (R·Rᵀ)⊙S + I,
    each sym-normalised over its binary support (reference :91-109)."""
    s_src, s_dst, s_val = dataset.net_coo()
    u_arr, i_arr, y_val = dataset.inter_coo()
    n = dataset.n_users
    S = sp.coo_matrix((s_val, (s_src, s_dst)), shape=(n, n)).tocsr()
    R = sp.coo_matrix((y_val, (u_arr, i_arr)),
                      shape=(n, dataset.n_items)).tocsr()
    friend = (S.dot(S)).multiply(S) + sp.eye(n, format="csr")
    sharing = (R.dot(R.T)).multiply(S) + sp.eye(n, format="csr")
    return sym_normalize_support(friend), sym_normalize_support(sharing)


class SEPT(SocialRecommender):

    def __init__(self, config, dataset, device=None):
        super().__init__(config, dataset, device)
        self.latent_dim = int(config.get("embedding_size", 64))
        self.n_layers = int(config.get("n_layers", 2))
        self.drop_ratio = float(config.get("drop_ratio", 0.3))
        self.instance_cnt = int(config.get("instance_cnt", 10))
        self.reg_weight = float(config.get("reg_weight", 1e-5))
        self.ssl_weight = float(config.get("ssl_weight", 1e-7))
        self.ssl_tau = float(config.get("ssl_tau", 0.1))
        self.warm_up_epochs = int(config.get("warm_up_epochs", 100))
        dev = self.device

        # preference view: the joint sym-normalised U-I adjacency
        self.consts["graph"] = dataset.get_norm_adj_graph(device=dev)
        friend, sharing = user_views(dataset)
        self.consts["friend"] = to_device_matrix(friend, config, device=dev)
        self.consts["sharing"] = to_device_matrix(sharing, config,
                                                  device=dev)

        # static joint edge list of the per-epoch subgraph:
        # interactions both ways + the net one way (reference :111-133)
        n = self.n_users
        users, items = dataset.user_item_arrays()
        net_src, net_dst = dataset.net_edges()
        src = np.concatenate([users, items + n, net_src])
        dst = np.concatenate([items + n, users, net_dst])
        impl = str(config.get("sparse_spmm_impl", "ell"))
        self.consts["sub_graph"] = build_graph(
            src, dst, np.ones(len(src), np.float32), n + self.n_items,
            device=dev, impl=graph_impl(impl, False),
            precision=str(config.get("pallas_spmm_precision", "f32x2")),
            with_ell=impl == "ell")
        self._n_inter = len(users)
        self._n_net = len(net_src)
        # each dst-sorted edge's keep-mask entry: an interaction's mask
        # drives both its directions, net edges have their own
        order = np.argsort(dst, kind="stable")
        kind = np.concatenate([
            np.arange(self._n_inter), np.arange(self._n_inter),
            self._n_inter + np.arange(self._n_net)])
        self.consts["sub_edge_id"] = torch.from_numpy(
            kind[order].astype(np.int64)).to(dev)
        # (the extras tensors the subgraph was built from, the subgraph)
        self._sub: tuple | None = None
        self.layout_builds = 0

    def init_params(self, gen):
        ku, ki = split_keys(gen, 2)
        d, dev = self.latent_dim, self.device
        return {
            "user_emb": xavier_uniform(ku, (self.n_users, d), device=dev),
            "item_emb": xavier_uniform(ki, (self.n_items, d), device=dev),
        }

    # -- per-epoch subgraph ------------------------------------------------

    def draw_keeps(self, gen: torch.Generator) -> tuple:
        """(interaction keep mask, net keep mask), each kept with
        probability 1 − drop_ratio."""
        k1, k2 = split_keys(gen, 2)
        return (torch.rand(self._n_inter, generator=k1,
                           device=k1.device) >= self.drop_ratio,
                torch.rand(self._n_net, generator=k2,
                           device=k2.device) >= self.drop_ratio)

    def _make_extras(self, gen, consts, keeps=None):
        if keeps is None:
            keeps = self.draw_keeps(gen)
        keep = torch.cat([k.to(self.device) for k in keeps])
        g = consts["sub_graph"]
        w = sym_norm_weights(g.src, g.dst, g.n_nodes,
                             mask=keep[consts["sub_edge_id"]])
        out = {"sub_weight": w}
        if g.ell is not None:
            out["sub_ell"] = reweight_ws(g.ell, w[:g.n_edges])
            out["sub_ell_r"] = reweight_ws(g.rev_ell, w[:g.n_edges])
        return out

    def init_extras(self, gen, keeps=None):
        with torch.no_grad():
            return self._make_extras(
                None if keeps is not None else device_generator(
                    gen, self.device), self.consts, keeps)

    def epoch_start(self, epoch, params, consts, extras, rng, keeps=None):
        if epoch < self.warm_up_epochs:
            return extras
        with torch.no_grad():
            return self._make_extras(
                None if keeps is not None else device_generator(
                    rng, self.device), consts, keeps)

    def loss_mode(self, epoch):
        # mode 0 = warm-up: the rec loss only (reference SEPTTrainer
        # :174-179)
        return 0 if epoch < self.warm_up_epochs else 1

    def _sub_graph(self, consts, extras):
        """The epoch's subgraph: on its ELL layouts, made once per
        extras (cached by the tensors' identity), or re-weighted."""
        g0 = consts["sub_graph"]
        if "sub_ell" not in extras or g0.ell is None:
            return g0.with_weight(extras["sub_weight"])
        tensors = (extras["sub_weight"], *extras["sub_ell"],
                   *extras["sub_ell_r"])
        if self._sub is not None and len(self._sub[0]) == len(tensors) \
                and all(a is b for a, b in zip(self._sub[0], tensors)):
            return self._sub[1]
        sub = replace(g0, weight=extras["sub_weight"], rev_weight=None,
                      ell=with_ws(g0.ell, extras["sub_ell"]),
                      rev_ell=with_ws(g0.rev_ell, extras["sub_ell_r"]))
        self.layout_builds += 1
        self._sub = (tensors, sub)
        return sub

    # -- forwards ----------------------------------------------------------

    def _joint_forward(self, params, graph_apply):
        x = torch.cat([params["user_emb"], params["item_emb"]], dim=0)
        outs = [x]
        for _ in range(self.n_layers):
            x = graph_apply(x)
            outs.append(l2_normalize(x))
        final = sum(outs)
        return final[:self.n_users], final[self.n_users:]

    def propagate(self, params, consts, extras):
        return self._joint_forward(
            params, lambda x: spmm_any(consts["graph"], x))

    def _user_view_forward(self, params, consts):
        def run(mat):
            u = params["user_emb"]
            outs = [u]
            for _ in range(self.n_layers):
                u = matvec_any(mat, u)
                outs.append(l2_normalize(u))
            return sum(outs)

        return run(consts["friend"]), run(consts["sharing"])

    # -- losses ------------------------------------------------------------

    def _ssl_loss(self, aug_u, positive_idx, emb, wmask):
        pos_emb = F.embedding(positive_idx, aug_u)          # (B, k, D)
        pos_score = (emb[:, None, :] * pos_emb).sum(2)
        ttl = torch.matmul(emb, aug_u.T)
        ttl = torch.where(wmask[None, :] > 0, ttl, -1e30)
        pos_sum = torch.exp(pos_score / self.ssl_tau).sum(1)
        ttl_sum = torch.exp(torch.clamp(ttl / self.ssl_tau, -60, 60)).sum(1)
        loss = -torch.log(pos_sum.clamp_min(1e-24) / ttl_sum.clamp_min(1e-24))
        return (loss * wmask).sum()

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
        rec_loss = mf + self.reg_weight * reg
        aux = {"mf": mf, "reg": reg}
        if mode == 0:
            return rec_loss, aux

        sub = self._sub_graph(consts, extras)
        aug_u_all, _ = self._joint_forward(params, lambda x: spmm(sub, x))
        friend_all, sharing_all = self._user_view_forward(params, consts)

        wmask = w if w is not None else torch.ones(
            user.shape[0], device=user.device)
        aug_u = l2_normalize(F.embedding(user, aug_u_all))
        social_u = l2_normalize(F.embedding(user, friend_all))
        sharing_u = l2_normalize(F.embedding(user, sharing_all))
        rec_u = l2_normalize(F.embedding(user, u_all))

        with torch.no_grad():   # the pseudo-labels carry no gradient
            def label_prob(e):
                logits = torch.matmul(e, aug_u.T)
                logits = torch.where(wmask[None, :] > 0, logits, -1e30)
                return torch.softmax(logits, dim=1)

            social_pred = label_prob(social_u)
            sharing_pred = label_prob(sharing_u)
            rec_pred = label_prob(rec_u)

            def pseudo(p1, p2):
                return torch.topk((p1 + p2) / 2.0, self.instance_cnt,
                                  dim=1).indices

            friend_pos = pseudo(sharing_pred, rec_pred)
            sharing_pos = pseudo(social_pred, rec_pred)
            rec_pos = pseudo(social_pred, sharing_pred)

        ssl = (self._ssl_loss(aug_u, friend_pos, social_u, wmask) +
               self._ssl_loss(aug_u, sharing_pos, sharing_u, wmask) +
               self._ssl_loss(aug_u, rec_pos, rec_u, wmask))
        aux["ssl"] = ssl
        return rec_loss + self.ssl_weight * ssl, aux
