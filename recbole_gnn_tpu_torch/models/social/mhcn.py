"""MHCN — multi-channel hypergraph convolution over motif adjacencies.

Port of ``recbole_gnn_tpu/models/social/mhcn.py`` (reference
social_recommender/mhcn.py): ten triangle/motif adjacencies A1..A10
from scipy sparse algebra over the social matrix S and the interaction
matrix Y (:129-158), gathered into three row-normalised hypergraph
channels H_s / H_j / H_p; per layer three channel convolutions,
attention mixing and the bipartite item/user convolutions with
self-gating per channel (:160-215); hierarchical MIM self-supervision
with row and row-column shuffles (:217-241); BPR + ssl_reg·MIM + reg.

The motif algebra stays host-side scipy and never densifies; the
channel and interaction matrices go to the device through
``to_device_matrix`` (dense under ``dense_graph_max_entries``, sparse
graphs above it or with ``enable_sparse``).  Per training step:
5 products per layer forward (three channels, R_iu, R_ui) and one per
channel in the MIM, as many transposed products back.

MIM's three permutations per channel come from a generator derived
from the trainer's; ``perms`` takes the JAX ones in the tests (per
channel (row perm, second row perm, column perm), in the order H_s,
H_j, H_p).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F

from recbole_gnn_tpu_torch.models.base import (SocialRecommender,
                                               device_generator)
from recbole_gnn_tpu_torch.models.init import (l2_normalize, linear,
                                               linear_params, normal_init,
                                               split_keys, xavier_uniform)
from recbole_gnn_tpu_torch.models.losses import bpr_loss, emb_loss
from recbole_gnn_tpu_torch.models.social.common import (row_normalize,
                                                        to_device_matrix)
from recbole_gnn_tpu_torch.ops.spmm import matvec_any

_CHANNELS = (("H_s", "ss_gating_c1"), ("H_j", "ss_gating_c2"),
             ("H_p", "ss_gating_c3"))


def motif_matrices(dataset):
    """A1..A10 motif algebra (reference get_motif_adj_matrix :129-158),
    host scipy; returns the SPARSE row-normalised H_s, H_j, H_p."""
    s_src, s_dst, s_val = dataset.net_coo()
    u_arr, i_arr, y_val = dataset.inter_coo()
    n = dataset.n_users
    S = sp.coo_matrix((s_val, (s_src, s_dst)), shape=(n, n)).tocsr()
    Y = sp.coo_matrix((y_val, (u_arr, i_arr)),
                      shape=(n, dataset.n_items)).tocsr()
    B = S.multiply(S.T)
    U = S - B
    C1 = (U.dot(U)).multiply(U.T)
    A1 = C1 + C1.T
    C2 = (B.dot(U)).multiply(U.T) + (U.dot(B)).multiply(U.T) + \
        (U.dot(U)).multiply(B)
    A2 = C2 + C2.T
    C3 = (B.dot(B)).multiply(U) + (B.dot(U)).multiply(B) + \
        (U.dot(B)).multiply(B)
    A3 = C3 + C3.T
    A4 = (B.dot(B)).multiply(B)
    C5 = (U.dot(U)).multiply(U) + (U.dot(U.T)).multiply(U) + \
        (U.T.dot(U)).multiply(U)
    A5 = C5 + C5.T
    A6 = (U.dot(B)).multiply(U) + (B.dot(U.T)).multiply(U.T) + \
        (U.T.dot(U)).multiply(B)
    A7 = (U.T.dot(B)).multiply(U.T) + (B.dot(U)).multiply(U) + \
        (U.dot(U.T)).multiply(B)
    A8 = (Y.dot(Y.T)).multiply(B)
    A9 = (Y.dot(Y.T)).multiply(U)
    A9 = A9 + A9.T
    A10 = Y.dot(Y.T) - A8 - A9
    H_s = row_normalize(A1 + A2 + A3 + A4 + A5 + A6 + A7)
    H_j = row_normalize(A8 + A9)
    A10 = sp.csr_matrix(A10)
    A10.data = A10.data * (A10.data > 1)   # reference H_p·(H_p > 1)
    A10.eliminate_zeros()
    H_p = row_normalize(A10)
    return H_s, H_j, H_p


def interaction_matrix(dataset) -> sp.csr_matrix:
    """R[u, i] = 1/√(deg u · deg i) over the (non-deduplicated)
    interactions."""
    users, items = dataset.user_item_arrays()
    n_users, n_items = dataset.n_users, dataset.n_items
    deg_u = np.bincount(users, minlength=n_users).astype(np.float64)
    deg_i = np.bincount(items, minlength=n_items).astype(np.float64)
    w = 1.0 / np.sqrt(np.maximum(deg_u[users] * deg_i[items], 1e-12))
    return sp.coo_matrix((w.astype(np.float32), (users, items)),
                         shape=(n_users, n_items)).tocsr()


class MHCN(SocialRecommender):

    def __init__(self, config, dataset, device=None):
        super().__init__(config, dataset, device)
        self.embedding_size = int(config.get("embedding_size", 64))
        self.n_layers = int(config.get("n_layers", 2))
        self.ssl_reg = float(config.get("ssl_reg", 1e-5))
        self.reg_weight = float(config.get("reg_weight", 1e-5))
        dev = self.device
        for name, h in zip(("H_s", "H_j", "H_p"), motif_matrices(dataset)):
            self.consts[name] = to_device_matrix(h, config, device=dev)
        r = interaction_matrix(dataset)
        # both propagation directions as separate device matrices
        self.consts["R_ui"] = to_device_matrix(r, config, device=dev)
        self.consts["R_iu"] = to_device_matrix(r.T.tocsr(), config,
                                               device=dev)

    def init_params(self, gen):
        d, dev = self.embedding_size, self.device
        ks = split_keys(gen, 12)

        def gate(k):
            return {"lin": linear_params(k, d, d, device=dev)}

        return {
            "user_emb": xavier_uniform(ks[0], (self.n_users, d), device=dev),
            "item_emb": xavier_uniform(ks[1], (self.n_items, d), device=dev),
            "gating_c1": gate(ks[2]), "gating_c2": gate(ks[3]),
            "gating_c3": gate(ks[4]), "gating_simple": gate(ks[5]),
            "ss_gating_c1": gate(ks[6]), "ss_gating_c2": gate(ks[7]),
            "ss_gating_c3": gate(ks[8]),
            "att_mat": normal_init(ks[9], (d, d), 1.0, device=dev),
            "att_vec": normal_init(ks[10], (1, d), 1.0, device=dev),
        }

    @staticmethod
    def _gate(p, x):
        return x * torch.sigmoid(linear(p["lin"], x))

    @staticmethod
    def _attention(params, *embs):
        weights = [(params["att_vec"] * torch.matmul(e, params["att_mat"])
                    ).sum(1) for e in embs]
        score = torch.softmax(torch.stack(weights, dim=0), dim=0)
        return (torch.stack(embs, dim=0) * score[:, :, None]).sum(0)

    def propagate(self, params, consts, extras):
        u = params["user_emb"]
        item_embeddings = params["item_emb"]
        c1 = self._gate(params["gating_c1"], u)
        c2 = self._gate(params["gating_c2"], u)
        c3 = self._gate(params["gating_c3"], u)
        simple = self._gate(params["gating_simple"], u)
        all_c1, all_c2, all_c3 = [c1], [c2], [c3]
        all_simple = [simple]
        all_i = [item_embeddings]
        for _ in range(self.n_layers):
            mixed = self._attention(params, c1, c2, c3) + simple / 2.0
            c1 = matvec_any(consts["H_s"], c1)
            all_c1.append(l2_normalize(c1))
            c2 = matvec_any(consts["H_j"], c2)
            all_c2.append(l2_normalize(c2))
            c3 = matvec_any(consts["H_p"], c3)
            all_c3.append(l2_normalize(c3))
            new_items = matvec_any(consts["R_iu"], mixed)
            all_i.append(l2_normalize(new_items))
            simple = matvec_any(consts["R_ui"], item_embeddings)
            all_simple.append(l2_normalize(simple))
            item_embeddings = new_items
        users = (self._attention(params, sum(all_c1), sum(all_c2),
                                 sum(all_c3)) + sum(all_simple) / 2.0)
        return users, sum(all_i)

    def draw_perms(self, gen: torch.Generator) -> list:
        """Per channel (row perm, second row perm, column perm), drawn
        on the model's device."""
        n, d = self.n_users, self.embedding_size
        return [tuple(torch.randperm(m, generator=gen, device=gen.device)
                      for m in (n, n, d)) for _ in _CHANNELS]

    def _mim(self, params, consts, user_all, h_key, gate_key, perms):
        """Hierarchical mutual-information self-supervision (reference
        :217-241), sum-reduced."""
        emb = self._gate(params[gate_key], user_all)
        edge = matvec_any(consts[h_key], emb)
        perm_r, perm_r2, perm_c = (p.to(emb.device) for p in perms)

        def score(a, b):
            return (a * b).sum(1)

        rc_shuffled = F.embedding(perm_r2, edge.index_select(1, perm_c))
        pos = score(emb, edge)
        neg1 = score(F.embedding(perm_r, emb), edge)
        neg2 = score(rc_shuffled, emb)
        local = (-F.logsigmoid(pos - neg1) - F.logsigmoid(neg1 - neg2)).sum()
        graph = edge.mean(0, keepdim=True)
        pos_g = score(edge, graph)
        neg_g = score(rc_shuffled, graph)
        glob = (-F.logsigmoid(pos_g - neg_g)).sum()
        return local + glob

    def calculate_loss(self, params, consts, extras, batch, rng, mode=0,
                       perms=None):
        user, pos, neg = (batch["user_id"], batch["item_id"],
                          batch["neg_item_id"])
        w = batch.get("weight")
        u_all, i_all = self.propagate(params, consts, extras)
        u_e = F.embedding(user, u_all)
        p_e, n_e = F.embedding(pos, i_all), F.embedding(neg, i_all)
        mf = bpr_loss((u_e * p_e).sum(-1), (u_e * n_e).sum(-1), w)
        if perms is None:
            perms = self.draw_perms(device_generator(rng, self.device))
        ss = sum(self._mim(params, consts, u_all, h, g, p)
                 for (h, g), p in zip(_CHANNELS, perms))
        reg = emb_loss([F.embedding(user, params["user_emb"]),
                        F.embedding(pos, params["item_emb"]),
                        F.embedding(neg, params["item_emb"])],
                       user.shape[0], weight=w)
        loss = mf + self.ssl_reg * ss + self.reg_weight * reg
        return loss, {"mf": mf, "ssl": ss, "reg": reg}
