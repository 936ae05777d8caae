"""LightGCL — SVD-guided graph contrastive learning.

Port of ``recbole_gnn_tpu/models/general/lightgcl.py``: its own
sym-normalised rectangular adjacency (1/√(deg_u·deg_i)); K layers of
U ← A·I and I ← Aᵀ·U with value dropout, the layers summed; a rank-q
randomized SVD of A at construction (``ops/svd.py``); BPR (mean) +
λ₂·Σ‖E‖² + λ₁·(InfoNCE between the SVD-propagated view and the
embeddings, positives clamped to ±5).  At 2 layers a training step
runs 4 SpMMs forward and 4 transpose SpMMs back.

The sparse form holds A as two rectangular graphs, ``adj_ui`` (users ←
items) and ``adj_iu``, built with the config's ``sparse_spmm_impl`` and
``pallas_spmm_precision``: on ``ell`` they carry rectangular ELL
layouts and run K2, on ``pallas`` K1.  With ``dropout > 0`` each step
re-weights them (``Graph.with_weight``), and an ``ell`` graph then runs
``xla`` for the step, as the JAX package falls back to its segment sum.

Draws: the SVD's Gaussian sketch comes from a generator seeded with
``seed`` on the model's device, or ``svd_omega``; the dropout masks
from a generator derived from the trainer's, or ``draws`` in the tests
(per layer the (keep_ui, keep_iu) masks over the edges; the dense form
one mask over the block).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from recbole_gnn_tpu_torch.models.base import BaseRecommender, device_generator
from recbole_gnn_tpu_torch.models.layers import dropout_keep
from recbole_gnn_tpu_torch.models.init import split_keys, xavier_uniform
from recbole_gnn_tpu_torch.models.losses import reg_loss_l2
from recbole_gnn_tpu_torch.ops.spmm import build_graph, spmm
from recbole_gnn_tpu_torch.ops.svd import randomized_svd_sparse
from recbole_gnn_tpu_torch.utils.enums import InputType, ModelType


class LightGCL(BaseRecommender):

    model_type = ModelType.GENERAL
    input_type = InputType.PAIRWISE

    def __init__(self, config, dataset, device=None,
                 svd_omega: torch.Tensor | None = None):
        super().__init__(config, dataset, device)
        self.embed_dim = int(config.get("embedding_size", 64))
        self.n_layers = int(config.get("n_layers", 2))
        self.dropout = float(config.get("dropout", 0.0))
        self.temp = float(config.get("temp", 0.8))
        self.lambda_1 = float(config.get("lambda1", 0.01))
        self.lambda_2 = float(config.get("lambda2", 1e-5))
        self.q = int(config.get("q", 5))

        users, items = dataset.user_item_arrays()
        row_deg = np.bincount(users, minlength=self.n_users).astype(np.float64)
        col_deg = np.bincount(items, minlength=self.n_items).astype(np.float64)
        w = (1.0 / np.sqrt(np.maximum(row_deg[users] * col_deg[items],
                                      1e-12))).astype(np.float32)
        max_entries = int(config.get("dense_graph_max_entries", 3e8))
        self._dense = (config["enable_sparse"] is not True
                       and self.n_users * self.n_items <= max_entries)
        dev = self.device
        if self._dense:
            a = np.zeros((self.n_users, self.n_items), dtype=np.float32)
            np.add.at(a, (users, items), w)
            self.consts["adj"] = torch.from_numpy(a).to(dev)
        else:
            kw = dict(device=dev,
                      with_pallas=config["use_pallas_spmm"] is not False,
                      impl=str(config.get("sparse_spmm_impl", "ell")),
                      precision=str(config.get("pallas_spmm_precision",
                                               "f32x2")))
            self.consts["adj_ui"] = build_graph(
                items, users, w, self.n_users, n_src_nodes=self.n_items, **kw)
            self.consts["adj_iu"] = build_graph(
                users, items, w, self.n_items, n_src_nodes=self.n_users, **kw)

        # rank-q randomized SVD of the normalised adjacency (init time)
        gen = (None if svd_omega is not None else torch.Generator(
            device=dev).manual_seed(int(config.get("seed", 2020))))
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        svd_u, s, svd_v = randomized_svd_sparse(
            gen, t(users), t(items), t(w), self.n_users, self.n_items,
            self.q, omega=svd_omega)
        self.consts["u_mul_s"] = svd_u * s[None, :]
        self.consts["v_mul_s"] = svd_v * s[None, :]
        self.consts["ut"] = svd_u.T.contiguous()
        self.consts["vt"] = svd_v.T.contiguous()

    def init_params(self, gen):
        ku, ki = split_keys(gen, 2)
        return {
            "user_emb": xavier_uniform(ku, (self.n_users, self.embed_dim),
                                       device=self.device),
            "item_emb": xavier_uniform(ki, (self.n_items, self.embed_dim),
                                       device=self.device),
        }

    def _forward_lists(self, params, consts, gen, train: bool, draws=None):
        e_u_list, e_i_list = [params["user_emb"]], [params["item_emb"]]
        p = self.dropout
        for layer in range(self.n_layers):
            drop = train and p > 0
            if self._dense:
                a_l = consts["adj"]
                if drop:
                    keep = (draws[layer] if draws is not None else
                            dropout_keep(gen, a_l.shape, p))
                    a_l = torch.where(keep, a_l / (1.0 - p),
                                      torch.zeros_like(a_l))
                z_u = torch.matmul(a_l, e_i_list[-1])
                z_i = torch.matmul(a_l.T, e_u_list[-1])
            else:
                g_ui, g_iu = consts["adj_ui"], consts["adj_iu"]
                if drop:
                    # F.dropout on the values: a keep + scale per edge,
                    # drawn apart for each direction (reference :131-136)
                    k1, k2 = (draws[layer] if draws is not None else
                              (dropout_keep(gen, g_ui.weight.shape, p),
                               dropout_keep(gen, g_iu.weight.shape, p)))
                    g_ui = g_ui.with_weight(g_ui.weight * k1 / (1.0 - p))
                    g_iu = g_iu.with_weight(g_iu.weight * k2 / (1.0 - p))
                z_u = spmm(g_ui, e_i_list[-1])
                z_i = spmm(g_iu, e_u_list[-1])
            e_u_list.append(z_u)
            e_i_list.append(z_i)
        return e_u_list, e_i_list

    def propagate(self, params, consts, extras):
        e_u_list, e_i_list = self._forward_lists(params, consts, None, False)
        return sum(e_u_list), sum(e_i_list)

    def calculate_loss(self, params, consts, extras, batch, rng, mode=0,
                       draws: list | None = None):
        user, pos, neg = (batch["user_id"], batch["item_id"],
                          batch["neg_item_id"])
        w = batch.get("weight")
        gen = (None if draws is not None or self.dropout <= 0
               else device_generator(rng, self.device))
        e_u_list, e_i_list = self._forward_lists(params, consts, gen, True,
                                                 draws)
        e_u, e_i = sum(e_u_list), sum(e_i_list)

        def _mean(x):
            if w is not None:
                return (x * w).sum() / torch.clamp(w.sum(), min=1.0)
            return x.mean()

        u_e, p_e, n_e = e_u[user], e_i[pos], e_i[neg]
        l_bpr = _mean(-F.logsigmoid((u_e * p_e).sum(-1)
                                    - (u_e * n_e).sum(-1)))
        reg = self.lambda_2 * reg_loss_l2([params["user_emb"],
                                           params["item_emb"]])

        # the SVD-propagated views (reference calc_ssl_loss :196-206)
        g_u_list, g_i_list = [params["user_emb"]], [params["item_emb"]]
        for layer in range(self.n_layers):
            g_u_list.append(torch.matmul(
                consts["u_mul_s"], torch.matmul(consts["vt"],
                                                e_i_list[layer])))
            g_i_list.append(torch.matmul(
                consts["v_mul_s"], torch.matmul(consts["ut"],
                                                e_u_list[layer])))
        g_u, g_i = sum(g_u_list), sum(g_i_list)

        # log Σ exp as logsumexp (the reference's raw exp can overflow)
        neg_score = (_mean(torch.logsumexp(
            torch.matmul(g_u[user], e_u.T) / self.temp, dim=1))
            + _mean(torch.logsumexp(
                torch.matmul(g_i[pos], e_i.T) / self.temp, dim=1)))
        pos_score = (_mean(torch.clamp(
            (g_u[user] * e_u[user]).sum(-1) / self.temp, -5.0, 5.0))
            + _mean(torch.clamp(
                (g_i[pos] * e_i[pos]).sum(-1) / self.temp, -5.0, 5.0)))
        ssl = self.lambda_1 * (neg_score - pos_score)
        loss = l_bpr + reg + ssl
        return loss, {"bpr": l_bpr, "reg": reg, "ssl": ssl}
