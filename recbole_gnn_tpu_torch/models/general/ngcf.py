"""NGCF — bi-interaction GNN towers over the normalised U-I graph.

Port of ``recbole_gnn_tpu/models/general/ngcf.py``: a stack of BiGNN
convs, each followed by LeakyReLU(0.2), message dropout and the smooth
L2 normalisation, the layer outputs concatenated; BPR + EmbLoss on the
*propagated* rows of the batch.  On a sparse graph a training step runs
one SpMM per layer forward and one transpose SpMM per layer back.

With ``node_dropout > 0`` the edges are dropped once per forward and
every layer shares the dropped graph.  On a sparse graph that is
``Graph.with_weight``: the re-weighted graph loses its ELL layouts, so
an ``ell`` graph runs ``xla`` (row gather + block segment sum) for that
step, as the JAX package falls back to its segment sum.  The dense
graph draws one mask per direction (``spmm_dense_bipartite_dropout``).

Draws (edge mask, message masks) come from a generator derived from the
trainer's; ``draws`` takes the JAX ones in the tests:
``{"edge_keep": (E_pad,) bool | (m₁, m₂), "msg_keep": [per layer]}``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from recbole_gnn_tpu_torch.models.base import (GeneralGraphRecommender,
                                               device_generator)
from recbole_gnn_tpu_torch.models.init import (l2_normalize, linear,
                                               split_keys, xavier_normal)
from recbole_gnn_tpu_torch.models.layers import (apply_dropout, bignn_params,
                                                 dropout_keep)
from recbole_gnn_tpu_torch.models.losses import bpr_loss, emb_loss
from recbole_gnn_tpu_torch.ops.graphops import edge_dropout_mask
from recbole_gnn_tpu_torch.ops.spmm import (BipartiteDenseGraph,
                                            dense_dropout_masks, spmm_any,
                                            spmm_dense_bipartite_dropout)


class NGCF(GeneralGraphRecommender):

    def __init__(self, config, dataset, device=None):
        super().__init__(config, dataset, device)
        self.embedding_size = int(config.get("embedding_size", 64))
        self.hidden_size_list = [self.embedding_size] + list(
            config.or_default("hidden_size_list", [64, 64, 64]))
        self.node_dropout = float(config.get("node_dropout", 0.0))
        self.message_dropout = float(config.get("message_dropout", 0.0))
        self.reg_weight = float(config.get("reg_weight", 1e-5))

    def init_params(self, gen):
        keys = split_keys(gen, 2 + len(self.hidden_size_list) - 1)
        dev = self.device
        return {
            "user_emb": xavier_normal(keys[0], (self.n_users,
                                                self.embedding_size),
                                      device=dev),
            "item_emb": xavier_normal(keys[1], (self.n_items,
                                                self.embedding_size),
                                      device=dev),
            "layers": [bignn_params(k, d_in, d_out, device=dev)
                       for k, d_in, d_out in zip(
                           keys[2:], self.hidden_size_list[:-1],
                           self.hidden_size_list[1:])],
        }

    def _forward(self, params, consts, gen, train: bool, draws=None):
        graph = consts["graph"]
        draws = draws or {}
        dense = isinstance(graph, BipartiteDenseGraph)
        x = torch.cat([params["user_emb"], params["item_emb"]], dim=0)
        outs = [x]
        masks = None
        dropped = graph
        if train and self.node_dropout > 0:
            keep = draws.get("edge_keep")
            if dense:
                masks = keep if keep is not None else dense_dropout_masks(
                    gen, graph, self.node_dropout)
            else:
                if keep is None:
                    keep = edge_dropout_mask(gen, graph.n_edges_padded,
                                             self.node_dropout)
                dropped = graph.with_weight(graph.weight
                                            * keep.to(torch.float32))
        msg = draws.get("msg_keep")
        for i, lp in enumerate(params["layers"]):
            if masks is not None:
                x_prop = spmm_dense_bipartite_dropout(graph, x, masks)
            else:
                x_prop = spmm_any(dropped, x)
            x = linear(lp["lin1"], x_prop + x) + linear(lp["lin2"],
                                                        x_prop * x)
            x = F.leaky_relu(x, negative_slope=0.2)
            if train and self.message_dropout > 0:
                keep = (msg[i] if msg is not None else
                        dropout_keep(gen, x.shape, self.message_dropout))
                x = apply_dropout(x, keep, self.message_dropout)
            x = l2_normalize(x)
            outs.append(x)
        all_emb = torch.cat(outs, dim=1)
        return all_emb[:self.n_users], all_emb[self.n_users:]

    def propagate(self, params, consts, extras):
        return self._forward(params, consts, None, False)

    def calculate_loss(self, params, consts, extras, batch, rng, mode=0,
                       draws: dict | None = None):
        user, pos, neg = (batch["user_id"], batch["item_id"],
                          batch["neg_item_id"])
        w = batch.get("weight")
        gen = None if draws is not None else device_generator(rng,
                                                              self.device)
        user_all, item_all = self._forward(params, consts, gen, True, draws)
        u_e, p_e, n_e = user_all[user], item_all[pos], item_all[neg]
        mf = bpr_loss((u_e * p_e).sum(-1), (u_e * n_e).sum(-1), w)
        # the reg on the propagated rows (reference ngcf.py:124)
        reg = emb_loss([u_e, p_e, n_e], user.shape[0], weight=w)
        return mf + self.reg_weight * reg, {"mf": mf, "reg": reg}
