"""XSimGCL — one perturbed forward, a cross-layer contrastive view.

Port of ``recbole_gnn_tpu/models/general/xsimgcl.py``.  One perturbed
forward (SimGCL's noise) gives both the layer mean over layers 1..K and
the layer-``layer_cl`` embedding, the contrastive view; the loss is BPR
+ reg_weight·EmbLoss + λ·InfoNCE between the two over the batch's
unique users and items, mean-reduced.  On a sparse graph a training
step runs K forward SpMMs and K transpose SpMMs.  The noise comes from
the trainer's generator as SimGCL's does (``noise`` takes the JAX
draws in the tests).
"""

from __future__ import annotations

import torch

from recbole_gnn_tpu_torch.models.base import device_generator
from recbole_gnn_tpu_torch.models.general.lightgcn import LightGCN
from recbole_gnn_tpu_torch.models.general.simgcl import perturb
from recbole_gnn_tpu_torch.models.losses import (bpr_loss, cl_nce_masked,
                                                 emb_loss, masked_unique)
from recbole_gnn_tpu_torch.ops.spmm import spmm_any


class XSimGCL(LightGCN):

    def __init__(self, config, dataset, device=None):
        super().__init__(config, dataset, device)
        self.cl_rate = float(config.get("lambda", 0.1))
        self.eps = float(config.get("eps", 0.2))
        self.temperature = float(config.get("temperature", 0.2))
        self.layer_cl = int(config.get("layer_cl", 1))

    def _forward(self, params, consts, rng, perturbed: bool,
                 noise: list | None = None):
        """(users, items, users_cl, items_cl): the layer mean over
        layers 1..K and layer ``layer_cl``; perturbed, each layer takes
        ``noise[k]`` or a draw from ``rng``."""
        x = torch.cat([params["user_emb"], params["item_emb"]], dim=0)
        x_cl = x
        outs = []
        for k in range(self.n_layers):
            x = spmm_any(consts["graph"], x)
            if perturbed:
                x = perturb(x, self.eps, rng,
                            None if noise is None else noise[k])
            outs.append(x)
            if k == self.layer_cl - 1:
                x_cl = x
        final = torch.stack(outs, dim=0).mean(dim=0)
        return (final[:self.n_users], final[self.n_users:],
                x_cl[:self.n_users], x_cl[self.n_users:])

    def propagate(self, params, consts, extras):
        u, i, _, _ = self._forward(params, consts, None, False)
        return u, i

    def calculate_loss(self, params, consts, extras, batch, rng, mode=0,
                       noise: list | None = None):
        """``noise``: the per-layer noise list, drawn from ``rng`` when
        not given."""
        user, pos, neg = (batch["user_id"], batch["item_id"],
                          batch["neg_item_id"])
        w = batch.get("weight")
        gen = None if noise is not None else device_generator(rng,
                                                              self.device)
        u_all, i_all, u_cl, i_cl = self._forward(params, consts, gen, True,
                                                 noise)
        u_e, p_e, n_e = u_all[user], i_all[pos], i_all[neg]
        mf = bpr_loss((u_e * p_e).sum(-1), (u_e * n_e).sum(-1), w)
        reg = emb_loss(
            [params["user_emb"][user], params["item_emb"][pos],
             params["item_emb"][neg]],
            batch_size=user.shape[0], require_pow=self.require_pow, weight=w)
        uu, umask = masked_unique(user)
        ii, imask = masked_unique(pos)
        cl = (cl_nce_masked(u_all[uu], u_cl[uu], self.temperature, umask,
                            "mean")
              + cl_nce_masked(i_all[ii], i_cl[ii], self.temperature, imask,
                              "mean"))
        loss = mf + self.reg_weight * reg + self.cl_rate * cl
        return loss, {"mf": mf, "reg": reg, "cl": cl}
