"""NCL — neighborhood-enriched contrastive learning.

Port of ``recbole_gnn_tpu/models/general/ncl.py``: a LightGCN backbone
propagating max(n_layers, 2·hyper_layers) layers and keeping them all;
the structure-contrastive loss between layer 2·hyper_layers and layer 0
(InfoNCE against every node); the prototype-contrastive ProtoNCE
against k-means centroids of the embeddings (``ops/kmeans.py``), the
E-step run in ``epoch_start`` every ``m_step`` epochs and ProtoNCE
left out in ``loss_mode`` 0, the first ``warm_up_step`` epochs.  At 3
layers a training step runs 3 SpMMs forward and 3 transpose SpMMs
back.

The k-means starting rows come from a generator derived from the
trainer's; ``epoch_start`` takes the JAX ones in the tests
(``init_idx``: the user and the item starting indices).
"""

from __future__ import annotations

import torch

from recbole_gnn_tpu_torch.models.base import device_generator
from recbole_gnn_tpu_torch.models.general.lightgcn import LightGCN
from recbole_gnn_tpu_torch.models.init import l2_normalize, split_keys
from recbole_gnn_tpu_torch.models.losses import bpr_loss, emb_loss, info_nce
from recbole_gnn_tpu_torch.ops import nce
from recbole_gnn_tpu_torch.ops.kmeans import kmeans
from recbole_gnn_tpu_torch.ops.spmm import spmm_any


class NCL(LightGCN):

    def __init__(self, config, dataset, device=None):
        super().__init__(config, dataset, device)
        self.reg_weight = float(config.get("reg_weight", 1e-4))
        self.ssl_temp = float(config.get("ssl_temp", 0.1))
        self.ssl_reg = float(config.get("ssl_reg", 1e-7))
        self.hyper_layers = int(config.get("hyper_layers", 1))
        self.alpha = float(config.get("alpha", 1.0))
        self.proto_reg = float(config.get("proto_reg", 8e-8))
        self.k = int(config.get("num_clusters", 1000))
        self.m_step = int(config.get("m_step", 1))
        self.warm_up_step = int(config.get("warm_up_step", 20))
        if self.device.type == "cuda":   # the InfoNCE kernel's rows
            nce.check_width(self.latent_dim, "NCL embedding_size")

    # -- prototype E-step -------------------------------------------------

    def init_extras(self, gen):
        d, dev = self.latent_dim, self.device
        return {
            "user_centroids": torch.zeros((self.k, d), device=dev),
            "user_2cluster": torch.zeros((self.n_users,), dtype=torch.int32,
                                         device=dev),
            "item_centroids": torch.zeros((self.k, d), device=dev),
            "item_2cluster": torch.zeros((self.n_items,), dtype=torch.int32,
                                         device=dev),
        }

    def epoch_start(self, epoch, params, consts, extras, rng,
                    init_idx: tuple | None = None):
        if epoch % self.m_step != 0:
            return extras
        gens = (split_keys(device_generator(rng, self.device), 2)
                if init_idx is None else (None, None))
        idx = init_idx or (None, None)
        out = {}
        with torch.no_grad():
            for side, g, i in zip(("user", "item"), gens, idx):
                c, a = kmeans(g, params[f"{side}_emb"].detach(), self.k,
                              init_idx=i)
                out[f"{side}_centroids"] = l2_normalize(c)
                out[f"{side}_2cluster"] = a.to(torch.int32)
        return out

    def loss_mode(self, epoch):
        # mode 0 = warm-up: ProtoNCE left out (reference trainer.py:129)
        return 0 if epoch < self.warm_up_step else 1

    # -- forward ----------------------------------------------------------

    def _forward_list(self, params, consts):
        x = torch.cat([params["user_emb"], params["item_emb"]], dim=0)
        layers = [x]
        for _ in range(max(self.n_layers, self.hyper_layers * 2)):
            x = spmm_any(consts["graph"], x)
            layers.append(x)
        final = torch.stack(layers[:self.n_layers + 1], dim=0).mean(dim=0)
        return final[:self.n_users], final[self.n_users:], layers

    def propagate(self, params, consts, extras):
        u, i, _ = self._forward_list(params, consts)
        return u, i

    # -- losses -----------------------------------------------------------

    def _ssl_layer_loss(self, current, previous, user, item, w):
        cu, ci = current[:self.n_users], current[self.n_users:]
        pu, pi = previous[:self.n_users], previous[self.n_users:]
        u_loss = info_nce(cu[user], pu[user], self.ssl_temp, weight=w,
                          all_view2=pu, reduction="sum")
        i_loss = info_nce(ci[item], pi[item], self.ssl_temp, weight=w,
                          all_view2=pi, reduction="sum")
        return self.ssl_reg * (u_loss + self.alpha * i_loss)

    def _proto_nce(self, center, extras, user, item, w):
        cu, ci = center[:self.n_users], center[self.n_users:]
        uc, ic = extras["user_centroids"], extras["item_centroids"]
        u_loss = info_nce(cu[user], uc[extras["user_2cluster"][user].long()],
                          self.ssl_temp, weight=w, all_view2=uc,
                          reduction="sum")
        i_loss = info_nce(ci[item], ic[extras["item_2cluster"][item].long()],
                          self.ssl_temp, weight=w, all_view2=ic,
                          reduction="sum")
        return self.proto_reg * (u_loss + i_loss)

    def calculate_loss(self, params, consts, extras, batch, rng, mode=0):
        user, pos, neg = (batch["user_id"], batch["item_id"],
                          batch["neg_item_id"])
        w = batch.get("weight")
        u_all, i_all, layers = self._forward_list(params, consts)
        center = layers[0]
        context = layers[self.hyper_layers * 2]
        ssl = self._ssl_layer_loss(context, center, user, pos, w)

        u_e, p_e, n_e = u_all[user], i_all[pos], i_all[neg]
        mf = bpr_loss((u_e * p_e).sum(-1), (u_e * n_e).sum(-1), w)
        reg = emb_loss([params["user_emb"][user], params["item_emb"][pos],
                        params["item_emb"][neg]], user.shape[0], weight=w)
        loss = mf + self.reg_weight * reg + ssl
        aux = {"mf": mf, "reg": reg, "ssl": ssl}
        if mode == 1:
            proto = self._proto_nce(center, extras, user, pos, w)
            loss = loss + proto
            aux["proto"] = proto
        return loss, aux
