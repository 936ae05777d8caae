"""SGNN-HN — star graph neural network with highway blending.

Port of ``recbole_gnn_tpu/models/sequential/sgnnhn.py`` (reference
sgnnhn.py): a virtual star node initialised as the mean of the session
nodes; per step an SRGNN cell, the star-gated blend σ(h·s/√d) and the
attentive star update (:79-116); positional embeddings; the custom
layer_norm (:29-34) and scale-scaled normalised logits.

PAD-slot parity: the reference's per-session node set holds ONE pad
node whenever the session is shorter than the maximum length
(torch.unique over the padded row, dataset.py:122-124), and that node
takes part in the star pooling and softmax as an isolated node; the
star mask here includes exactly slot n_nodes (which holds PAD) when
padding exists.
"""

from __future__ import annotations

import math

import torch

from recbole_gnn_tpu_torch.models.base import SequentialRecommender
from recbole_gnn_tpu_torch.models.init import (linear, linear_params,
                                               split_keys, uniform_pm)
from recbole_gnn_tpu_torch.models.layers import srgnn_cell_params
from recbole_gnn_tpu_torch.models.losses import bpr_loss, cross_entropy
from recbole_gnn_tpu_torch.models.sequential.common import (
    embed, gather_seq_hidden, last_hidden, node_embeddings, seq_mask,
    session_dense_adj, srgnn_cell_dense)


def star_blend_step(hidden, star, smask, d):
    """One star-graph blend + attentive star update (reference
    sgnnhn.py:79-100): α = σ(h·s/√d) blends node states toward the
    star; the star is refreshed by masked softmax attention over the
    blended nodes."""
    sim = (hidden * star[:, None, :]).sum(-1, keepdim=True) / math.sqrt(d)
    alpha = torch.sigmoid(sim)
    hidden = (1.0 - alpha) * hidden + alpha * star[:, None, :]
    sim2 = (hidden * star[:, None, :]).sum(-1)
    sim2 = torch.where(smask > 0, sim2, -1e30)
    att = torch.softmax(sim2, dim=1)
    star = (att[:, :, None] * hidden).sum(1)
    return hidden, star


def sgnnhn_layer_norm(x):
    """The reference's custom layer_norm (:29-34): centre, then
    L2-normalise."""
    x = x - x.mean(-1, keepdim=True)
    norm = torch.sqrt((x * x).sum(-1, keepdim=True).clamp_min(1e-24))
    return x / norm.clamp_min(1e-12)


class SGNNHN(SequentialRecommender):

    def __init__(self, config, dataset, device=None):
        super().__init__(config, dataset, device)
        self.embedding_size = int(config.get("embedding_size", 64))
        self.step = int(config.get("step", 6))
        self.scale = float(config.get("scale", 12.0))
        self.loss_type = str(config.or_default("loss_type", "CE"))

    def init_params(self, gen):
        d, dev = self.embedding_size, self.device
        stdv = 1.0 / math.sqrt(d)
        ks = split_keys(gen, 8)
        return {
            "item_emb": uniform_pm(ks[0], (self.n_items, d), stdv,
                                   device=dev),
            "pos_emb": uniform_pm(ks[1], (self.max_seq_len, d), stdv,
                                  device=dev),
            "cell": srgnn_cell_params(ks[2], d, device=dev),
            "linear_one": linear_params(ks[3], d, d, stdv=stdv, device=dev),
            "linear_two": linear_params(ks[4], d, d, stdv=stdv, device=dev),
            "linear_three": linear_params(ks[5], d, d, stdv=stdv,
                                          device=dev),
            "linear_four": linear_params(ks[6], d, 1, bias=False, stdv=stdv,
                                         device=dev),
            "linear_transform": linear_params(ks[7], 2 * d, d, stdv=stdv,
                                              device=dev),
        }

    @staticmethod
    def _star_mask(batch):
        """(B, L) node mask including one PAD slot when padding exists."""
        L = batch["x"].shape[1]
        n = batch["n_nodes"]
        extra = (n < L).to(n.dtype)
        pos = torch.arange(L, device=n.device)
        return pos[None, :] < (n + extra)[:, None]

    def seq_output(self, params, batch):
        d = self.embedding_size
        hidden = node_embeddings(params["item_emb"], batch)
        a_in, a_out = session_dense_adj(batch)
        smask = self._star_mask(batch).to(torch.float32)
        cnt = smask.sum(1, keepdim=True).clamp_min(1.0)
        star = (hidden * smask[:, :, None]).sum(1) / cnt          # (B, D)

        for _ in range(self.step):
            hidden = srgnn_cell_dense(params["cell"], hidden, a_in, a_out)
            hidden, star = star_blend_step(hidden, star, smask, d)

        seq_hidden = gather_seq_hidden(hidden, batch)
        L = seq_hidden.shape[1]
        seq_hidden = seq_hidden + params["pos_emb"][None, :L, :]
        mask = seq_mask(batch)[:, :, None].to(seq_hidden.dtype)
        ht = last_hidden(seq_hidden, batch["item_seq_len"])
        q1 = linear(params["linear_one"], ht)[:, None, :]
        q2 = linear(params["linear_two"], seq_hidden)
        q3 = linear(params["linear_three"], star)[:, None, :]
        alpha = linear(params["linear_four"], torch.sigmoid(q1 + q2 + q3))
        a = (alpha * seq_hidden * mask).sum(1)
        out = linear(params["linear_transform"], torch.cat([a, ht], dim=-1))
        return sgnnhn_layer_norm(out)

    def full_scores(self, params, consts, extras, batch, rng, train):
        out = self.seq_output(params, batch)
        return self.scale * (out @ sgnnhn_layer_norm(params["item_emb"]).T)

    def calculate_loss(self, params, consts, extras, batch, rng, mode=0):
        w = batch.get("weight")
        if self.loss_type == "BPR":
            out = self.seq_output(params, batch)
            pos_e = sgnnhn_layer_norm(embed(params["item_emb"], batch["item_id"]))
            neg_e = sgnnhn_layer_norm(
                embed(params["item_emb"], batch["neg_item_id"]))
            loss = bpr_loss(self.scale * (out * pos_e).sum(-1),
                            self.scale * (out * neg_e).sum(-1), w)
        else:
            logits = self.full_scores(params, consts, extras, batch, rng,
                                      True)
            loss = cross_entropy(logits, batch["item_id"], w)
        return loss, {"loss": loss}
