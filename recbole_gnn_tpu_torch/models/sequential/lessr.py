"""LESSR — edge-order-preserving aggregation + shortcut attention.

Port of ``recbole_gnn_tpu/models/sequential/lessr.py`` (reference
lessr.py): alternating EOPA (a GRU over each node's time-ordered
in-edge mailbox, :24-60) and SGAT (shortcut-graph attention, :63-97)
layers whose outputs are concatenated onto their inputs, the attention
readout (:100-137), max-norm-1 item embeddings; CE only.

EOPA runs K GRU steps over the dataset's mailbox (``eop_mail``
(B, L, K), K the largest in-degree, ``eop_mail_cnt`` the per-node
counts): step k advances every node whose k-th in-edge exists.  The
JAX package unrolls K ≤ 8 and scans above; both compute this loop.

BatchNorm is masked: biased statistics over the valid nodes (the
single PAD node of a short session included), leaving out the rows of
weight 0; ``bn_sr`` takes its statistics over the w > 0 rows.  Under
data parallelism the statistics are the global batch's, as the JAX
package's one program over the mesh takes them: the counts and sums
go through ``parallel.comm.batch_sum`` inside autograd.  No
running statistics: ``serving_calibrate`` freezes population
statistics from a sample batch, which eval-mode scores then use.

The max-norm-1 renorm is applied on use, as a differentiable rescaled
copy of the table; the table itself is never rewritten (unlike
``F.embedding(max_norm=)``).

The dropout masks come from a generator derived from the trainer's;
``keeps`` takes the JAX ones in the tests: per layer the (B, L, d_in)
mask after its BatchNorm, then the readout's (B, L, d_out), then the
session representation's (B, d_out + d).
"""

from __future__ import annotations

import math

import torch

from recbole_gnn_tpu_torch.models.base import (SequentialRecommender,
                                               device_generator)
from recbole_gnn_tpu_torch.models.init import (linear, linear_params,
                                               normal_init, split_keys)
from recbole_gnn_tpu_torch.models.layers import (KeepStream, gru_params,
                                                 gru_step)
from recbole_gnn_tpu_torch.models.losses import cross_entropy
from recbole_gnn_tpu_torch.models.sequential.common import (
    edge_masks, embed, gather_slots)
from recbole_gnn_tpu_torch.parallel.comm import batch_reducing, batch_sum


def _prelu(alpha, x):
    return torch.where(x >= 0, x, alpha * x)


def _masked_stats(x, mask):
    """Masked per-feature (mu, biased var) over the valid nodes of a
    (B, L, D) x, over the global batch when it is spread over ranks."""
    m = mask[:, :, None].to(x.dtype)
    cnt = batch_sum(m.sum()).clamp_min(1.0)
    mu = batch_sum((x * m).sum((0, 1))) / cnt
    var = batch_sum((((x - mu) ** 2) * m).sum((0, 1))) / cnt
    return mu, var


def _masked_bn(p, x, mask, stats):
    mu, var = stats
    m = mask[:, :, None].to(x.dtype)
    return ((x - mu) * torch.rsqrt(var + 1e-5) * p["g"] + p["b"]) * m


def _bn_params(d, device):
    return {"g": torch.ones(d, device=device),
            "b": torch.zeros(d, device=device)}


def max_norm_rows(emb: torch.Tensor) -> torch.Tensor:
    """Each row scaled to norm ≤ 1 (torch Embedding's max_norm = 1), as
    a differentiable copy."""
    norms = torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
    return emb * torch.clamp(1.0 / norms.clamp_min(1e-12), max=1.0)


class _BNSites:
    """The BatchNorm sites of one forward, in order: batch statistics
    (training), frozen ones (``stats``), or batch statistics recorded
    into ``collect`` (calibration)."""

    def __init__(self, stats=None, collect=None):
        self.stats, self.collect, self.i = stats, collect, 0

    def take(self, batch_stats):
        i = self.i
        self.i += 1
        if self.collect is not None:
            s = batch_stats()
            self.collect.append(s)
            return s
        return self.stats[i] if self.stats is not None else batch_stats()


class LESSR(SequentialRecommender):

    def __init__(self, config, dataset, device=None):
        super().__init__(config, dataset, device)
        self.embedding_size = int(config.get("embedding_size", 64))
        self.num_layers = int(config.get("n_layers", 4))
        self.batch_norm = config["batch_norm"] is not False
        self.feat_drop = float(config.get("feat_drop", 0.2))
        self.loss_type = str(config.or_default("loss_type", "CE"))
        if self.loss_type != "CE":
            raise NotImplementedError("LESSR supports CE only")

    def init_params(self, gen):
        d, dev = self.embedding_size, self.device
        ks = split_keys(gen, 3 + self.num_layers)
        params = {"item_emb": normal_init(ks[0], (self.n_items, d),
                                          1.0 / math.sqrt(d), device=dev),
                  "layers": []}
        input_dim = d
        for i in range(self.num_layers):
            if i % 2 == 0:  # EOPA
                lk = split_keys(ks[1 + i], 3)
                lp = {
                    "gru": gru_params(lk[0], input_dim, input_dim,
                                      device=dev),
                    "fc_self": linear_params(lk[1], input_dim, d, bias=False,
                                             device=dev),
                    "fc_neigh": linear_params(lk[2], input_dim, d,
                                              bias=False, device=dev),
                    "prelu": torch.full((d,), 0.25, device=dev),
                }
            else:  # SGAT
                lk = split_keys(ks[1 + i], 4)
                lp = {
                    "fc_q": linear_params(lk[0], input_dim, d, device=dev),
                    "fc_k": linear_params(lk[1], input_dim, d, bias=False,
                                          device=dev),
                    "fc_v": linear_params(lk[2], input_dim, d, bias=False,
                                          device=dev),
                    "fc_e": linear_params(lk[3], d, 1, bias=False,
                                          device=dev),
                    "prelu": torch.full((d,), 0.25, device=dev),
                }
            if self.batch_norm:
                lp["bn"] = _bn_params(input_dim, dev)
            params["layers"].append(lp)
            input_dim += d
        kr = split_keys(ks[-2], 4)
        params["readout"] = {
            "fc_u": linear_params(kr[0], input_dim, d, bias=False, device=dev),
            "fc_v": linear_params(kr[1], input_dim, d, device=dev),
            "fc_e": linear_params(kr[2], d, 1, bias=False, device=dev),
            "fc_out": linear_params(kr[3], input_dim, d, bias=False,
                                    device=dev),
            "prelu": torch.full((d,), 0.25, device=dev),
        }
        if self.batch_norm:
            params["readout"]["bn"] = _bn_params(input_dim, dev)
            params["bn_sr"] = _bn_params(input_dim + d, dev)
        params["fc_sr"] = linear_params(ks[-1], input_dim + d, d, bias=False,
                                        device=dev)
        return params

    def _norm(self, p, feat, nmask, sites):
        """The layer's masked BatchNorm."""
        if not self.batch_norm:
            return feat
        return _masked_bn(p["bn"], feat, nmask,
                          sites.take(lambda: _masked_stats(feat, nmask)))

    def _drop(self, feat, stream):
        if stream is None or self.feat_drop <= 0:
            return feat
        return stream.dropout(feat, self.feat_drop)

    def _eopa(self, lp, feat, batch, nmask, sites, stream):
        """GRU over each node's time-ordered in-edge messages: K steps,
        every node advanced one mailbox slot per step (the messages
        depend on the input features only, so the chains are
        independent).  The messages come from the dropped features, the
        self term from the undropped ones."""
        feat = self._norm(lp, feat, nmask, sites)
        dropped = self._drop(feat, stream)
        mail, cnt = batch["eop_mail"], batch["eop_mail_cnt"]
        neigh = torch.zeros_like(feat)
        for k in range(mail.shape[2]):
            msg = gather_slots(dropped, mail[:, :, k])
            new = gru_step(lp["gru"], neigh, msg)
            neigh = torch.where((k < cnt)[:, :, None], new, neigh)
        out = linear(lp["fc_self"], feat) + linear(lp["fc_neigh"], neigh)
        return _prelu(lp["prelu"], out)

    def _sgat(self, lp, feat, batch, nmask, sites, stream):
        """Shortcut-graph attention: e = fc_e(σ(q_src + k_dst)) over the
        dense (B, dst, src) shortcut adjacency, softmax over the
        sources."""
        B, L, _ = feat.shape
        feat = self._drop(self._norm(lp, feat, nmask, sites), stream)
        q = linear(lp["fc_q"], feat)
        k = linear(lp["fc_k"], feat)
        v = linear(lp["fc_v"], feat)
        adj = edge_masks(batch["cut_src"], batch["cut_dst"], batch["n_cut"],
                         L)[..., 0] > 0
        e = linear(lp["fc_e"], torch.sigmoid(
            q[:, None, :, :] + k[:, :, None, :]))[..., 0]   # (B, dst, src)
        e = torch.where(adj, e, -1e30)
        alpha = torch.softmax(e, dim=-1) * adj
        return _prelu(lp["prelu"], torch.bmm(alpha, v))

    def _readout(self, rp, feat, last_slot, nmask, sites, stream):
        feat = self._drop(self._norm(rp, feat, nmask, sites), stream)
        fu = linear(rp["fc_u"], feat)
        last_feat = gather_slots(feat, last_slot[:, None])[:, 0]
        fv = linear(rp["fc_v"], last_feat)[:, None, :]
        e = linear(rp["fc_e"], torch.sigmoid(fu + fv))[..., 0]
        e = torch.where(nmask, e, -1e30)
        alpha = torch.softmax(e, dim=1)[:, :, None]
        rst = (feat * alpha * nmask[:, :, None]).sum(1)
        return _prelu(rp["prelu"], linear(rp["fc_out"], rst))

    def seq_output(self, params, batch, rng, train, bn_stats=None,
                   bn_collect=None, keeps=None):
        """``bn_stats``: frozen per-site (mu, var) list (see
        ``serving_calibrate``); ``bn_collect``: a list each site's batch
        statistics are appended to.  Default: batch statistics, the
        training-time semantics."""
        sites = _BNSites(bn_stats, bn_collect)
        stream = (KeepStream.of(keeps,
                                lambda: device_generator(rng, self.device))
                  if train else None)
        L = batch["x"].shape[1]
        n = batch["n_nodes"]
        # the node mask includes the reference's single PAD node per
        # short session
        pos = torch.arange(L, device=n.device)
        nmask = pos[None, :] < (n + (n < L).to(n.dtype))[:, None]
        # weight-0 padding rows stay out of the batch statistics
        w = batch.get("weight")
        if w is not None:
            nmask = nmask & (w > 0)[:, None]
        feat = embed(max_norm_rows(params["item_emb"]), batch["x"])

        for i, lp in enumerate(params["layers"]):
            layer = self._eopa if i % 2 == 0 else self._sgat
            out = layer(lp, feat, batch, nmask, sites, stream)
            feat = torch.cat([out, feat], dim=-1)

        last_alias = gather_slots(
            batch["alias_inputs"][:, :, None],
            (batch["item_seq_len"] - 1).clamp_min(0)[:, None])[:, 0, 0]
        sr_g = self._readout(params["readout"], feat, last_alias, nmask,
                             sites, stream)
        # sr_l takes the raw concatenated features (reference lessr.py:219)
        sr_l = gather_slots(feat, last_alias[:, None])[:, 0]
        sr = torch.cat([sr_l, sr_g], dim=-1)
        if self.batch_norm:
            def row_stats():
                if w is None and not batch_reducing():
                    return sr.mean(0), sr.var(0, correction=0)
                ww = (sr.new_ones(sr.shape[0]) if w is None
                      else (w > 0).to(sr.dtype))[:, None]
                cnt = batch_sum(ww.sum()).clamp_min(1.0)
                mu_ = batch_sum((sr * ww).sum(0)) / cnt
                return mu_, batch_sum((((sr - mu_) ** 2) * ww).sum(0)) / cnt

            mu, var = sites.take(row_stats)
            sr = ((sr - mu) * torch.rsqrt(var + 1e-5) * params["bn_sr"]["g"]
                  + params["bn_sr"]["b"])
        return linear(params["fc_sr"], self._drop(sr, stream))

    def serving_calibrate(self, params, consts, extras, batch):
        """Freeze population BatchNorm statistics from a sample batch of
        training sessions (the analogue of the reference's running
        eval statistics): with ``"lessr_bn"`` in the extras, eval-mode
        scores do not depend on the batch (serving at B = 1, where the
        batch variance is 0, needs this)."""
        collect = []
        with torch.no_grad():
            self.seq_output(params, batch, None, False, bn_collect=collect)
        return {**(extras or {}), "lessr_bn": collect}

    def full_scores(self, params, consts, extras, batch, rng, train,
                    keeps=None):
        bn_stats = None
        if not train and isinstance(extras, dict):
            bn_stats = extras.get("lessr_bn")
        out = self.seq_output(params, batch, rng, train, bn_stats=bn_stats,
                              keeps=keeps)
        return out @ max_norm_rows(params["item_emb"]).T

    def calculate_loss(self, params, consts, extras, batch, rng, mode=0,
                       keeps=None):
        logits = self.full_scores(params, consts, extras, batch, rng, True,
                                  keeps)
        loss = cross_entropy(logits, batch["item_id"], batch.get("weight"))
        return loss, {"ce": loss}
