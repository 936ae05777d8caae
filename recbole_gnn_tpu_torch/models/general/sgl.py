"""SGL — self-supervised graph learning with stochastic augmentations.

Port of ``recbole_gnn_tpu/models/general/sgl.py``: a LightGCN backbone
and two augmented views of the graph, rebuilt every epoch in
``epoch_start``; augmentation ND (node drop), ED (edge drop) or RW
(an edge drop per layer), each view re-normalised over its kept edges;
sum-reduced BPR + EmbLoss + InfoNCE of the batch's users and positive
items against every node of view 2.  With ``activation_dtype:
bfloat16`` the propagations start from a bf16 copy of the embeddings
and keep the dtype each SpMM gives (``ops/spmm.py``), and the layer
mean is taken in f32.  A training step runs three
propagations (the graph and both views), each ``n_layers`` SpMMs
forward and as many transpose SpMMs back: 9 and 9 at 3 layers.

Augmentation never resizes the edge list.  A view is a (n_layers, E)
stack of edge weights over the graph's static edges (the dense graph:
a (n_layers, U, I) stack of re-normalised blocks).  ``edge_inter_id``
maps each edge of the dst-sorted (and padded) edge list to its
interaction, so an interaction keep-mask becomes an edge mask; padding
edges map to a sentinel interaction that is always dropped.

On an ``ell`` graph the views also carry their ELL slot weights
(``view*_ell`` / ``view*_ell_r``: per bucket a (n_layers, n_b, K_b)
stack, the JAX package's extras), gathered once per epoch.  The
layouts built from them (``EllMeta`` via ``with_ws``) are kept on the
model, keyed by the identity of the extras' tensors, so each view's
layouts — and the kernel arguments the first launch makes for each —
are made once per epoch, not per step.  ED and ND views share one
layout across their layers (every layer is the same view).  The extras
themselves stay plain tensors, so checkpoints cross-load with the JAX
package.

The keep masks come from a generator derived from the trainer's;
``epoch_start``/``init_extras`` take the JAX ones in the tests
(``keeps``: per view the list of per-repetition keep masks over the
interactions).

Counters, under the span open at a build (``fit/epoch_start`` in
``fit``): ``views`` (views built), ``edges`` (the graph's directed
edges, two per interaction, over every view and repetition) and
``kept_edges`` (those of weight > 0 after the drop, two per kept
interaction).  A keep mask's sum is read only after the next build's
seed draw, whose read of the seeds has already waited for the device,
so the count adds no wait; a build's views are counted by the build
after it.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch
import torch.nn.functional as F

from recbole_gnn_tpu_torch.models.base import (GeneralGraphRecommender,
                                               device_generator)
from recbole_gnn_tpu_torch.models.init import split_keys, xavier_uniform
from recbole_gnn_tpu_torch.models.losses import emb_loss, info_nce
from recbole_gnn_tpu_torch.ops import nce
from recbole_gnn_tpu_torch.ops.ell_spmm import reweight_ws, with_ws
from recbole_gnn_tpu_torch.ops.graphops import sym_norm_weights
from recbole_gnn_tpu_torch.ops.spmm import (BipartiteDenseGraph, spmm_any,
                                            spmm_dense_bipartite)
from recbole_gnn_tpu_torch.utils import trace

_VIEWS = ("view1", "view2")


class SGL(GeneralGraphRecommender):

    def __init__(self, config, dataset, device=None):
        super().__init__(config, dataset, device)
        self.latent_dim = int(config.get("embedding_size", 64))
        self.n_layers = int(config.get("n_layers", 3))
        self.aug_type = str(config.or_default("type", "ED"))
        self.drop_ratio = float(config.get("drop_ratio", 0.1))
        self.ssl_tau = float(config.get("ssl_tau", 0.5))
        self.reg_weight = float(config.get("reg_weight", 1e-5))
        self.ssl_weight = float(config.get("ssl_weight", 0.05))
        if self.aug_type not in ("ND", "ED", "RW"):
            raise ValueError(f"unknown SGL aug type {self.aug_type!r}")
        if self.device.type == "cuda":   # the InfoNCE kernel's rows
            nce.check_width(self.latent_dim, "SGL embedding_size")
        # activation_dtype: bfloat16 — the three propagations run on a
        # bf16 input (as the JAX package: each impl keeps the dtype its
        # SpMM gives: bf16 on ell and xla, f32 on pallas on the card and
        # on the dense form); the layer mean, losses, params and
        # optimizer stay f32
        self.act_dtype = (torch.bfloat16 if str(config.or_default(
            "activation_dtype", "")).startswith("bf") else None)
        users, items = dataset.user_item_arrays()
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device)
        self.consts["aug_users"] = t(users)
        self.consts["aug_items"] = t(items)
        self._is_dense = isinstance(self.consts["graph"], BipartiteDenseGraph)
        if not self._is_dense:
            # each dst-sorted edge's interaction row, as build_graph's
            # stable dst sort orders them; padding edges map to the
            # sentinel row n_inter, which is always dropped
            n_inter = len(users)
            dst_cat = np.concatenate([items + self.n_users, users])
            ids = (np.argsort(dst_cat, kind="stable") % n_inter).astype(
                np.int64)
            n_pad = self.consts["graph"].n_edges_padded - len(ids)
            if n_pad > 0:
                ids = np.concatenate([ids, np.full(n_pad, n_inter, np.int64)])
            self.consts["edge_inter_id"] = t(ids)
        # per view: (the extras tensors it was built from, per-layer graphs)
        self._view_graphs: dict[str, tuple] = {}
        self.layout_builds = 0
        # per view built and not yet counted: its keep masks' sums
        self._uncounted: list[torch.Tensor] = []

    # -- augmentation ----------------------------------------------------

    def _keep_mask(self, gen, n_inter, users, items):
        if self.aug_type == "ND":
            keep_u = torch.rand(self.n_users, generator=gen,
                                device=gen.device) >= self.drop_ratio
            keep_i = torch.rand(self.n_items, generator=gen,
                                device=gen.device) >= self.drop_ratio
            return keep_u[users] & keep_i[items]
        return torch.rand(n_inter, generator=gen,
                          device=gen.device) >= self.drop_ratio

    def _build_view(self, gen, consts, keeps=None):
        """One augmented view: the (n_layers, …) stack of its per-layer
        graph weights; ``keeps`` the per-repetition interaction keep
        masks (drawn from ``gen`` when not given)."""
        users, items = consts["aug_users"], consts["aug_items"]
        n_inter = users.shape[0]
        n_rep = self.n_layers if self.aug_type == "RW" else 1
        if keeps is None:
            keeps = [self._keep_mask(g, n_inter, users, items)
                     for g in split_keys(gen, n_rep)]
        keeps = [keep.to(self.device) for keep in keeps]
        self._uncounted.append(torch.stack([keep.sum() for keep in keeps]))
        outs = []
        for keep in keeps:
            if self._is_dense:
                kf = keep.to(torch.float32)
                a_bin = torch.zeros((self.n_users, self.n_items),
                                    device=self.device).index_put_(
                    (users, items), kf, accumulate=True)
                du = a_bin.sum(1)
                di = a_bin.sum(0)
                du = torch.where(du > 0, torch.rsqrt(torch.clamp(du, min=1e-12)),
                                 torch.zeros_like(du))
                di = torch.where(di > 0, torch.rsqrt(torch.clamp(di, min=1e-12)),
                                 torch.zeros_like(di))
                outs.append(a_bin * du[:, None] * di[None, :])
            else:
                g = consts["graph"]
                keep_ext = torch.cat([keep, keep.new_zeros(1)])
                mask_e = keep_ext[consts["edge_inter_id"]]
                outs.append(sym_norm_weights(g.src, g.dst, g.n_nodes,
                                             mask=mask_e))
        if n_rep == 1:
            outs = outs * self.n_layers
        return torch.stack(outs, dim=0)

    def _view_ell_ws(self, consts, stacked_w):
        """The view's per-layer ELL slot weights, forward and transpose:
        per bucket a (n_layers, n_b, K_b) stack (gathered once per
        epoch)."""
        g = consts["graph"]
        f_layers, r_layers = [], []
        for l in range(self.n_layers):
            wl = stacked_w[l][:g.n_edges]
            f_layers.append(reweight_ws(g.ell, wl))
            r_layers.append(reweight_ws(g.rev_ell, wl))
        f = tuple(torch.stack([f_layers[l][b] for l in range(self.n_layers)])
                  for b in range(len(f_layers[0])))
        r = tuple(torch.stack([r_layers[l][b] for l in range(self.n_layers)])
                  for b in range(len(r_layers[0])))
        return f, r

    def _count_views(self, n_inter: int) -> None:
        """The counters of the views built and not yet counted."""
        if not self._uncounted:
            return
        kept = [k for v in self._uncounted for k in v.tolist()]
        trace.count("views", len(self._uncounted))
        trace.count("edges", 2 * n_inter * len(kept))
        trace.count("kept_edges", 2 * sum(kept))
        self._uncounted = []

    def _make_extras(self, gen, consts, keeps=None):
        gens = (split_keys(gen, 2) if keeps is None else (None, None))
        self._count_views(consts["aug_users"].shape[0])
        out = {}
        for i, name in enumerate(_VIEWS):
            out[name] = self._build_view(gens[i], consts,
                                         None if keeps is None else keeps[i])
        if not self._is_dense and consts["graph"].ell is not None:
            for name in _VIEWS:
                out[f"{name}_ell"], out[f"{name}_ell_r"] = self._view_ell_ws(
                    consts, out[name])
        return out

    def init_extras(self, gen, keeps=None):
        with torch.no_grad():
            return self._make_extras(
                None if keeps is not None else device_generator(
                    gen, self.device), self.consts, keeps)

    def epoch_start(self, epoch, params, consts, extras, rng, keeps=None):
        # views rebuilt every epoch (reference train() override :73-80)
        with torch.no_grad():
            return self._make_extras(
                None if keeps is not None else device_generator(
                    rng, self.device), consts, keeps)

    # -- forward ---------------------------------------------------------

    def _propagate_layers(self, params, layer_graphs):
        x = torch.cat([params["user_emb"], params["item_emb"]], dim=0)
        if self.act_dtype is not None:
            x = x.to(self.act_dtype)
        outs = [x]
        for g in layer_graphs:
            x = g(x)
            outs.append(x)
        # each layer widened to f32 before the mean
        final = torch.stack([o.float() for o in outs], dim=0).mean(dim=0)
        return final[:self.n_users], final[self.n_users:]

    def _forward_base(self, params, consts):
        g = consts["graph"]
        return self._propagate_layers(
            params, [lambda x: spmm_any(g, x)] * self.n_layers)

    def _ell_view_graphs(self, consts, extras, name):
        """The view's per-layer graphs on its ELL layouts, made once per
        extras (cached on the model by the tensors' identity)."""
        tensors = (extras[name], *extras[f"{name}_ell"],
                   *extras[f"{name}_ell_r"])
        hit = self._view_graphs.get(name)
        if hit is not None and len(hit[0]) == len(tensors) and all(
                a is b for a, b in zip(hit[0], tensors)):
            return hit[1]
        g = consts["graph"]
        ws, ws_r = extras[f"{name}_ell"], extras[f"{name}_ell_r"]

        def layer_graph(l):
            return replace(
                g, weight=extras[name][l], rev_weight=None,
                ell=with_ws(g.ell, tuple(b[l] for b in ws)),
                rev_ell=with_ws(g.rev_ell, tuple(b[l] for b in ws_r)))

        if self.aug_type == "RW":
            graphs = [layer_graph(l) for l in range(self.n_layers)]
        else:   # every layer is the same view: one layout serves all
            graphs = [layer_graph(0)] * self.n_layers
        self.layout_builds += 1
        self._view_graphs[name] = (tensors, graphs)
        return graphs

    def _forward_view(self, params, consts, extras, name):
        vw = extras[name]
        if self._is_dense:
            layers = [
                (lambda x, a=vw[l]: spmm_dense_bipartite(
                    BipartiteDenseGraph(a, self.n_users, self.n_items, 0), x))
                for l in range(self.n_layers)]
        elif consts["graph"].ell is not None and f"{name}_ell" in extras:
            layers = [(lambda x, g=g: spmm_any(g, x))
                      for g in self._ell_view_graphs(consts, extras, name)]
        else:
            g = consts["graph"]
            layers = [(lambda x, gl=g.with_weight(vw[l]): spmm_any(gl, x))
                      for l in range(self.n_layers)]
        return self._propagate_layers(params, layers)

    def init_params(self, gen):
        ku, ki = split_keys(gen, 2)
        return {
            "user_emb": xavier_uniform(ku, (self.n_users, self.latent_dim),
                                       device=self.device),
            "item_emb": xavier_uniform(ki, (self.n_items, self.latent_dim),
                                       device=self.device),
        }

    def propagate(self, params, consts, extras):
        return self._forward_base(params, consts)

    def calculate_loss(self, params, consts, extras, batch, rng, mode=0):
        user, pos, neg = (batch["user_id"], batch["item_id"],
                          batch["neg_item_id"])
        w = batch.get("weight")
        u_all, i_all = self._forward_base(params, consts)
        u1, i1 = self._forward_view(params, consts, extras, "view1")
        u2, i2 = self._forward_view(params, consts, extras, "view2")

        u_e, p_e, n_e = u_all[user], i_all[pos], i_all[neg]
        l1 = -F.logsigmoid((u_e * p_e).sum(-1) - (u_e * n_e).sum(-1))
        if w is not None:
            l1 = l1 * w
        bpr = l1.sum()    # sum-reduced (reference :162)
        reg = emb_loss([params["user_emb"][user], params["item_emb"][pos],
                        params["item_emb"][neg]], user.shape[0], weight=w)
        ssl = (info_nce(u1[user], u2[user], self.ssl_tau, weight=w,
                        all_view2=u2, reduction="sum")
               + info_nce(i1[pos], i2[pos], self.ssl_tau, weight=w,
                          all_view2=i2, reduction="sum"))
        loss = bpr + reg * self.reg_weight + ssl * self.ssl_weight
        return loss, {"bpr": bpr, "reg": reg, "ssl": ssl}
