"""HMLET — a gated mix of linear and non-linear propagation.

Port of ``recbole_gnn_tpu/models/general/hmlet.py``: at each layer in
``gate_layer_ids`` a per-node Gumbel-softmax gate chooses between the
linear LightGCN step and an activated step from the last non-linear
embedding; the gating MLP has BatchNorm + dropout between its layers;
at evaluation the choice is hard (straight-through one-hot); BPR +
EmbLoss.  At 4 layers with gates at 2 and 3 a training step runs 6
SpMMs forward (one per layer, one more per gated layer) and 6
transpose SpMMs back.

BatchNorm normalises over the full node set, which is the "batch" of
every forward, so the batch statistics are the population statistics
and no running statistics are kept.  The reference trainer freezes the
gates and holds the temperature during the warm-up
(``warm_up_epochs``); here that is ``loss_mode`` 0, where the gates
enter the forward detached, so their gradients are zero and Adam's
state for them decays as the JAX package's does, and ``epoch_start``
decays the temperature (``extras["gum_temp"]``) after it.

Draws (dropout masks, Gumbel uniforms) come from a generator derived
from the trainer's, and at evaluation from a fixed-seed generator on
the model's device; ``draws`` takes the JAX ones in the tests: per
gate ``{"drop": [a mask per BatchNorm layer], "u": (N, 2)}``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from recbole_gnn_tpu_torch.models.base import device_generator
from recbole_gnn_tpu_torch.models.general.lightgcn import LightGCN
from recbole_gnn_tpu_torch.models.layers import apply_dropout, dropout_keep
from recbole_gnn_tpu_torch.models.init import linear, linear_params, split_keys
from recbole_gnn_tpu_torch.models.losses import bpr_loss, emb_loss
from recbole_gnn_tpu_torch.ops.spmm import spmm_any
from recbole_gnn_tpu_torch.train.optim import tree_map

# the evaluation's Gumbel draws: a fixed generator, as the JAX package
# evaluates with a fixed key
EVAL_SEED = 0


class HMLET(LightGCN):

    def __init__(self, config, dataset, device=None):
        super().__init__(config, dataset, device)
        self.gate_layer_ids = list(config.or_default("gate_layer_ids",
                                                     [2, 3]))
        self.gating_mlp_dims = list(config.or_default("gating_mlp_dims",
                                                      [64, 16, 2]))
        self.dropout_ratio = float(config.get("dropout_ratio", 0.2))
        self.activation = str(config.or_default("activation_function", "elu"))
        self.warm_up_epochs = int(config.get("warm_up_epochs", 50))
        self.ori_temp = float(config.get("ori_temp", 0.7))
        self.min_temp = float(config.get("min_temp", 0.01))
        self.gum_temp_decay = float(config.get("gum_temp_decay", 0.005))

    def _act(self, x):
        if self.activation == "elu":
            return F.elu(x)
        return getattr(F, self.activation, F.relu)(x)

    def init_params(self, gen):
        kb, kg = split_keys(gen, 2)
        base = super().init_params(kb)
        dims = [2 * self.latent_dim] + self.gating_mlp_dims
        gates = []
        for k in split_keys(kg, len(self.gate_layer_ids)):
            layers = []
            for i, (lk, a, b) in enumerate(zip(split_keys(k, len(dims) - 1),
                                               dims[:-1], dims[1:])):
                lp = {"lin": linear_params(lk, a, b, device=self.device)}
                if i != len(dims) - 2:
                    lp["bn"] = {"g": torch.ones((b,), device=self.device),
                                "b": torch.zeros((b,), device=self.device)}
                layers.append(lp)
            gates.append(layers)
        base["gates"] = gates
        return base

    def init_extras(self, gen):
        return {"gum_temp": torch.tensor(self.ori_temp, dtype=torch.float32,
                                         device=self.device)}

    def epoch_start(self, epoch, params, consts, extras, rng):
        if epoch > self.warm_up_epochs:
            t = self.ori_temp * math.exp(
                -self.gum_temp_decay * (epoch - self.warm_up_epochs))
            extras = dict(extras, gum_temp=torch.tensor(
                max(t, self.min_temp), dtype=torch.float32,
                device=self.device))
        return extras

    def loss_mode(self, epoch):
        # mode 0: warm-up, the gating nets frozen (reference
        # trainer.py:163-165)
        return 0 if epoch <= self.warm_up_epochs else 1

    def _gating(self, gate_params, feat, temp, gen, train: bool, draws=None):
        x = feat
        n_bn = 0
        for lp in gate_params:
            x = linear(lp["lin"], x)
            if "bn" in lp:
                mu = x.mean(0, keepdim=True)
                var = ((x - mu) ** 2).mean(0, keepdim=True)
                x = (x - mu) * torch.rsqrt(var + 1e-5) * lp["bn"]["g"] \
                    + lp["bn"]["b"]
                if train and self.dropout_ratio > 0:
                    keep = (draws["drop"][n_bn] if draws is not None else
                            dropout_keep(gen, x.shape, self.dropout_ratio))
                    x = apply_dropout(x, keep, self.dropout_ratio)
                n_bn += 1
                x = F.relu(x)
        logits = x   # (N, 2)
        u = (draws["u"] if draws is not None else
             torch.rand(logits.shape, generator=gen, device=gen.device))
        gumbel = -torch.log(-torch.log(u + 1e-20) + 1e-20)
        y = torch.softmax((logits + gumbel) / temp, dim=-1)
        if not train:
            hard = (y == y.max(-1, keepdim=True).values).to(y.dtype)
            y = (hard - y).detach() + y
        return y     # (N, 2) choice weights

    def _forward(self, params, consts, extras, gen, train: bool,
                 freeze_gates: bool, draws=None):
        graph = consts["graph"]
        gates = params["gates"]
        if freeze_gates:
            gates = tree_map(torch.Tensor.detach, gates)
        temp = extras["gum_temp"]
        x = torch.cat([params["user_emb"], params["item_emb"]], dim=0)
        embeddings = [x]
        non_lin = [x]
        for layer_idx in range(self.n_layers):
            lin_emb = spmm_any(graph, x)
            if layer_idx not in self.gate_layer_ids:
                x = lin_emb
            else:
                gid = self.gate_layer_ids.index(layer_idx)
                nl_emb = self._act(spmm_any(graph, non_lin[gid]))
                gate = self._gating(
                    gates[gid], torch.cat([lin_emb, nl_emb], dim=-1), temp,
                    gen, train, None if draws is None else draws[gid])
                x = gate[:, 0:1] * lin_emb + gate[:, 1:2] * nl_emb
                non_lin.append(x)
            embeddings.append(x)
        final = torch.stack(embeddings, dim=0).mean(dim=0)
        return final[:self.n_users], final[self.n_users:]

    def propagate(self, params, consts, extras, draws=None):
        gen = (None if draws is not None else
               torch.Generator(device=self.device).manual_seed(EVAL_SEED))
        return self._forward(params, consts, extras, gen, False, False, draws)

    def calculate_loss(self, params, consts, extras, batch, rng, mode=0,
                       draws: list | None = None):
        user, pos, neg = (batch["user_id"], batch["item_id"],
                          batch["neg_item_id"])
        w = batch.get("weight")
        gen = None if draws is not None else device_generator(rng,
                                                              self.device)
        u_all, i_all = self._forward(params, consts, extras, gen, True,
                                     freeze_gates=(mode == 0), draws=draws)
        u_e, p_e, n_e = u_all[user], i_all[pos], i_all[neg]
        mf = bpr_loss((u_e * p_e).sum(-1), (u_e * n_e).sum(-1), w)
        reg = emb_loss([params["user_emb"][user], params["item_emb"][pos],
                        params["item_emb"][neg]], user.shape[0],
                       require_pow=self.require_pow, weight=w)
        return mf + self.reg_weight * reg, {"mf": mf, "reg": reg}
