"""NeuMF — neural matrix factorization (GMF ⊕ MLP, BCE loss).

Port of ``recbole_gnn_tpu/models/general/neumf.py``, a RecBole
fallback baseline: separate GMF and MLP embeddings, an MLP tower over
the concatenated pair, a linear prediction head, pointwise BCE on the
positive (label 1) and the sampled negative (label 0) of each pair.
No graph.

Its scores are not a user·item factorisation (``factorized_eval`` is
False): full-sort evaluation runs every (user, item) pair through the
MLP (:meth:`score_users_vs_all`), over item chunks whose activations
stay under ``SCORE_BYTES_BUDGET``, and the serving export refuses it.

Dropout masks come from a generator derived from the trainer's;
``draws`` takes the JAX ones in the tests: per scored side (pos, neg)
a mask per MLP layer.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from recbole_gnn_tpu_torch.models.base import BaseRecommender, device_generator
from recbole_gnn_tpu_torch.models.layers import apply_dropout, dropout_keep
from recbole_gnn_tpu_torch.models.init import (linear, linear_params,
                                               normal_init, split_keys)
from recbole_gnn_tpu_torch.utils.enums import InputType, ModelType

# bytes of the widest (pairs, width) f32 activation one scoring chunk
# may make: 86 GB for 4,096 users × 40,981 items unchunked
SCORE_BYTES_BUDGET = 1 << 30


class NeuMF(BaseRecommender):

    model_type = ModelType.GENERAL
    input_type = InputType.POINTWISE
    factorized_eval = False

    def __init__(self, config, dataset, device=None):
        super().__init__(config, dataset, device)
        self.mf_size = int(config.get("mf_embedding_size", 64))
        self.mlp_size = int(config.get("mlp_embedding_size", 64))
        self.mlp_hidden = list(config.or_default("mlp_hidden_size", [128, 64]))
        self.dropout_prob = float(config.get("dropout_prob", 0.1))
        self.mf_train = config["mf_train"] is not False
        self.mlp_train = config["mlp_train"] is not False

    def init_params(self, gen):
        ks = split_keys(gen, 5 + len(self.mlp_hidden))
        dev = self.device
        params = {
            "user_mf": normal_init(ks[0], (self.n_users, self.mf_size), 0.01,
                                   device=dev),
            "item_mf": normal_init(ks[1], (self.n_items, self.mf_size), 0.01,
                                   device=dev),
            "user_mlp": normal_init(ks[2], (self.n_users, self.mlp_size),
                                    0.01, device=dev),
            "item_mlp": normal_init(ks[3], (self.n_items, self.mlp_size),
                                    0.01, device=dev),
            "mlp": [],
        }
        dims = [2 * self.mlp_size] + self.mlp_hidden
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            params["mlp"].append(linear_params(ks[4 + i], a, b, device=dev))
        pred_in = ((self.mf_size if self.mf_train else 0)
                   + (self.mlp_hidden[-1] if self.mlp_train else 0))
        params["predict"] = linear_params(ks[-1], pred_in, 1, device=dev)
        return params

    def _scores(self, params, users, items, gen=None, train=False,
                masks=None):
        parts = []
        if self.mf_train:
            parts.append(params["user_mf"][users] * params["item_mf"][items])
        if self.mlp_train:
            h = torch.cat([params["user_mlp"][users],
                           params["item_mlp"][items]], dim=-1)
            for i, lp in enumerate(params["mlp"]):
                if train and self.dropout_prob > 0:
                    keep = (masks[i] if masks is not None else
                            dropout_keep(gen, h.shape, self.dropout_prob))
                    h = apply_dropout(h, keep, self.dropout_prob)
                h = F.relu(linear(lp, h))
            parts.append(h)
        return linear(params["predict"], torch.cat(parts, dim=-1))[..., 0]

    def propagate(self, params, consts, extras):
        # no factorised form: the evaluator scores through
        # score_users_vs_all
        raise NotImplementedError

    def score_users_vs_all(self, params, users: torch.Tensor) -> torch.Tensor:
        """(B, n_items) logits of every (user, item) pair, over item
        chunks of at most ``SCORE_BYTES_BUDGET`` bytes of activations."""
        b = users.shape[0]
        width = max([2 * self.mlp_size, self.mf_size] + self.mlp_hidden)
        chunk = max(1, SCORE_BYTES_BUDGET // max(1, b * width * 4))
        out = []
        for lo in range(0, self.n_items, chunk):
            items = torch.arange(lo, min(lo + chunk, self.n_items),
                                 device=users.device)
            u_rep = users[:, None].expand(b, items.shape[0]).reshape(-1)
            i_rep = items[None, :].expand(b, items.shape[0]).reshape(-1)
            out.append(self._scores(params, u_rep, i_rep)
                       .reshape(b, items.shape[0]))
        return torch.cat(out, dim=1)

    def calculate_loss(self, params, consts, extras, batch, rng, mode=0,
                       draws: tuple | None = None):
        user, pos, neg = (batch["user_id"], batch["item_id"],
                          batch["neg_item_id"])
        w = batch.get("weight")
        gen = None if draws is not None else device_generator(rng,
                                                              self.device)
        d_pos, d_neg = draws if draws is not None else (None, None)
        pos_logit = self._scores(params, user, pos, gen, True, d_pos)
        neg_logit = self._scores(params, user, neg, gen, True, d_neg)
        # BCE with labels 1 / 0 in the log-sigmoid form, mean over the
        # 2B rows
        losses = (-F.logsigmoid(pos_logit) - F.logsigmoid(-neg_logit)) / 2.0
        loss = ((losses * w).sum() / torch.clamp(w.sum(), min=1.0)
                if w is not None else losses.mean())
        return loss, {"bce": loss}
