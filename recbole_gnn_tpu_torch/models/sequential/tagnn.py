"""TAGNN — target-aware attention over SR-GNN states.

Port of ``recbole_gnn_tpu/models/sequential/tagnn.py`` (reference
tagnn.py:62-87): SR-GNN propagation, a position attention softmaxed
over *all* positions (padding included, reference :75-76) and masked
in the sum, then per candidate item n a target attention
β_n = softmax_l(bₙ·W_t h_l) and the score (s + Σ_l β_nl h_l)·bₙ; CE
only.

The JAX form builds (B, n_items, D) tensors (30.9 GB each at the
diginetica batch of 4,096 × 29,455 items × 64).  Here the same scores
are ``s·bₙ + Σ_l β_nl (h_l·bₙ)``, computed on (B, L, c) tensors over
chunks of c items under ``SCORE_BYTES_BUDGET`` bytes each; with
gradients on, each chunk is checkpointed (recomputed in the backward),
so the saved activations stay (B, c) per chunk.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from recbole_gnn_tpu_torch.models.base import SequentialRecommender
from recbole_gnn_tpu_torch.models.init import (linear, linear_params,
                                               split_keys, uniform_pm)
from recbole_gnn_tpu_torch.models.layers import srgnn_cell_params
from recbole_gnn_tpu_torch.models.losses import cross_entropy
from recbole_gnn_tpu_torch.models.sequential.common import (
    gather_seq_hidden, last_hidden, node_embeddings, seq_mask,
    session_dense_adj, srgnn_cell_dense, srgnn_readout_params)

# bytes of one (B, L, c) f32 tensor of a target-attention chunk
SCORE_BYTES_BUDGET = 1 << 30


def _target_chunk(qt: torch.Tensor, seq_hidden_m: torch.Tensor,
                  items: torch.Tensor) -> torch.Tensor:
    """(B, c) Σ_l softmax_l(bₙ·qt_l) (h_l·bₙ) for the chunk's items, on
    (B, L, c) tensors.  (A (B, c, L) layout, with the softmax over its
    last axis, made the step slower on an H100 at the diginetica batch:
    224.5 against 168.4 ms of device time.)"""
    beta = torch.softmax(torch.matmul(qt, items.T), dim=1)     # (B, L, c)
    return (beta * torch.matmul(seq_hidden_m, items.T)).sum(1)


def target_scores(seq_output: torch.Tensor, seq_hidden_m: torch.Tensor,
                  qt: torch.Tensor, item_emb: torch.Tensor) -> torch.Tensor:
    """(B, n_items) TAGNN scores ``s·bₙ + Σ_l β_nl (h_l·bₙ)`` over item
    chunks of as many items as fit SCORE_BYTES_BUDGET."""
    B, L, _ = qt.shape
    chunk = max(1, SCORE_BYTES_BUDGET // (B * L * 4))
    parts = []
    for lo in range(0, item_emb.shape[0], chunk):
        items = item_emb[lo:lo + chunk]
        if torch.is_grad_enabled():
            parts.append(checkpoint(_target_chunk, qt, seq_hidden_m, items,
                                    use_reentrant=False))
        else:
            parts.append(_target_chunk(qt, seq_hidden_m, items))
    return seq_output @ item_emb.T + torch.cat(parts, dim=1)


class TAGNN(SequentialRecommender):

    def __init__(self, config, dataset, device=None):
        super().__init__(config, dataset, device)
        self.embedding_size = int(config.get("embedding_size", 64))
        self.step = int(config.get("step", 1))
        self.loss_type = str(config.or_default("loss_type", "CE"))
        if self.loss_type != "CE":
            raise NotImplementedError("TAGNN supports CE only")

    def init_params(self, gen):
        d, dev = self.embedding_size, self.device
        stdv = 1.0 / math.sqrt(d)
        k1, k2, k3, k4 = split_keys(gen, 4)
        return {
            "item_emb": uniform_pm(k1, (self.n_items, d), stdv, device=dev),
            "cell": srgnn_cell_params(k2, d, device=dev),
            "readout": srgnn_readout_params(k3, d, stdv, device=dev),
            "linear_t": linear_params(k4, d, d, bias=False, stdv=stdv,
                                      device=dev),
        }

    def full_scores(self, params, consts, extras, batch, rng, train):
        hidden = node_embeddings(params["item_emb"], batch)
        a_in, a_out = session_dense_adj(batch)
        for _ in range(self.step):
            hidden = srgnn_cell_dense(params["cell"], hidden, a_in, a_out)
        seq_hidden = gather_seq_hidden(hidden, batch)
        mask = seq_mask(batch)[:, :, None].to(seq_hidden.dtype)
        ht = last_hidden(seq_hidden, batch["item_seq_len"])

        p = params["readout"]
        q1 = linear(p["linear_one"], ht)[:, None, :]
        q2 = linear(p["linear_two"], seq_hidden)
        alpha = linear(p["linear_three"], torch.sigmoid(q1 + q2))
        # softmax over ALL positions, then the masked sum (reference :75-76)
        alpha = torch.softmax(alpha, dim=1)
        a = (alpha * seq_hidden * mask).sum(1)
        seq_output = linear(p["linear_transform"], torch.cat([a, ht], dim=-1))

        seq_hidden_m = seq_hidden * mask
        qt = linear(params["linear_t"], seq_hidden_m)          # (B, L, D)
        return target_scores(seq_output, seq_hidden_m, qt,
                             params["item_emb"])

    def calculate_loss(self, params, consts, extras, batch, rng, mode=0):
        logits = self.full_scores(params, consts, extras, batch, rng, True)
        loss = cross_entropy(logits, batch["item_id"], batch.get("weight"))
        return loss, {"ce": loss}
