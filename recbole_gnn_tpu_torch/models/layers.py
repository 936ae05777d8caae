"""Reusable GNN / sequence layers (port of
``recbole_gnn_tpu/models/layers.py``): the LightGCN conv, NGCF's
bi-interaction conv, the SR-GNN gated cell on the sparse SpMM, the
masked GRU scan, the post-LN transformer encoder of GCSAN and SASRec,
the causal mask and the edge softmax, plus the inverted dropout the
models share and :class:`KeepStream`, the order in which a forward
takes its dropout masks."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from recbole_gnn_tpu_torch.models.init import linear, linear_params, split_keys
from recbole_gnn_tpu_torch.ops.segment import segment_softmax
from recbole_gnn_tpu_torch.ops.spmm import spmm, spmm_any


def lightgcn_conv(graph, x: torch.Tensor) -> torch.Tensor:
    """Weighted add-aggregation over the normalised adjacency: one SpMM
    (dense or sparse per the graph's representation)."""
    return spmm_any(graph, x)


def lightgcn_propagate(graph, ego: torch.Tensor, n_layers: int,
                       include_ego: bool = True) -> list[torch.Tensor]:
    """K propagation steps; returns the per-layer embedding list
    [e⁰, e¹, …, e^K] (models differ in how they combine them)."""
    out = [ego] if include_ego else []
    h = ego
    for _ in range(n_layers):
        h = lightgcn_conv(graph, h)
        out.append(h)
    return out


def bignn_params(gen: torch.Generator, d_in: int, d_out: int, *,
                 device: torch.device | str = "cpu") -> dict:
    k1, k2 = split_keys(gen, 2)
    return {"lin1": linear_params(k1, d_in, d_out, device=device),
            "lin2": linear_params(k2, d_in, d_out, device=device)}


def bignn_conv(p: dict, graph, x: torch.Tensor) -> torch.Tensor:
    """(L + I)·E·W₁ + (L·E ⊙ E)·W₂ over a sparse :class:`Graph`."""
    x_prop = spmm(graph, x)
    return linear(p["lin1"], x_prop + x) + linear(p["lin2"], x_prop * x)


def dropout_keep(gen: torch.Generator, shape, p: float) -> torch.Tensor:
    """Bernoulli(1 − p) keep-mask (``jax.random.bernoulli``'s u < 1 − p)."""
    return torch.rand(shape, generator=gen, device=gen.device) < 1.0 - p


def apply_dropout(x: torch.Tensor, keep: torch.Tensor, p: float
                  ) -> torch.Tensor:
    """Inverted dropout with a given keep-mask: x / (1 − p) or 0."""
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


class KeepStream:
    """The dropout keep-masks of one forward, in the order it takes
    them: from ``keeps`` when given (the JAX draws in the parity tests,
    or the ``drawn`` list of an earlier stream, to replay a step on
    another device), else drawn from ``gen`` as :func:`dropout_keep`
    draws.  ``drawn`` records every mask handed out."""

    def __init__(self, gen: torch.Generator | None = None, keeps=None):
        if gen is None and keeps is None:
            raise ValueError("KeepStream needs a generator or keeps")
        self.gen = gen
        self._given = None if keeps is None else iter(keeps)
        self.drawn: list[torch.Tensor] = []

    @classmethod
    def of(cls, keeps, gen_fn) -> "KeepStream":
        """``keeps`` itself when it is a stream, else a stream over the
        given masks, or over draws from ``gen_fn()`` when none are."""
        if isinstance(keeps, cls):
            return keeps
        return cls(gen_fn() if keeps is None else None, keeps)

    def keep(self, shape, p: float, device) -> torch.Tensor:
        if self._given is not None:
            keep = next(self._given).to(device)
            if tuple(keep.shape) != tuple(shape):
                raise ValueError(f"injected keep mask of shape "
                                 f"{tuple(keep.shape)}, expected {tuple(shape)}")
        else:
            keep = dropout_keep(self.gen, shape, p)
        self.drawn.append(keep)
        return keep

    def dropout(self, x: torch.Tensor, p: float) -> torch.Tensor:
        """Inverted dropout of ``x`` at rate ``p`` with the next mask."""
        return apply_dropout(x, self.keep(x.shape, p, x.device), p)


# -- SRGNN gated cell ---------------------------------------------------

def srgnn_cell_params(gen: torch.Generator, dim: int, *,
                      device: torch.device | str = "cpu") -> dict:
    stdv = 1.0 / math.sqrt(dim)
    k1, k2, k3, k4 = split_keys(gen, 4)
    return {
        "in_conv": linear_params(k1, dim, dim, stdv=stdv, device=device),
        "out_conv": linear_params(k2, dim, dim, stdv=stdv, device=device),
        "lin_ih": linear_params(k3, 2 * dim, 3 * dim, stdv=stdv,
                                device=device),
        "lin_hh": linear_params(k4, dim, 3 * dim, stdv=stdv, device=device),
    }


def srgnn_gate(p: dict, hidden: torch.Tensor, input_in: torch.Tensor,
               input_out: torch.Tensor) -> torch.Tensor:
    """The GRU-style gate of the SR-GNN cell over the two aggregated
    inputs (reference SRGNNCell, layers.py:82-114)."""
    gi = linear(p["lin_ih"], torch.cat([input_in, input_out], dim=-1))
    gh = linear(p["lin_hh"], hidden)
    i_r, i_i, i_n = gi.chunk(3, dim=-1)
    h_r, h_i, h_n = gh.chunk(3, dim=-1)
    reset = torch.sigmoid(i_r + h_r)
    update = torch.sigmoid(i_i + h_i)
    new = torch.tanh(i_n + reset * h_n)
    return (1.0 - update) * hidden + update * new


def srgnn_cell(p: dict, hidden: torch.Tensor, in_graph, out_graph
               ) -> torch.Tensor:
    """Dual mean-aggregation convs (in-edges / reversed edges) feeding
    the gate, over sparse graphs (reference SRGNNConv + SRGNNCell,
    layers.py:69-114): one SpMM per direction.

    ``in_graph``/``out_graph`` carry row-normalised weights (mean
    aggregation) over the batch's disjoint-union session graph
    (``models/sequential/common.session_union_graphs``); nodes with no
    in-edge receive 0, as PyG's mean aggregation gives isolated
    nodes."""
    input_in = spmm(in_graph, linear(p["in_conv"], hidden))
    input_out = spmm(out_graph, linear(p["out_conv"], hidden))
    return srgnn_gate(p, hidden, input_in, input_out)


# -- GRU (GRU4Rec / NARM) ---------------------------------------------------

def gru_params(gen: torch.Generator, d_in: int, d_hidden: int, *,
               device: torch.device | str = "cpu") -> dict:
    k1, k2 = split_keys(gen, 2)
    return {"ih": linear_params(k1, d_in, 3 * d_hidden, device=device),
            "hh": linear_params(k2, d_hidden, 3 * d_hidden, device=device)}


def _gru_update(gi: torch.Tensor, gh: torch.Tensor, h: torch.Tensor
                ) -> torch.Tensor:
    i_r, i_z, i_n = gi.chunk(3, dim=-1)
    h_r, h_z, h_n = gh.chunk(3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1.0 - z) * n + z * h


def gru_step(p: dict, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return _gru_update(linear(p["ih"], x), linear(p["hh"], h), h)


def gru_scan(p: dict, xs: torch.Tensor, h0: torch.Tensor,
             mask: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Run a GRU over the time axis of ``xs`` (B, T, D) with an optional
    (B, T) validity mask: a masked step keeps the previous state (not
    ``nn.GRU`` over packed sequences, which is another function).  The
    input projections of all steps are one matmul.

    Returns (all_states (B, T, H), last_state (B, H))."""
    gis = linear(p["ih"], xs)
    h = h0
    states = []
    for t in range(xs.shape[1]):
        h_new = _gru_update(gis[:, t], linear(p["hh"], h), h)
        if mask is not None:
            h_new = torch.where(mask[:, t, None], h_new, h)
        h = h_new
        states.append(h)
    return torch.stack(states, dim=1), h


# -- Transformer encoder (GCSAN / SASRec) -------------------------------

def transformer_params(gen: torch.Generator, n_layers: int, n_heads: int,
                       d_model: int, d_ff: int, *,
                       device: torch.device | str = "cpu") -> dict:
    layers = []
    for k in split_keys(gen, n_layers):
        kq, kk, kv, ko, k1, k2 = split_keys(k, 6)
        layers.append({
            "q": linear_params(kq, d_model, d_model, device=device),
            "k": linear_params(kk, d_model, d_model, device=device),
            "v": linear_params(kv, d_model, d_model, device=device),
            "o": linear_params(ko, d_model, d_model, device=device),
            "ff1": linear_params(k1, d_model, d_ff, device=device),
            "ff2": linear_params(k2, d_ff, d_model, device=device),
            "ln1": {"g": torch.ones(d_model, device=device),
                    "b": torch.zeros(d_model, device=device)},
            "ln2": {"g": torch.ones(d_model, device=device),
                    "b": torch.zeros(d_model, device=device)},
        })
    return {"layers": layers}


def layer_norm(p: dict, x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """LayerNorm with the biased variance, eps 1e-12 ([recbole])."""
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p["g"] + p["b"]


def transformer_encoder(p: dict, x: torch.Tensor, attn_mask: torch.Tensor,
                        keeps: KeepStream | None = None,
                        dropout: float = 0.0, n_heads: int = 1,
                        attn_dropout: float | None = None) -> torch.Tensor:
    """Post-LN transformer (the [recbole] TransformerEncoder layout of
    GCSAN, gcsan.py:59-68).  ``attn_mask`` is (B, T, T) additive (0 keep
    / −1e9 drop).  With ``keeps`` each layer drops, in this order, the
    attention probabilities after the softmax (``attn_dropout``,
    defaults to ``dropout``), the attention output and the feed-forward
    output; a rate of 0 takes no mask.  GELU is the exact erf form."""
    B, T, D = x.shape
    dh = D // n_heads
    if attn_dropout is None:
        attn_dropout = dropout

    def maybe_dropout(h, rate):
        if keeps is None or rate <= 0.0:
            return h
        return keeps.dropout(h, rate)

    for lp in p["layers"]:
        def heads(w):
            return linear(w, x).reshape(B, T, n_heads, dh).transpose(1, 2)
        q, k, v = heads(lp["q"]), heads(lp["k"]), heads(lp["v"])
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(float(dh))
        attn = torch.softmax(scores + attn_mask[:, None, :, :], dim=-1)
        attn = maybe_dropout(attn, attn_dropout)
        ctx = torch.matmul(attn, v).transpose(1, 2).reshape(B, T, D)
        h = maybe_dropout(linear(lp["o"], ctx), dropout)
        x = layer_norm(lp["ln1"], x + h)
        ff = linear(lp["ff2"], F.gelu(linear(lp["ff1"], x),
                                      approximate="none"))
        ff = maybe_dropout(ff, dropout)
        x = layer_norm(lp["ln2"], x + ff)
    return x


def causal_additive_mask(seq_len_mask: torch.Tensor) -> torch.Tensor:
    """(B, T) bool valid mask → (B, T, T) additive causal mask, 0 where
    attended and −1e9 (not −inf) elsewhere (GCSAN.get_attention_mask,
    gcsan.py:92-106)."""
    T = seq_len_mask.shape[1]
    causal = torch.tril(torch.ones((T, T), dtype=torch.bool,
                                   device=seq_len_mask.device))
    m = causal[None, :, :] & seq_len_mask[:, None, :]
    return torch.where(m, 0.0, -1e9)


# -- attention readout over session nodes -------------------------------

def edge_attention(logits: torch.Tensor, dst: torch.Tensor, n_nodes: int,
                   mask: torch.Tensor | None = None) -> torch.Tensor:
    """Edge softmax per destination node (PyG ``softmax`` / DGL
    ``edge_softmax``)."""
    return segment_softmax(logits, dst, n_nodes, mask=mask)
