"""Sequential datasets: sliding-window augmentation + session graphs.

Numpy copy of ``recbole_gnn_tpu/data/session.py`` (all of it): the
same config gives the same arrays, element for element, in both
packages.  It replaces the reference's SessionGraphDataset /
LESSRDataset / GCEGNNDataset (reference:
recbole_gnn/data/dataset.py:109-300) and the [recbole]
SequentialDataset augmentation they build on.

Every session graph is a row in a set of *fixed-width padded numpy
arrays* (widths derived from MAX_ITEM_LIST_LENGTH), built vectorized
over all sessions at once (the SR-GNN graphs by the C++ builder of
``native/`` where it builds), so a batch of B sessions is a
disjoint-union graph with exactly B·L node slots and B·E_max edge
slots, and batching is array slicing.

Node-slot convention per session row:
  slots [0, n_nodes)  = sorted unique real items of the session
  slots [n_nodes, L)  = PAD (item 0)
  alias_inputs[p]     = node slot of sequence position p; padded
                        positions point at slot min(n_nodes, L-1),
                        which holds PAD whenever padding exists.
"""

from __future__ import annotations

import numpy as np

from recbole_gnn_tpu_torch import native
from recbole_gnn_tpu_torch.data.dataset import Dataset

_CHUNK = 8192


class SequentialDataset(Dataset):
    """[recbole] SequentialDataset equivalent: sliding-window prefix
    augmentation, then LS leave-one-out split over augmented samples."""

    def __init__(self, config):
        self.max_seq_len = int(config.or_default("MAX_ITEM_LIST_LENGTH", 50))
        self.item_list_field = (config["ITEM_ID_FIELD"] or "item_id") + \
            config.or_default("LIST_SUFFIX", "_list")
        self.item_length_field = config.or_default("ITEM_LIST_LENGTH_FIELD",
                                                   "item_length")
        self._augmented = False
        super().__init__(config)

    def data_augmentation(self):
        """Per user (time-sorted): one sample per interaction after the
        first, with the preceding (≤ max_seq_len) items as the list —
        matching [recbole] SequentialDataset.data_augmentation."""
        if self._augmented:
            return
        L = self.max_seq_len
        t = self.inter.get(self.time_field)
        uids = self.inter[self.uid_field]
        if t is not None:
            order = np.lexsort((t, uids))
        else:
            order = np.argsort(uids, kind="stable")
        inter = {k: v[order] for k, v in self.inter.items()}
        u = inter[self.uid_field]
        items = inter[self.iid_field]
        n = len(u)

        new_user_start = np.ones(n, dtype=bool)
        new_user_start[1:] = u[1:] != u[:-1]
        # position of each row within its user group
        grp_start_idx = np.maximum.accumulate(
            np.where(new_user_start, np.arange(n), 0))
        pos_in_grp = np.arange(n) - grp_start_idx
        # targets: every row with pos_in_grp >= 1
        tgt = np.nonzero(pos_in_grp >= 1)[0]
        lengths = np.minimum(pos_in_grp[tgt], L).astype(np.int32)
        starts = tgt - lengths

        m = len(tgt)
        seqs = np.zeros((m, L), dtype=np.int32)
        # gather windows: seqs[s, j] = items[starts[s] + j] for j < lengths[s]
        j = np.arange(L)[None, :]
        gather_idx = starts[:, None] + j
        valid = j < lengths[:, None]
        gather_idx = np.where(valid, gather_idx, 0)
        seqs = np.where(valid, items[gather_idx], 0).astype(np.int32)

        new_inter = {k: v[tgt] for k, v in inter.items()}
        new_inter[self.item_list_field] = seqs
        new_inter[self.item_length_field] = lengths
        # window the behavior sequence alongside items when configured
        # (MultiBehaviorDataset; [recbole] augments every list field)
        bid_field = self.config["BEHAVIOR_ID_FIELD"]
        blist_field = self.config["ITEM_BEHAVIOR_LIST_FIELD"]
        if bid_field and blist_field and bid_field in inter:
            bvals = inter[bid_field]
            new_inter[blist_field] = np.where(
                valid, bvals[gather_idx], 0).astype(np.int32)
        self.inter = new_inter
        self._augmented = True

    def build(self) -> list["SequentialDataset"]:
        self.data_augmentation()
        return super().build()

    def _ordered_indices(self, order, rng):
        # Augmented samples are already (uid, time)-ordered; 'TO' is the
        # only meaningful order for sequential eval and is the identity.
        return np.arange(self.inter_num)


def _unique_per_row(vals: np.ndarray, pad: int = 0
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Row-wise sorted-unique of nonzero entries, left-compacted.

    Returns (uniq (N,L) padded with `pad`, counts (N,))."""
    s = np.sort(vals, axis=1)
    prev = np.concatenate([np.full((s.shape[0], 1), -1, s.dtype), s[:, :-1]],
                          axis=1)
    new = (s != prev) & (s != 0)
    counts = new.sum(axis=1).astype(np.int32)
    slot = np.cumsum(new, axis=1) - 1
    out = np.full(vals.shape, pad, dtype=vals.dtype)
    out[np.nonzero(new)[0], slot[new]] = s[new]
    return out, counts


def _alias_per_row(x: np.ndarray, n_nodes: np.ndarray, seqs: np.ndarray,
                   lengths: np.ndarray) -> np.ndarray:
    """alias[r, p] = index of seqs[r, p] within x[r, :n_nodes[r]] (sorted);
    padded positions → min(n_nodes, L-1)."""
    N, L = seqs.shape
    alias = np.zeros((N, L), dtype=np.int32)
    pad_slot = np.minimum(n_nodes, L - 1)
    for lo in range(0, N, _CHUNK):
        hi = min(lo + _CHUNK, N)
        xs = x[lo:hi]
        valid_x = np.arange(L)[None, None, :] < n_nodes[lo:hi, None, None]
        lt = (xs[:, None, :] < seqs[lo:hi, :, None]) & valid_x
        alias[lo:hi] = lt.sum(axis=-1, dtype=np.int32)
    pos_valid = np.arange(L)[None, :] < lengths[:, None]
    return np.where(pos_valid, alias, pad_slot[:, None]).astype(np.int32)


def _dedup_edges_per_row(key: np.ndarray, valid: np.ndarray, L: int
                         ) -> tuple[np.ndarray, np.ndarray]:
    """Row-wise dedup of integer edge keys (invalid → sentinel).

    Returns (uniq_keys padded with -1, counts)."""
    big = key.max(initial=0) + 2
    k = np.where(valid, key, big)
    s = np.sort(k, axis=1)
    prev = np.concatenate([np.full((s.shape[0], 1), -1, s.dtype), s[:, :-1]],
                          axis=1)
    new = (s != prev) & (s != big)
    counts = new.sum(axis=1).astype(np.int32)
    slot = np.cumsum(new, axis=1) - 1
    out = np.full(k.shape, -1, dtype=np.int64)
    out[np.nonzero(new)[0], slot[new]] = s[new]
    return out, counts


class SessionGraphDataset(SequentialDataset):
    """SR-GNN-style session graphs (reference: dataset.py:109-142):
    sorted-unique node set, deduped consecutive-pair edges, alias map.

    Output arrays (all fixed width L = max_seq_len):
      x (N,L) item ids | n_nodes (N,) | alias_inputs (N,L)
      edge_src/edge_dst (N,L) local node slots | n_edges (N,)
    """

    graph_fields = ("x", "n_nodes", "alias_inputs",
                    "edge_src", "edge_dst", "n_edges")

    def build(self):
        datasets = super().build()
        for ds in datasets:
            ds.session_graph_construction()
        return datasets

    def session_graph_construction(self):
        seqs = self.inter[self.item_list_field]
        lengths = self.inter[self.item_length_field]
        self.session_graphs = build_session_graphs(seqs, lengths,
                                                   self.max_seq_len)

    @staticmethod
    def _consecutive_edges(alias, lengths, L):
        a, b = alias[:, :-1], alias[:, 1:]
        valid = (np.arange(L - 1)[None, :] + 1) < lengths[:, None]
        key = a.astype(np.int64) * L + b
        uniq, counts = _dedup_edges_per_row(key, valid, L)
        uniq = np.where(uniq < 0, 0, uniq)
        src = (uniq // L).astype(np.int32)
        dst = (uniq % L).astype(np.int32)
        src = np.pad(src, ((0, 0), (0, 1)))[:, :L]
        dst = np.pad(dst, ((0, 0), (0, 1)))[:, :L]
        return src, dst, counts


def build_session_graphs(seqs: np.ndarray, lengths: np.ndarray, L: int
                         ) -> dict[str, np.ndarray]:
    """The SR-GNN session-graph arrays of :class:`SessionGraphDataset`
    for padded sessions: the C++ builder where it is available, else
    the numpy path (the same arrays).  Training and serving both build
    through here."""
    built = native.build_session_graphs_native(seqs, lengths)
    if built is not None:
        x, n_nodes, alias, src, dst, n_edges = built
    else:
        x, n_nodes = _unique_per_row(seqs)
        alias = _alias_per_row(x, n_nodes, seqs, lengths)
        src, dst, n_edges = SessionGraphDataset._consecutive_edges(
            alias, lengths, L)
    return {"x": x, "n_nodes": n_nodes, "alias_inputs": alias,
            "edge_src": src, "edge_dst": dst, "n_edges": n_edges}


class GCEGNNDataset(SequentialDataset):
    """GCE-GNN local graphs: sessions reversed in place, edges carry
    type attrs — 0 self-loop, 1 backward, 2 forward, 3 bidirectional —
    deduped over (src, dst, attr) (reference: dataset.py:235-300)."""

    graph_fields = ("x", "n_nodes", "alias_inputs",
                    "edge_src", "edge_dst", "edge_attr", "n_edges")

    def build(self):
        datasets = super().build()
        for ds in datasets:
            ds.reverse_session()
            ds.session_graph_construction()
        return datasets

    def reverse_session(self):
        seqs = self.inter[self.item_list_field]
        lengths = self.inter[self.item_length_field]
        self.inter[self.item_list_field] = reverse_sessions(seqs, lengths)

    def session_graph_construction(self):
        seqs = self.inter[self.item_list_field]
        lengths = self.inter[self.item_length_field]
        graphs, E = build_gcegnn_graphs(seqs, lengths, self.max_seq_len)
        self.session_graphs = graphs
        self.max_local_edges = E


def reverse_sessions(seqs: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Reverse each row's first ``lengths`` entries in place-order
    (GCE-GNN convention: most recent click first)."""
    L = seqs.shape[1]
    pos = np.arange(L)[None, :]
    rev_idx = np.where(pos < lengths[:, None], lengths[:, None] - 1 - pos, pos)
    return np.take_along_axis(seqs, rev_idx, axis=1)


def build_gcegnn_graphs(seqs: np.ndarray, lengths: np.ndarray, L: int
                        ) -> tuple[dict[str, np.ndarray], int]:
    """GCE-GNN local-graph arrays for (already reversed) sessions —
    see GCEGNNDataset.  Returns (graphs dict, max local edges E)."""
    x, n_nodes = _unique_per_row(seqs)
    alias = _alias_per_row(x, n_nodes, seqs, lengths)

    N = seqs.shape[0]
    a, b = alias[:, :-1].astype(np.int64), alias[:, 1:].astype(np.int64)
    pair_valid = (np.arange(L - 1)[None, :] + 1) < lengths[:, None]
    # bidirectional: pair (u,v) whose reverse (v,u) also occurs in
    # the consecutive-pair multiset of the same session
    fwd_key = a * L + b
    rev_key = b * L + a
    bidir = np.zeros_like(pair_valid)
    for lo in range(0, N, _CHUNK):
        hi = min(lo + _CHUNK, N)
        fk = np.where(pair_valid[lo:hi], fwd_key[lo:hi], -1)
        rk = np.where(pair_valid[lo:hi], rev_key[lo:hi], -2)
        bidir[lo:hi] = (fk[:, :, None] == rk[:, None, :]).any(axis=-1)

    node_valid = np.arange(L)[None, :] < n_nodes[:, None]
    # self-loop on node slot j: key (j*L + j)*4 + attr0 == j*(L+1)*4
    loop_keys = np.broadcast_to(
        np.arange(L, dtype=np.int64)[None, :] * np.int64(L + 1) * 4, (N, L))

    # edge key packs (src, dst, attr) as (src*L + dst)*4 + attr
    back_attr = np.where(bidir, 3, 1).astype(np.int64)
    fwd_attr = np.where(bidir, 3, 2).astype(np.int64)
    keys = np.concatenate([
        (a * L + b) * 4 + back_attr,
        (b * L + a) * 4 + fwd_attr,
        loop_keys,
    ], axis=1)
    valids = np.concatenate([pair_valid, pair_valid, node_valid], axis=1)
    E = keys.shape[1]
    uniq, counts = _dedup_edges_per_row(keys, valids, E)
    uniq0 = np.where(uniq < 0, 0, uniq)
    attr = (uniq0 % 4).astype(np.int32)
    pair = uniq0 // 4
    src = (pair // L).astype(np.int32)
    dst = (pair % L).astype(np.int32)
    graphs = {
        "x": x, "n_nodes": n_nodes, "alias_inputs": alias,
        "edge_src": src, "edge_dst": dst, "edge_attr": attr,
        "n_edges": counts,
    }
    return graphs, E


def build_lessr_graphs(seqs: np.ndarray, lengths: np.ndarray, L: int
                       ) -> tuple[dict[str, np.ndarray], int]:
    """LESSR per-session graph arrays (reference dataset.py:197-232):
    ordered non-deduped EOP multigraph, deduped i<j shortcut graph,
    is_last flags, plus the EOP mailbox layout (r4) — per (row, node)
    the ORDERED in-edge source slots padded to K = max in-degree, so
    the model's edge-order-preserving GRU runs as K (B,L,D)-wide scan
    steps instead of L-1 per-edge one-hot blends (VERDICT r3 #5; the
    per-node chains are independent because messages depend only on
    input features).  Returns (graphs dict, max shortcut edges M)."""
    N = seqs.shape[0]
    x, n_nodes = _unique_per_row(seqs)
    alias = _alias_per_row(x, n_nodes, seqs, lengths)

    # EOP: ordered consecutive pairs, kept in sequence order
    eop_src = alias[:, :-1].copy()
    eop_dst = alias[:, 1:].copy()
    n_eop = np.maximum(lengths - 1, 0).astype(np.int32)
    eop_valid = np.arange(L - 1)[None, :] < n_eop[:, None]
    eop_src = np.where(eop_valid, eop_src, 0)
    eop_dst = np.where(eop_valid, eop_dst, 0)

    # shortcut: all (alias[i], alias[j]) with i<j, deduped per row
    M = L * (L - 1) // 2
    iu, ju = np.triu_indices(L, k=1)
    sa = alias[:, iu].astype(np.int64)
    sb = alias[:, ju].astype(np.int64)
    s_valid = ju[None, :] < lengths[:, None]
    key = sa * L + sb
    uniq, n_cut = _dedup_edges_per_row(key, s_valid, M)
    uniq = np.where(uniq < 0, 0, uniq)
    cut_src = (uniq // L).astype(np.int32)
    cut_dst = (uniq % L).astype(np.int32)

    # is_last: flag the node holding the final clicked item
    last_slot = np.take_along_axis(
        alias, np.maximum(lengths - 1, 0)[:, None].astype(np.int64),
        axis=1)[:, 0]
    is_last = np.zeros((N, L), dtype=bool)
    is_last[np.arange(N), last_slot] = True
    node_valid = np.arange(L)[None, :] < n_nodes[:, None]
    is_last &= node_valid

    mail, mail_cnt = LESSRDataset._eop_mailbox(eop_src, eop_dst,
                                               eop_valid, L)
    graphs = {
        "x": x, "n_nodes": n_nodes, "alias_inputs": alias,
        "eop_src": eop_src, "eop_dst": eop_dst, "n_eop": n_eop,
        "eop_mail": mail, "eop_mail_cnt": mail_cnt,
        "cut_src": cut_src, "cut_dst": cut_dst, "n_cut": n_cut,
        "is_last": is_last,
    }
    return graphs, M


class LESSRDataset(SequentialDataset):
    """LESSR graphs (reference: dataset.py:197-232): EOP multigraph
    (ordered consecutive pairs, NOT deduped — edge order feeds the GRU
    mailbox), shortcut graph (all i<j alias pairs, deduped), is_last
    node flags."""

    graph_fields = ("x", "n_nodes", "alias_inputs", "eop_src", "eop_dst",
                    "n_eop", "cut_src", "cut_dst", "n_cut", "is_last")

    def build(self):
        datasets = super().build()
        for ds in datasets:
            ds.session_graph_construction()
        return datasets

    def session_graph_construction(self):
        seqs = self.inter[self.item_list_field]
        lengths = self.inter[self.item_length_field]
        graphs, M = build_lessr_graphs(seqs, lengths, self.max_seq_len)
        self.session_graphs = graphs
        self.max_shortcut_edges = M

    @staticmethod
    def _eop_mailbox(eop_src, eop_dst, eop_valid, L):
        """(N, L, K) ordered in-edge source slots per node + (N, L)
        counts, K = max in-degree (≥1).  Vectorized: stable-sort edges
        by (row, dst) — edge order within each group is preserved —
        then rank-within-group gives the mailbox column."""
        N = eop_src.shape[0]
        rows = np.repeat(np.arange(N, dtype=np.int64), L - 1)
        key = rows * L + eop_dst.ravel().astype(np.int64)
        flat_valid = eop_valid.ravel()
        big = np.iinfo(np.int64).max
        order = np.argsort(np.where(flat_valid, key, big), kind="stable")
        n_valid = int(flat_valid.sum())
        idx = order[:n_valid]
        kv = key[idx]
        if n_valid:
            starts = np.flatnonzero(np.r_[True, np.diff(kv) != 0])
            group_len = np.diff(np.r_[starts, n_valid])
            occ = np.arange(n_valid) - np.repeat(starts, group_len)
            K = int(group_len.max())
        else:
            occ = np.zeros(0, np.int64)
            K = 1
        mail = np.zeros((N, L, K), np.int32)
        cnt = np.zeros((N, L), np.int32)
        r = (kv // L).astype(np.int64)
        d = (kv % L).astype(np.int64)
        mail[r, d, occ] = eop_src.ravel()[idx]
        np.add.at(cnt, (r, d), 1)
        return mail, cnt


class MultiBehaviorDataset(SessionGraphDataset):
    """Session graphs with per-behavior node sets (reference:
    dataset.py:145-194).  ``x`` stays the joint node array; per-behavior
    node sets are stored as additional padded arrays keyed
    ``x__<behavior>`` with counts ``n_nodes__<behavior>``.  With no
    behavior fields configured every interaction maps to the single
    behavior 'interaction' (reference's compatibility fallback)."""

    def session_graph_construction(self):
        super().session_graph_construction()
        behavior_list_field = self.config["ITEM_BEHAVIOR_LIST_FIELD"]
        behavior_id_field = self.config["BEHAVIOR_ID_FIELD"]
        seqs = self.inter[self.item_list_field]
        lengths = self.inter[self.item_length_field]
        if behavior_list_field is None or behavior_id_field is None:
            behaviors = {"interaction": np.zeros_like(seqs)}
            bseq = np.zeros_like(seqs)
            names = ["interaction"]
            ids = [0]
        else:
            bseq = self.inter[behavior_list_field]
            vocab = self.field2id_token.get(behavior_id_field)
            uniq = np.unique(bseq)
            names = [str(vocab[b]) if vocab is not None and b < len(vocab)
                     else str(b) for b in uniq]
            ids = list(uniq)
        pos_valid = np.arange(seqs.shape[1])[None, :] < lengths[:, None]
        for name, bid in zip(names, ids):
            sel = np.where(pos_valid & (bseq == bid), seqs, 0)
            bx, bn = _unique_per_row(sel)
            self.session_graphs[f"x__{name}"] = bx
            self.session_graphs[f"n_nodes__{name}"] = bn
        self.behavior_names = names
