"""Social dataset: .net loading, joint user remap, social adjacency.

Port of ``recbole_gnn_tpu/data/social.py`` (reference
recbole_gnn/data/dataset.py:303-456): loads ``<dataset>.net``, applies
the optional undirected duplication, filters net edges whose users are
absent from the interactions, remaps user ids *jointly* across inter
and net (one alias group) and exposes the normalised U-U social
adjacency as a :class:`~recbole_gnn_tpu_torch.ops.spmm.Graph`.  All
host-side numpy.
"""

from __future__ import annotations

import os

import numpy as np
import pandas as pd
import torch

from recbole_gnn_tpu_torch.data.atomic import atomic_path, read_atomic_file
from recbole_gnn_tpu_torch.data.dataset import GeneralGraphDataset
from recbole_gnn_tpu_torch.ops.spmm import Graph, build_graph, graph_impl


class SocialDataset(GeneralGraphDataset):

    def __init__(self, config):
        self.net: dict[str, np.ndarray] = {}
        self.net_src_field = config.or_default("NET_SOURCE_ID_FIELD",
                                               "source_id")
        self.net_tgt_field = config.or_default("NET_TARGET_ID_FIELD",
                                               "target_id")
        super().__init__(config)

    def _load_side_tables(self, sep, seq_sep, load_col, data_path):
        super()._load_side_tables(sep, seq_sep, load_col, data_path)
        path = atomic_path(data_path, self.dataset_name, "net")
        if not os.path.isfile(path):
            raise FileNotFoundError(f"social dataset needs a .net file: {path}")
        usecols = list(load_col.get("net")) if load_col.get("net") else None
        self.net, ftypes = read_atomic_file(path, sep, seq_sep, usecols)
        self.field2type.update(ftypes)
        if self.config["undirected_net"] is not False:
            src = self.net[self.net_src_field]
            tgt = self.net[self.net_tgt_field]
            self.net[self.net_src_field] = np.concatenate([src, tgt])
            self.net[self.net_tgt_field] = np.concatenate([tgt, src])

    def _process(self):
        self._filter_by_value()
        self._filter_by_inter_num()
        if self.config["filter_net_by_inter"] is not False:
            self._filter_net_by_inter()
        self._remap_ids()

    def _filter_net_by_inter(self):
        """Keep the net edges whose both users interact (token
        equality, as the reference's set lookup)."""
        inter_uids = pd.unique(pd.Series(self.inter[self.uid_field],
                                         dtype=object))
        keep = (pd.Series(self.net[self.net_src_field], dtype=object)
                .isin(inter_uids).to_numpy()
                & pd.Series(self.net[self.net_tgt_field], dtype=object)
                .isin(inter_uids).to_numpy())
        self.net = {k: v[keep] for k, v in self.net.items()}

    def _alias_groups(self):
        # user ids share one vocabulary across inter + net (reference
        # `_init_alias`, dataset.py:397-421); side-table fields join too
        groups = super()._alias_groups()
        groups[0] = groups[0] + [("net", self.net_src_field),
                                 ("net", self.net_tgt_field)]
        return groups

    def _table(self, name):
        return self.net if name == "net" else super()._table(name)

    @property
    def net_num(self) -> int:
        return len(self.net[self.net_src_field])

    def net_edges(self) -> tuple[np.ndarray, np.ndarray]:
        return (np.asarray(self.net[self.net_src_field], dtype=np.int64),
                np.asarray(self.net[self.net_tgt_field], dtype=np.int64))

    def get_norm_net_adj_graph(self, row_norm: bool = False, *,
                               device: torch.device | str) -> Graph:
        """Normalised U-U social adjacency (reference
        `get_norm_net_adj_mat`, dataset.py:425-445) on ``device``:
        degree over the *source* endpoint; sym → 1/√(d[src]·d[dst])
        (undirected nets have equal in/out degree), row → 1/d[src].
        The graph propagates along src→tgt, so dst = tgt; it runs with
        the config's ``sparse_spmm_impl`` / ``pallas_spmm_precision``,
        with the ELL layouts exactly when the impl is ``ell``.  No model
        calls it, in either package: DiffNet builds its net matrix
        through ``to_device_matrix``."""
        src, dst = self.net_edges()
        deg = np.bincount(src, minlength=self.n_users).astype(np.float64)
        safe = np.where(deg == 0, 1.0, deg)
        if row_norm:
            w = (1.0 / safe)[src]
        else:
            inv_sqrt = 1.0 / np.sqrt(safe)
            w = inv_sqrt[src] * inv_sqrt[dst]
        with_pallas = self.config["use_pallas_spmm"] is not False
        impl = str(self.config.get("sparse_spmm_impl", "ell"))
        return build_graph(src, dst, w, self.n_users, device=device,
                           with_pallas=with_pallas,
                           impl=graph_impl(impl, with_pallas),
                           precision=str(self.config.get(
                               "pallas_spmm_precision", "f32x2")))

    def net_coo(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Raw social COO (deduplicated), for host-side motif algebra
        (MHCN/SEPT preprocessing)."""
        src, dst = self.net_edges()
        key = src * self.n_users + dst
        _, first = np.unique(key, return_index=True)
        return (src[first], dst[first], np.ones(len(first), dtype=np.float32))

