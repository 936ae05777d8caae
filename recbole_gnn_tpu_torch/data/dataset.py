"""Datasets: atomic-file loading, filtering, ID remap, splits, graphs.

Port of ``recbole_gnn_tpu/data/dataset.py`` — ``Dataset`` and
``GeneralGraphDataset``: value-interval filtering, iterative k-core
filtering (the C++ fixed point of ``native/`` where it builds, else the
numpy loop; both keep the same rows), first-appearance token remap with
[PAD]=0, ratio / leave-one-out splits, and the normalised user-item
graph with its dense/sparse dispatch.  All host-side numpy; only the
finished graph is moved to a device.  The sequential datasets live in
``data/session.py`` and the social one in ``data/social.py``; both are
exported here, as the registry names them.
"""

from __future__ import annotations

import copy as _copy
import math
import os

import numpy as np
import pandas as pd
import torch

from recbole_gnn_tpu_torch import native
from recbole_gnn_tpu_torch.data.atomic import (TOKEN, atomic_path,
                                               read_atomic_file)
from recbole_gnn_tpu_torch.ops.spmm import build_dense_bipartite, build_graph

PAD_TOKEN = "[PAD]"


def parse_interval(spec: str) -> tuple[float, float, bool, bool]:
    """Parse RecBole interval strings like "[3,inf)" → (lo, hi, lo_inc, hi_inc)."""
    spec = spec.strip()
    lo_inc = spec[0] == "["
    hi_inc = spec[-1] == "]"
    lo_s, hi_s = spec[1:-1].split(",")
    lo = -math.inf if lo_s.strip() in ("-inf", "") else float(lo_s)
    hi = math.inf if hi_s.strip() in ("inf", "") else float(hi_s)
    return lo, hi, lo_inc, hi_inc


def _in_interval(vals: np.ndarray, spec: str) -> np.ndarray:
    lo, hi, lo_inc, hi_inc = parse_interval(spec)
    lom = vals >= lo if lo_inc else vals > lo
    him = vals <= hi if hi_inc else vals < hi
    return lom & him


class Dataset:
    """General-recommendation dataset over a user-item interaction table.

    After construction: ``inter`` holds int32-remapped token columns and
    float columns; ``n_users``/``n_items`` include the PAD id 0.
    """

    def __init__(self, config):
        self.config = config
        self.dataset_name = config["dataset"]
        self.uid_field = config["USER_ID_FIELD"] or "user_id"
        self.iid_field = config["ITEM_ID_FIELD"] or "item_id"
        self.time_field = config["TIME_FIELD"]
        self.rating_field = config["RATING_FIELD"]
        self.field2type: dict[str, str] = {}
        self.field2id_token: dict[str, np.ndarray] = {}
        self.field2token_id: dict[str, dict] = {}
        self.inter: dict[str, np.ndarray] = {}
        self.user_feat: dict[str, np.ndarray] = {}
        self.item_feat: dict[str, np.ndarray] = {}
        self._load_all()
        self._process()

    # -- loading -------------------------------------------------------

    def _load_all(self):
        cfg = self.config
        sep = cfg["field_separator"] or "\t"
        seq_sep = cfg["seq_separator"] or " "
        load_col = cfg["load_col"] or {}
        data_path = cfg["data_path"] or "dataset/"
        path = atomic_path(data_path, self.dataset_name, "inter")
        if not os.path.isfile(path):
            raise FileNotFoundError(f"missing atomic file: {path}")
        usecols = list(load_col.get("inter")) if load_col.get("inter") else None
        self.inter, ftypes = read_atomic_file(path, sep, seq_sep, usecols)
        self.field2type.update(ftypes)
        self._load_side_tables(sep, seq_sep, load_col, data_path)

    def _load_side_tables(self, sep, seq_sep, load_col, data_path):
        """Load .user/.item feature tables when requested via load_col
        ([recbole] user_feat/item_feat)."""
        for suffix, attr in (("user", "user_feat"), ("item", "item_feat")):
            if not load_col.get(suffix):
                continue
            path = atomic_path(data_path, self.dataset_name, suffix)
            if not os.path.isfile(path):
                raise FileNotFoundError(f"missing atomic file: {path}")
            table, ftypes = read_atomic_file(
                path, sep, seq_sep, list(load_col[suffix]))
            setattr(self, attr, table)
            self.field2type.update(ftypes)

    # -- processing ----------------------------------------------------

    def _process(self):
        self._filter_by_value()
        self._filter_by_inter_num()
        self._remap_ids()

    def _filter_by_value(self):
        val_interval = self.config["val_interval"]
        if not val_interval:
            return
        keep = np.ones(len(self.inter[self.uid_field]), dtype=bool)
        for field, spec in val_interval.items():
            if field in self.inter:
                keep &= _in_interval(
                    np.asarray(self.inter[field], dtype=np.float64), spec)
        self._apply_inter_mask(keep)

    def _filter_by_inter_num(self):
        """Iterative k-core: drop users/items outside their count interval
        until a fixed point, mirroring [recbole] `_filter_by_inter_num`.

        Uses the native C++ fixed-point filter when it is available;
        the numpy isin loop otherwise."""
        u_spec = self.config["user_inter_num_interval"]
        i_spec = self.config["item_inter_num_interval"]
        if not u_spec and not i_spec:
            return
        keep = self._kcore_native(u_spec, i_spec)
        if keep is not None:
            self._apply_inter_mask(keep)
            return
        while True:
            users = self.inter[self.uid_field]
            items = self.inter[self.iid_field]
            keep = np.ones(len(users), dtype=bool)
            if u_spec:
                uniq, cnt = np.unique(users, return_counts=True)
                ok = uniq[_in_interval(cnt.astype(np.float64), u_spec)]
                keep &= np.isin(users, ok)
            if i_spec:
                uniq, cnt = np.unique(items, return_counts=True)
                ok = uniq[_in_interval(cnt.astype(np.float64), i_spec)]
                keep &= np.isin(items, ok)
            if keep.all():
                break
            self._apply_inter_mask(keep)

    def _kcore_native(self, u_spec, i_spec):
        """The C++ path: count intervals as integer bounds, tokens
        factorised to ints first (they are not remapped yet)."""
        def bounds(spec):
            if not spec:
                return 0, np.iinfo(np.int64).max
            lo, hi, lo_inc, hi_inc = parse_interval(spec)
            lo_i = int(np.ceil(lo)) if np.isfinite(lo) else 0
            if np.isfinite(lo) and not lo_inc and lo_i == lo:
                lo_i += 1
            hi_i = (int(np.floor(hi)) if np.isfinite(hi)
                    else np.iinfo(np.int64).max)
            if np.isfinite(hi) and not hi_inc and hi_i == hi:
                hi_i -= 1
            return lo_i, hi_i

        users_t = self.inter[self.uid_field]
        items_t = self.inter[self.iid_field]
        if len(users_t) == 0:
            return None
        users = pd.factorize(users_t)[0].astype(np.int64)
        items = pd.factorize(items_t)[0].astype(np.int64)
        u_lo, u_hi = bounds(u_spec)
        i_lo, i_hi = bounds(i_spec)
        return native.kcore_filter_native(
            users, items, int(users.max()) + 1, int(items.max()) + 1,
            u_lo, u_hi, i_lo, i_hi)

    def _apply_inter_mask(self, keep: np.ndarray):
        self.inter = {k: v[keep] for k, v in self.inter.items()}

    def _remap_ids(self):
        """Token → contiguous int ids, PAD=0, first-appearance order
        (matches [recbole] `_remap` via pd.factorize)."""
        for group in self._alias_groups():
            self._remap_group(group)
        # remaining token fields, each its own vocabulary
        done = {f for g in self._alias_groups() for (_t, f) in g}
        for field, ftype in list(self.field2type.items()):
            if ftype == TOKEN and field not in done and field in self.inter:
                self._remap_group([("inter", field)])

    def _alias_groups(self) -> list[list[tuple[str, str]]]:
        """Groups of (table, field) sharing one id space."""
        g_user = [("inter", self.uid_field)]
        if self.uid_field in self.user_feat:
            g_user.append(("user_feat", self.uid_field))
        g_item = [("inter", self.iid_field)]
        if self.iid_field in self.item_feat:
            g_item.append(("item_feat", self.iid_field))
        return [g_user, g_item]

    def _table(self, name: str) -> dict[str, np.ndarray]:
        return self.inter if name == "inter" else getattr(self, name)

    def feat_matrix(self, table: str, field: str) -> np.ndarray:
        """Dense per-id feature array aligned to the remapped id space:
        row i = feature of user/item id i (zeros where absent)."""
        feats = getattr(self, table)
        key_field = self.uid_field if table == "user_feat" else self.iid_field
        n = self.n_users if table == "user_feat" else self.n_items
        ids = np.asarray(feats[key_field], dtype=np.int64)
        vals = feats[field]
        if vals.dtype == object:          # *_seq columns → 2D float
            width = max(len(v) for v in vals)
            dense = np.zeros((n, width), dtype=np.float32)
            for i, v in zip(ids, vals):
                dense[i, :len(v)] = v
        else:
            dense = np.zeros((n,) + vals.shape[1:], dtype=vals.dtype)
            dense[ids] = vals
        return dense

    def _remap_group(self, group: list[tuple[str, str]]):
        cols = [np.asarray(self._table(t)[f], dtype=object) for t, f in group]
        lens = np.cumsum([len(c) for c in cols])[:-1]
        codes, uniques = pd.factorize(np.concatenate(cols))
        parts = np.split(codes.astype(np.int64) + 1, lens)
        vocab = np.array([PAD_TOKEN] + list(uniques), dtype=object)
        for (t, f), part in zip(group, parts):
            self._table(t)[f] = part.astype(np.int32)
            self.field2id_token[f] = vocab
            self.field2token_id[f] = {tok: i for i, tok in enumerate(vocab)}

    # -- basic stats ----------------------------------------------------

    @property
    def n_users(self) -> int:
        return len(self.field2id_token[self.uid_field])

    @property
    def n_items(self) -> int:
        return len(self.field2id_token[self.iid_field])

    @property
    def inter_num(self) -> int:
        return len(self.inter[self.uid_field])

    def num(self, field: str) -> int:
        """Vocabulary size of a token field (PAD included)."""
        if field in self.field2id_token:
            return len(self.field2id_token[field])
        raise KeyError(field)

    def copy(self, new_inter: dict[str, np.ndarray]) -> "Dataset":
        other = _copy.copy(self)
        other.inter = new_inter
        return other

    def __str__(self):
        return (f"{type(self).__name__}({self.dataset_name}: "
                f"{self.n_users - 1} users, {self.n_items - 1} items, "
                f"{self.inter_num} interactions)")

    # -- splitting -------------------------------------------------------

    def _ordered_indices(self, order: str, rng: np.random.Generator) -> np.ndarray:
        n = self.inter_num
        if order == "RO":
            idx = rng.permutation(n)
        elif order == "TO":
            if self.time_field and self.time_field in self.inter:
                idx = np.lexsort((self.inter[self.time_field],))
            else:
                idx = np.arange(n)
        else:
            raise ValueError(f"unknown eval order {order!r}")
        return idx

    @staticmethod
    def _calc_split_counts(tot: int, ratios: list[float]) -> list[int]:
        """[recbole] `_calcu_split_ids` semantics: floor each, remainder to
        the first; then grant one sample to splits that deserve a
        fraction (0 < r·tot < 1) while the first can spare it."""
        cnt = [int(r * tot) for r in ratios]
        cnt[0] = tot - sum(cnt[1:])
        for i in range(1, len(ratios)):
            if cnt[0] <= 1:
                break
            if 0 < ratios[-i] * tot < 1:
                cnt[-i] += 1
                cnt[0] -= 1
        return cnt

    def build(self) -> list["Dataset"]:
        """Split per config['eval_args'] → [train, valid, test] datasets."""
        eval_args = self.config["eval_args"] or {}
        split = eval_args.get("split") or {"RS": [0.8, 0.1, 0.1]}
        order = eval_args.get("order", "RO")
        group_by = eval_args.get("group_by", "user")
        rng = np.random.default_rng(self.config.get("seed", 2020))
        idx = self._ordered_indices(order, rng)

        if "RS" in split:
            ratios = list(split["RS"])
            s = sum(ratios)
            ratios = [r / s for r in ratios]
            if group_by == "user":
                splits = self._split_by_ratio_grouped(idx, ratios)
            else:
                splits = self._split_by_ratio_global(idx, ratios)
        elif "LS" in split:
            splits = self._split_leave_one_out(idx, split["LS"])
        else:
            raise ValueError(f"unknown split spec {split!r}")
        return [self.copy({k: v[s] for k, v in self.inter.items()})
                for s in splits]

    def _split_by_ratio_grouped(self, idx, ratios):
        uids = self.inter[self.uid_field][idx]
        order_groups = pd.Series(np.arange(len(idx))).groupby(uids, sort=False)
        parts: list[list[np.ndarray]] = [[] for _ in ratios]
        for _uid, grp in order_groups:
            rows = idx[grp.to_numpy()]
            cnt = self._calc_split_counts(len(rows), ratios)
            start = 0
            for j, c in enumerate(cnt):
                parts[j].append(rows[start:start + c])
                start += c
        return [np.concatenate(p) if p else np.array([], dtype=np.int64)
                for p in parts]

    def _split_by_ratio_global(self, idx, ratios):
        cnt = self._calc_split_counts(len(idx), ratios)
        out, start = [], 0
        for c in cnt:
            out.append(idx[start:start + c])
            start += c
        return out

    def _split_leave_one_out(self, idx, ls_mode: str):
        uids = self.inter[self.uid_field][idx]
        order_groups = pd.Series(np.arange(len(idx))).groupby(uids, sort=False)
        train, valid, test = [], [], []
        for _uid, grp in order_groups:
            rows = idx[grp.to_numpy()]
            if ls_mode == "valid_and_test":
                train.append(rows[:-2])
                valid.append(rows[-2:-1])
                test.append(rows[-1:])
            elif ls_mode == "valid_only":
                train.append(rows[:-1])
                valid.append(rows[-1:])
                test.append(rows[:0])
            elif ls_mode == "test_only":
                train.append(rows[:-1])
                valid.append(rows[:0])
                test.append(rows[-1:])
            else:
                raise ValueError(f"unknown LS mode {ls_mode!r}")
        cat = lambda p: np.concatenate(p) if p else np.array([], dtype=np.int64)
        return [cat(train), cat(valid), cat(test)]

    # -- user-grouped views ---------------------------------------------

    def user_item_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        return (np.asarray(self.inter[self.uid_field], dtype=np.int64),
                np.asarray(self.inter[self.iid_field], dtype=np.int64))

    def history_matrix(self) -> dict[int, np.ndarray]:
        """uid → the item ids it interacted with in this table."""
        users, items = self.user_item_arrays()
        order = np.argsort(users, kind="stable")
        u_sorted, i_sorted = users[order], items[order]
        bounds = np.searchsorted(u_sorted, np.arange(self.n_users + 1))
        return {u: i_sorted[bounds[u]:bounds[u + 1]]
                for u in range(self.n_users)
                if bounds[u + 1] > bounds[u]}


class GeneralGraphDataset(Dataset):
    """Adds bipartite-graph construction (reference: dataset.py:24-106)."""

    def get_norm_adj_graph(self, *, device: torch.device | str,
                           force_sparse: bool = False):
        """Symmetric GCN-normalised U-I adjacency on the lifted
        (n_users + n_items)² square graph, both directions, no self
        loops, on ``device``.

        The dense bipartite form is returned when the rectangular block
        fits ``dense_graph_max_entries`` (and ``enable_sparse`` is not
        True); otherwise a sparse :class:`Graph`, padded to the segment
        layout unless ``use_pallas_spmm`` is False, running with the
        config's ``sparse_spmm_impl`` / ``pallas_spmm_precision``."""
        users, items = self.user_item_arrays()
        n = self.n_users + self.n_items
        src = np.concatenate([users, items + self.n_users])
        dst = np.concatenate([items + self.n_users, users])
        deg = np.bincount(dst, minlength=n).astype(np.float64)
        dinv = np.where(deg > 0, 1.0 / np.sqrt(np.maximum(deg, 1e-12)), 0.0)
        w = dinv[src] * dinv[dst]

        max_entries = int(self.config.get("dense_graph_max_entries", 3e8))
        use_dense = (not force_sparse
                     and self.config["enable_sparse"] is not True
                     and self.n_users * self.n_items <= max_entries)
        if use_dense:
            half = len(users)
            dtype = (torch.bfloat16
                     if str(self.config["graph_dtype"]) == "bfloat16"
                     else torch.float32)
            return build_dense_bipartite(
                users, items, w[:half], self.n_users, self.n_items,
                device=device, dtype=dtype)
        if (self.config["graph_edge_sharding"] and not force_sparse
                and self.config["mesh_shape"]):
            # graph memory scaling: this rank's dst block of the edges as
            # an ELL layout pair, over the mesh axis
            # graph_edge_sharding_axis (parallel/sharded_spmm.py); not for
            # models that re-weight edges per step (force_sparse=True)
            from recbole_gnn_tpu_torch.parallel.mesh import (
                axis_group, axis_size, make_mesh)
            from recbole_gnn_tpu_torch.parallel.sharded_spmm import (
                build_sharded_ell)
            axis = str(self.config.or_default("graph_edge_sharding_axis",
                                              "dp"))
            mesh = make_mesh(self.config["mesh_shape"])
            return build_sharded_ell(src, dst, w, n, axis_size(mesh, axis),
                                     group=axis_group(mesh, axis),
                                     axis=axis, device=device)
        with_pallas = self.config["use_pallas_spmm"] is not False
        impl = str(self.config.get("sparse_spmm_impl", "ell"))
        # the ELL layouts only for an ell graph (the JAX package builds
        # them for every graph; nothing else reads them yet)
        return build_graph(src, dst, w, n, device=device,
                           with_pallas=with_pallas, impl=impl,
                           precision=str(self.config.get(
                               "pallas_spmm_precision", "f32x2")),
                           with_ell=impl == "ell")

    def inter_coo(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Raw (users, items, ones) COO of the rectangular interaction
        matrix, deduplicated."""
        users, items = self.user_item_arrays()
        key = users * self.n_items + items
        _, first = np.unique(key, return_index=True)
        return (users[first], items[first],
                np.ones(len(first), dtype=np.float32))


# the sequential datasets live in data/session.py; exported here, where
# the registry looks dataset classes up
from recbole_gnn_tpu_torch.data.session import (  # noqa: E402
    GCEGNNDataset, LESSRDataset, MultiBehaviorDataset, SequentialDataset,
    SessionGraphDataset)
from recbole_gnn_tpu_torch.data.social import SocialDataset  # noqa: E402

__all__ = ["Dataset", "GeneralGraphDataset", "SequentialDataset",
           "SessionGraphDataset", "LESSRDataset", "GCEGNNDataset",
           "MultiBehaviorDataset", "SocialDataset", "parse_interval"]
