"""Bucketed-ELL SpMM — the port's K2 (``sparse_spmm_impl: ell``).

Counterpart of ``recbole_gnn_tpu/ops/ell_spmm.py``.  Both compute

    out[d] = Σ_{e: dst[e]=d} w[e] · x[src[e]]

over a layout built once on the host (:func:`build_ell`, a copy of the
JAX package's numpy code, so every array equals the JAX one element
for element): nodes are bucketed by in-degree into at most
``MAX_BUCKETS`` widths K (picked by a small DP, :func:`_bucket_grid`);
each node's edge list is padded to its bucket's K with weight-0 slots
on source row 0; a node of degree above ``K_CAP`` is split into several
virtual rows; ``node_src`` gives every node its row of the pool
[bucket outputs; the sums of the split nodes; one zero row].

The JAX package computes it with XLA ops (a gather and an ``einsum`` per
bucket, a segment sum over the split nodes, one gather through
``node_src``), which is what :func:`ell_spmm_plain` does in torch, the
bucket chunking by ``BUCKET_BYTES_BUDGET`` included.  On the card
:func:`ell_spmm` launches ``csrc/ell_spmm.cu``: one pass over every
virtual row of every bucket that writes a single-row node's output row
directly and a split node's rows to a small workspace, then a pass that
sums each split node's rows in order and writes 0 for an isolated node.
No ``(E_pad, D)`` message array is made.  The kernel gathers the pad
slots too (weight 0 on row 0: each adds ±0 for a finite ``x[0]``), so
its rows equal the sums of their real slots, which
:func:`ell_spmm_pad_free_plain` computes from ``vlen`` alone.

The layout keeps its buckets in flat buffers (``idx``, ``w``, ``epos``,
bucket after bucket, each row-major ``(n_b, K_b)``); :attr:`EllMeta.idxs`,
``.ws`` and ``.eposs`` give back the per-bucket views of the JAX
``EllMeta``.  Beside them it holds what the kernel reads: ``vdst`` (per
virtual row: its node, or ``-(1 + j)`` for row ``j`` of the split-node
workspace) and the ``rest`` list (split and isolated nodes); ``vlen``
counts each virtual row's real slots.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from recbole_gnn_tpu_torch.ops import cuda_build

# nodes with degree > K_CAP are split into ceil(deg/K) virtual rows
K_CAP = 256
# max number of degree buckets (the JAX package's; the CUDA kernel
# takes up to MAX_KERNEL_BUCKETS)
MAX_BUCKETS = 12
MAX_KERNEL_BUCKETS = 32
# sub-8 bucket widths the DP may use for the lowest-degree groups
_K_SMALL = (1, 2, 4)
# per-bucket gathered-message budget of the plain version: a bucket whose
# (rows·K·D·4) message block would exceed it is summed in row chunks
BUCKET_BYTES_BUDGET = 1 << 31   # 2 GB


@dataclass
class EllMeta:
    """Bucketed-ELL layout, on one device.

    Attributes:
      idx / w: (E_pad,) int32 source node / float32 weight per slot,
        bucket after bucket, each bucket row-major (n_b, K_b).
      ks / rows: per-bucket width K_b and virtual-row count n_b.
      node_src: (n_nodes,) int32 — pool row per output node (the JAX
        package's combine plan).
      mgidx / msegs: (n_multi_vrows,) int32 | None — concat positions
        of the virtual rows of split nodes, grouped by node, and their
        0..n_multi−1 node ids.
      n_nodes: output rows; n_multi: nodes split into > 1 virtual row.
      n_in: rows of ``x`` the layout reads (1 + its largest source id).
      vdst: (n_vrows,) int32 — where the kernel writes each virtual
        row: its node, or ``-(1 + j)`` for workspace row j (split nodes).
      vlen: (n_vrows,) int32 — each virtual row's real slots (1..K_b),
        which come first in the row; the rest are pad slots (idx 0,
        w 0, epos one past the last edge).  Sums to the edge count.
      rest_node / rest_start / rest_count: (n_rest,) int32 — the nodes
        the kernel's second pass writes: split nodes (their workspace
        rows [start, start + count)) and isolated nodes (count 0).
      epos: (E_pad,) int32 | None — per-slot edge id into the graph's
        canonical dst-sorted edge array (pad slots: one past the end),
        for :func:`ell_reweight`.
      launch: the kernel's arguments that come from the layout alone,
        checked and made at its first launch (:func:`_layout_args`).
    """

    idx: torch.Tensor
    w: torch.Tensor
    ks: tuple
    rows: tuple
    node_src: torch.Tensor
    mgidx: torch.Tensor | None
    msegs: torch.Tensor | None
    n_nodes: int
    n_multi: int
    n_in: int
    vdst: torch.Tensor
    vlen: torch.Tensor
    rest_node: torch.Tensor
    rest_start: torch.Tensor
    rest_count: torch.Tensor
    epos: torch.Tensor | None = None
    launch: tuple | None = field(default=None, repr=False, compare=False)

    def _views(self, flat: torch.Tensor) -> tuple:
        out, off = [], 0
        for k, n in zip(self.ks, self.rows):
            out.append(flat[off:off + n * k].view(n, k))
            off += n * k
        return tuple(out)

    @property
    def idxs(self) -> tuple:
        return self._views(self.idx)

    @property
    def ws(self) -> tuple:
        return self._views(self.w)

    @property
    def vlens(self) -> tuple:
        """Per bucket, its rows' real-slot counts, (n_b,) each."""
        return tuple(torch.split(self.vlen, list(self.rows)))

    @property
    def eposs(self) -> tuple | None:
        return None if self.epos is None else self._views(self.epos)

    @property
    def e_padded(self) -> int:
        return int(self.idx.shape[0])

    @property
    def n_vrows(self) -> int:
        return int(sum(self.rows))

    @property
    def n_multi_vrows(self) -> int:
        return 0 if self.mgidx is None else int(self.mgidx.shape[0])


def _bucket_grid(per_vrow: np.ndarray, k_cap: int,
                 max_buckets: int = MAX_BUCKETS) -> np.ndarray:
    """DP-optimal degree→bucket-K mapping: partition the occupied
    capped-degree values into ≤ max_buckets groups (group K = its max
    degree, rounded up to a multiple of 8 or to a ``_K_SMALL`` width)
    minimizing total padding Σ nodes·(K − deg).  Returns bucket_of[d]
    for d in 0..k_cap."""
    vals, counts = np.unique(per_vrow, return_counts=True)
    m = len(vals)
    if m == 0:
        return np.zeros(k_cap + 1, np.int64)
    b_max = min(max_buckets, m)
    # prefix sums for group cost: cost(i..j) = Σ c_t·(v_j − v_t)
    csum = np.concatenate([[0], np.cumsum(counts)])
    cvsum = np.concatenate([[0], np.cumsum(counts * vals)])

    def kof(j):
        v = int(vals[j])
        if _K_SMALL:
            ladder = ((_K_SMALL,) if isinstance(_K_SMALL, int)
                      else tuple(_K_SMALL))
            for s in sorted(ladder):
                if v <= s:
                    return s
        return -(-v // 8) * 8

    def gcost(i, j):   # values i..j inclusive into one bucket
        return kof(j) * (csum[j + 1] - csum[i]) - (cvsum[j + 1] - cvsum[i])

    INF = float("inf")
    dp = np.full((b_max + 1, m), INF)
    parent = np.full((b_max + 1, m), -1, np.int64)
    for j in range(m):
        dp[1, j] = gcost(0, j)
    for b in range(2, b_max + 1):
        for j in range(b - 1, m):
            best, arg = INF, -1
            for i in range(b - 2, j):
                c = dp[b - 1, i] + gcost(i + 1, j)
                if c < best:
                    best, arg = c, i
            dp[b, j] = best
            parent[b, j] = arg
    best_b = int(np.argmin(dp[1:, m - 1])) + 1
    # walk back the group boundaries; each group's K = its max degree
    ks = []
    j, b = m - 1, best_b
    while j >= 0:
        ks.append(kof(j))
        j = int(parent[b, j]) if b > 1 else -1
        b -= 1
    ks = np.unique(np.array(ks, np.int64))
    # bucket of degree d = smallest group K ≥ d
    d = np.arange(k_cap + 1)
    bucket_of = ks[np.minimum(np.searchsorted(ks, d), len(ks) - 1)]
    return bucket_of


def build_ell(src_sorted: np.ndarray, dst_sorted: np.ndarray,
              w_sorted: np.ndarray, n_nodes: int,
              k_cap: int = K_CAP,
              max_buckets: int = MAX_BUCKETS,
              with_epos: bool = False,
              edge_ids: np.ndarray | None = None, *,
              device: torch.device | str = "cpu") -> EllMeta:
    """Host-side layout build from a dst-sorted COO triple, on
    ``device``.  With ``with_epos`` each slot also records its edge id
    (``edge_ids`` translates positions in this call's ordering to the
    caller's canonical edge ids — used by the transpose layout), for
    :func:`ell_reweight`."""
    src_sorted = np.asarray(src_sorted, np.int32)
    dst_sorted = np.asarray(dst_sorted, np.int64)
    w_sorted = np.asarray(w_sorted, np.float32)
    deg = np.bincount(dst_sorted, minlength=n_nodes)
    rowptr = np.zeros(n_nodes + 1, np.int64)
    np.cumsum(deg, out=rowptr[1:])
    # per-node bucket K: DP-chosen grid over capped degrees
    per_vrow = np.minimum(np.maximum(deg, 1), k_cap)
    bucket_of = _bucket_grid(per_vrow[deg > 0], k_cap, max_buckets)
    kb = np.maximum(bucket_of[per_vrow], 1)
    n_vrows = -(-deg // kb)      # 0 for isolated nodes

    n_edges = len(src_sorted)
    idxs, ws, vnodes, vlens, eposs = [], [], [], [], []
    for K in np.unique(kb[deg > 0]):
        sel = np.where((kb == K) & (deg > 0))[0]
        vr = n_vrows[sel]
        tot = int(vr.sum())
        idx = np.zeros((tot, K), np.int32)
        ww = np.zeros((tot, K), np.float32)
        vnode = np.repeat(sel, vr).astype(np.int32)
        # edge range of each virtual row: node start + vrow_index·K
        starts = np.repeat(rowptr[sel], vr) + (
            np.arange(tot) - np.repeat(np.cumsum(vr) - vr, vr)) * K
        ends = np.minimum(starts + K, np.repeat(rowptr[sel + 1], vr))
        lens = (ends - starts).astype(np.int64)
        rows = np.repeat(np.arange(tot), lens)
        cols = np.arange(int(lens.sum())) - np.repeat(
            np.cumsum(lens) - lens, lens)
        epos = np.repeat(starts, lens) + cols
        idx[rows, cols] = src_sorted[epos]
        ww[rows, cols] = w_sorted[epos]
        idxs.append(idx)
        ws.append(ww)
        vnodes.append(vnode)
        vlens.append(lens)
        if with_epos:
            # pad slots point one past the last edge (ell_reweight
            # appends a 0 there)
            ep = np.full((tot, K), n_edges, np.int32)
            canon = (edge_ids[epos] if edge_ids is not None
                     else epos.astype(np.int64))
            ep[rows, cols] = canon.astype(np.int32)
            eposs.append(ep)

    if vnodes:
        vnode_all = np.concatenate(vnodes)
    else:   # empty graph
        vnode_all = np.zeros((0,), np.int32)
    # combine plan: single-vrow nodes (deg ≤ K_CAP) read their bucket
    # output row directly; multi-vrow nodes (deg > K_CAP — rare) get a
    # tiny segment-sum; isolated nodes read the appended zero row
    order = np.argsort(vnode_all, kind="stable")
    n_vr_total = len(vnode_all)
    counts = n_vrows                      # per-node vrow count (0 = isolated)
    starts = np.cumsum(counts) - counts   # node's first vrow in sorted order
    single = counts == 1
    multi = counts > 1
    n_multi = int(multi.sum())
    node_src = np.full(n_nodes, n_vr_total + n_multi, np.int64)  # zero row
    node_src[single] = order[starts[single]]
    node_src[multi] = n_vr_total + np.arange(n_multi)
    mgidx = msegs = None
    if n_multi:
        mcounts = counts[multi]
        total_m = int(mcounts.sum())
        off = np.arange(total_m) - np.repeat(
            np.cumsum(mcounts) - mcounts, mcounts)
        mpos_sorted = np.repeat(starts[multi], mcounts) + off
        mgidx = order[mpos_sorted].astype(np.int32)
        msegs = np.repeat(np.arange(n_multi), mcounts).astype(np.int32)

    # the kernel's plan: where each virtual row goes, and which nodes the
    # second pass writes (split nodes from the workspace, isolated as 0)
    vdst = vnode_all.astype(np.int32)
    rest = np.where(counts != 1)[0]
    rest_count = counts[rest]
    rest_start = np.cumsum(rest_count) - rest_count
    if n_multi:
        vdst[mgidx] = -1 - np.arange(len(mgidx), dtype=np.int32)

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    cat = lambda parts, dtype: (np.concatenate([p.reshape(-1) for p in parts])
                                if parts else np.zeros(0, dtype))
    return EllMeta(
        idx=t(cat(idxs, np.int32)), w=t(cat(ws, np.float32)),
        ks=tuple(int(a.shape[1]) for a in idxs),
        rows=tuple(int(a.shape[0]) for a in idxs),
        node_src=t(node_src.astype(np.int32)),
        mgidx=None if mgidx is None else t(mgidx),
        msegs=None if msegs is None else t(msegs),
        n_nodes=int(n_nodes), n_multi=n_multi,
        n_in=int(src_sorted.max()) + 1 if n_edges else 0,
        vdst=t(vdst), vlen=t(cat(vlens, np.int32).astype(np.int32)),
        rest_node=t(rest.astype(np.int32)),
        rest_start=t(rest_start.astype(np.int32)),
        rest_count=t(rest_count.astype(np.int32)),
        epos=t(cat(eposs, np.int32)) if with_epos else None)


def reweight_ws(meta: EllMeta, weight: torch.Tensor) -> tuple:
    """The per-bucket slot weights regathered from ``weight`` (the
    graph's canonical dst-sorted edge weights), as the JAX package's
    tuple of (n_b, K_b) arrays — the piece models keep in their extras
    per epoch."""
    if meta.epos is None:
        raise ValueError("build_ell(..., with_epos=True) first")
    wpad = torch.cat([weight.to(torch.float32),
                      weight.new_zeros(1, dtype=torch.float32)])
    return meta._views(wpad[meta.epos.long()])


def with_ws(meta: EllMeta, ws: tuple) -> EllMeta:
    """EllMeta with replaced slot weights (per-bucket shapes must
    match)."""
    if len(ws) != len(meta.ks) or any(
            tuple(a.shape) != (n, k) for a, k, n in zip(ws, meta.ks,
                                                       meta.rows)):
        raise ValueError("with_ws: slot weights do not match the layout's "
                         "buckets")
    flat = (torch.cat([a.reshape(-1) for a in ws]) if ws
            else meta.w.new_zeros(0))
    return replace(meta, w=flat.to(torch.float32).contiguous(), launch=None)


def ell_reweight(meta: EllMeta, weight: torch.Tensor) -> EllMeta:
    """New EllMeta whose slot weights come from ``weight`` (the graph's
    canonical dst-sorted edge-weight array); the layout must carry
    ``epos``."""
    return with_ws(meta, reweight_ws(meta, weight))


def ell_spmm_plain(meta: EllMeta, x: torch.Tensor) -> torch.Tensor:
    """The plain version, as the JAX package's ``ell_spmm``: per bucket
    an ``index_select`` and an ``einsum`` over the slot axis
    (:func:`bucket_gather_sum`), the split nodes' virtual rows summed by
    ``index_add_``, then one gather through ``node_src``.  A bf16 ``x``
    gives a bf16 output: its terms are the exact f32 products of x and
    the slot weights rounded to bf16 (``w.astype(x.dtype)``), summed in
    f32 and rounded once (:func:`_bf16_as_f32`)."""
    if x.dtype == torch.bfloat16:
        return _bf16_as_f32(ell_spmm_plain, meta, x)
    d = x.shape[-1]
    outs = [bucket_gather_sum(x, idx, w, d)
            for idx, w in zip(meta.idxs, meta.ws)]
    if not outs:
        return x.new_zeros((meta.n_nodes, d))
    pool = outs
    if meta.n_multi:
        vr = torch.cat(outs, dim=0)
        msums = x.new_zeros((meta.n_multi, d)).index_add_(
            0, meta.msegs, vr.index_select(0, meta.mgidx))
        pool = [vr, msums]
    pool = pool + [x.new_zeros((1, d))]
    return torch.cat(pool, dim=0).index_select(0, meta.node_src)


def _bf16_as_f32(plain, meta: EllMeta, x: torch.Tensor) -> torch.Tensor:
    """``plain`` on a bf16 ``x`` as the kernel computes it: x widened to
    f32 (exact), the slot weights rounded to bf16, the f32 result
    rounded to bf16 once."""
    w = meta.w.to(torch.bfloat16).to(torch.float32)
    return plain(replace(meta, w=w, launch=None),
                 x.to(torch.float32)).to(torch.bfloat16)


def bucket_gather_sum(x: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                      d: int) -> torch.Tensor:
    """One bucket's gather + weighted slot sum, in row chunks when its
    (n_b, K, D) message block would exceed BUCKET_BYTES_BUDGET."""
    n_b, k = idx.shape
    if n_b * k * d * 4 <= BUCKET_BYTES_BUDGET:
        return _bucket_sum(x, idx, w, d)
    rows_per = max(1, BUCKET_BYTES_BUDGET // (k * d * 4))
    return torch.cat([_bucket_sum(x, idx[lo:lo + rows_per],
                                  w[lo:lo + rows_per], d)
                      for lo in range(0, n_b, rows_per)], dim=0)


def _bucket_sum(x, idx, w, d):
    n_b, k = idx.shape
    g = x.index_select(0, idx.reshape(-1)).reshape(n_b, k, d)
    return torch.einsum("nkd,nk->nd", g, w.to(x.dtype))


def ell_spmm_pad_free_plain(meta: EllMeta, x: torch.Tensor
                            ) -> torch.Tensor:
    """A second plain version, which ``chip_smoke.py`` and the tests
    hold the kernel against beside :func:`ell_spmm_plain`: per bucket
    only the first ``vlen`` slots of each virtual row (its real edges)
    are gathered and summed in slot order, and a row that has pad slots
    adds ``0 · x[0]`` once (0 for a finite ``x[0]``, NaN where it is
    not, as the einsum over every slot gives); each virtual row goes
    where ``vdst`` says, and the combine plan sums a split node's
    workspace rows in row order and writes 0 for an isolated node.  A
    bf16 ``x`` as in :func:`ell_spmm_plain`."""
    if x.dtype == torch.bfloat16:
        return _bf16_as_f32(ell_spmm_pad_free_plain, meta, x)
    d = x.shape[-1]
    out = x.new_zeros((meta.n_nodes, d))
    if not meta.ks:
        return out
    vrs = []
    for idx, w, vl in zip(meta.idxs, meta.ws, meta.vlens):
        n_b, k = idx.shape
        real = torch.arange(k, device=idx.device) < vl[:, None].long()
        r, c = real.nonzero(as_tuple=True)      # row-major: slot order
        terms = x.index_select(0, idx[r, c]) * w[r, c, None].to(x.dtype)
        vr = x.new_zeros((n_b, d)).index_add_(0, r, terms)
        padded = vl < k
        vr[padded] += 0 * x[0]
        vrs.append(vr)
    vr = torch.cat(vrs)
    single = meta.vdst >= 0
    out[meta.vdst[single].long()] = vr[single]
    ws = x.new_empty((meta.n_multi_vrows, d))
    ws[(-1 - meta.vdst[~single]).long()] = vr[~single]
    counts = meta.rest_count.long()
    seg = torch.repeat_interleave(
        torch.arange(counts.numel(), device=counts.device), counts)
    rows = (torch.repeat_interleave(meta.rest_start.long(), counts)
            + torch.arange(seg.numel(), device=counts.device)
            - torch.repeat_interleave(torch.cumsum(counts, 0) - counts,
                                      counts))
    sums = x.new_zeros((counts.numel(), d)).index_add_(
        0, seg, ws.index_select(0, rows))
    out[meta.rest_node.long()] = sums
    return out


_LAYOUT_TENSORS = ("idx", "w", "vdst", "rest_node", "rest_start",
                   "rest_count")


def _layout_args(meta: EllMeta, device: torch.device) -> tuple:
    """The layout's part of the kernel's arguments: the pointers of its
    int32/f32 arrays (checked: on ``device``, their types, 1-D,
    contiguous), the rest list's length and the bucket table as C
    arrays.  Made at the layout's first launch and kept on it, keyed by
    the device and the array objects themselves, so the per-call host
    time pays none of it again."""
    tensors = tuple(getattr(meta, n) for n in _LAYOUT_TENSORS)
    if (meta.launch is not None and meta.launch[0] == device
            and all(a is b for a, b in zip(meta.launch[1], tensors))):
        return meta.launch[2]
    cuda_build.check_tensors("ell_spmm", device, [
        (n, t, torch.float32 if n == "w" else torch.int32, 1)
        for n, t in zip(_LAYOUT_TENSORS, tensors)])
    nb = len(meta.ks)
    if nb > MAX_KERNEL_BUCKETS:
        raise ValueError(f"ell_spmm: the kernel takes at most "
                         f"{MAX_KERNEL_BUCKETS} buckets, the layout has {nb}")
    table = ctypes.c_longlong * max(nb, 1)
    args = (*(t.data_ptr() for t in tensors), meta.rest_node.shape[0],
            table(*meta.ks), table(*meta.rows), nb)
    meta.launch = (device, tensors, args)
    _layout_args.builds += 1
    return args


_layout_args.builds = 0


def ell_spmm(meta: EllMeta, x: torch.Tensor) -> torch.Tensor:
    """out[d] = Σ_{e: dst[e]=d} w[e]·x[src[e]] over the layout →
    (meta.n_nodes, D).

    A CUDA ``x`` launches the kernel (f32 or bf16 ``x`` contiguous on
    the layout's card, read as it is; any other input raises): a row
    pass over every bucket and, when the layout has split or isolated
    nodes, a combine pass, over an f32 workspace of one D-wide row per
    virtual row of a split node.  The output has x's dtype; a bf16 x's
    terms use the slot weights rounded to bf16 and are summed in f32
    (:func:`ell_spmm_plain`).  A CPU ``x`` runs :func:`ell_spmm_plain`.
    ``ell_spmm.launches`` counts kernel launches."""
    if x.device.type == "cpu":
        return ell_spmm_plain(meta, x)
    if x.device.type != "cuda":
        raise ValueError(f"ell_spmm: unsupported device {x.device}")
    out = _ell_spmm_cuda(meta, x)
    if out.numel():                 # an empty output launches nothing
        ell_spmm.launches += 1
    return out


ell_spmm.launches = 0


def ell_spmm_transpose(rev_meta: EllMeta, g: torch.Tensor) -> torch.Tensor:
    """The transpose SpMM, dL/dx of :func:`ell_spmm` over the forward
    layout: :func:`ell_spmm` over the graph's transpose layout, on ``g``
    made contiguous.  ``ell_spmm_transpose.launches`` counts the
    launches made here; ``ell_spmm.launches`` counts them too."""
    before = ell_spmm.launches
    out = ell_spmm(rev_meta, g.contiguous())
    ell_spmm_transpose.launches += ell_spmm.launches - before
    return out


ell_spmm_transpose.launches = 0


def _ell_spmm_cuda(meta: EllMeta, x: torch.Tensor) -> torch.Tensor:
    cuda_build.check_row_dtype("ell_spmm", "x", x)
    cuda_build.check_tensors("ell_spmm", x.device,
                             (("x", x, x.dtype, 2),))
    if x.shape[0] < meta.n_in:
        raise ValueError(f"ell_spmm: the layout reads {meta.n_in} rows of x, "
                         f"x has {x.shape[0]}")
    idx, w, vdst, rest_node, rest_start, rest_count, n_rest, ks, rows, nb = \
        _layout_args(meta, x.device)
    d = x.shape[1]
    out = torch.empty((meta.n_nodes, d), dtype=x.dtype, device=x.device)
    if meta.n_nodes == 0 or d == 0:
        return out
    # the split nodes' rows; the kernel writes none when there are none
    ws = (torch.empty((meta.n_multi_vrows, d), dtype=torch.float32,
                      device=x.device) if meta.n_multi_vrows else None)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.ell_spmm_launch(
            x.data_ptr(), idx, w, vdst, out.data_ptr(),
            None if ws is None else ws.data_ptr(), rest_node, rest_start,
            rest_count, n_rest, ks, rows, nb, d, cuda_build.vec_width(x),
            int(x.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"ell_spmm launch failed: CUDA error {rc}")
    return out


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("ell_spmm")
    fn = lib.ell_spmm_launch
    if fn.argtypes is None:
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        llp = ctypes.POINTER(ctypes.c_longlong)
        fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, vp, ll, llp, llp, i,
                       i, i, i, vp]
        fn.restype = ctypes.c_int
    return lib
