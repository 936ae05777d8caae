"""The all-node InfoNCE denominator — ``lse[b] = logsumexp_j(q[b]·k[j]/τ)``
over every row of ``k``, and its gradient.

``models/losses.py::info_nce`` takes its logsumexp term here: SGL's
batch against every user and every item row of view 2, NCL's against
its previous layer's rows and its cluster centroids.  The JAX package
computes it with XLA (``recbole_gnn_tpu/models/losses.py::info_nce``,
through ``_chunked_lse`` above ``_NCE_CHUNK_ENTRIES`` entries), which is
what :func:`nce_lse_plain` does in torch: the (B, n) logits by a matmul,
then ``torch.logsumexp``, or the same over row chunks of ``k`` with each
chunk checkpointed.

On the card :func:`nce_lse` launches ``csrc/info_nce.cu`` through the
autograd function :class:`_NceLse`: a forward that streams ``k``
through shared memory and keeps a running max and sum for each row of
``q`` and the softmax-weighted sum of ``k``'s rows (``dv1`` up to a
scale), and a backward that recomputes the logits tile by tile and sums
each ``k`` row's gradient in registers (:func:`nce_lse_grad`).  No
(B, n) tensor is made.  Both split their work over the card's SMs by
the shapes they see (:func:`_plan`); every sum runs in a fixed order in
f32, so a rerun or a CUDA-graph replay repeats bit for bit.  The kernels
hold rows of up to :data:`MAX_D` floats, a multiple of 4; SGL and NCL
check their ``embedding_size`` against that when they are built on a
card (:func:`check_width`).
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable
from torch.utils.checkpoint import checkpoint

from recbole_gnn_tpu_torch.ops import cuda_build
from recbole_gnn_tpu_torch.utils import trace

# (B, n) logits above this many entries go through :func:`chunked_lse`
# in the plain version (the JAX package's threshold)
CHUNK_ENTRIES = 1 << 28
# what the kernel holds: rows of at most MAX_D floats, a multiple of 4,
# in tiles of TILE rows
MAX_D = 128
TILE = 128


def _chunk_lse(v1: torch.Tensor, c: torch.Tensor, tau: float
               ) -> torch.Tensor:
    return torch.logsumexp(torch.matmul(v1, c.T) / tau, dim=-1)


def chunked_lse(v1: torch.Tensor, av2: torch.Tensor, tau: float,
                chunk_entries: int = CHUNK_ENTRIES) -> torch.Tensor:
    """logsumexp of v1 @ av2ᵀ / tau over row chunks of ``av2``, as the
    JAX package's ``_chunked_lse`` chunks it (at least 1,024 rows, about
    ``chunk_entries`` entries per block): each chunk's logsumexp is
    checkpointed, so the backward recomputes its block instead of
    keeping every one, and the chunks combine by one more logsumexp."""
    b, n = v1.shape[0], av2.shape[0]
    rows = min(max(1024, chunk_entries // max(1, b)), n)
    parts = [checkpoint(_chunk_lse, v1, av2[lo:lo + rows], tau,
                        use_reentrant=False)
             for lo in range(0, n, rows)]
    return torch.logsumexp(torch.stack(parts, dim=-1), dim=-1)


def nce_lse_plain(v1: torch.Tensor, av2: torch.Tensor, tau: float,
                  chunk_entries: int = CHUNK_ENTRIES) -> torch.Tensor:
    """The plain version: ``logsumexp(v1 @ av2ᵀ / tau)`` by rows, through
    :func:`chunked_lse` when the logits would hold more than
    ``chunk_entries`` entries."""
    if v1.shape[0] * av2.shape[0] > chunk_entries:
        return chunked_lse(v1, av2, tau, chunk_entries)
    return _chunk_lse(v1, av2, tau)


def nce_lse(v1: torch.Tensor, av2: torch.Tensor, tau: float
            ) -> torch.Tensor:
    """(B,) ``logsumexp_j(v1[b]·av2[j] / tau)``, differentiable in both.

    CUDA tensors launch the kernels (``v1`` (B, d) and ``av2`` (n, d)
    f32, contiguous, 16-byte aligned, on one card, d a multiple of 4 up
    to :data:`MAX_D`; any other input raises), counting ``nce_kernel``
    under the innermost open span (``utils/trace.py``).  CPU tensors run
    :func:`nce_lse_plain`.  ``nce_lse.launches`` counts the forward
    calls that launched the kernels, ``nce_lse_grad.launches`` the
    backward calls."""
    if v1.device.type == "cpu":
        return nce_lse_plain(v1, av2, tau)
    if v1.device.type != "cuda":
        raise ValueError(f"nce_lse: unsupported device {v1.device}")
    _check(v1, av2, tau)
    return _NceLse.apply(v1, av2, float(tau))


nce_lse.launches = 0


def check_width(d: int, owner: str = "nce_lse") -> None:
    """Raises unless the kernels take rows of ``d`` floats: a multiple
    of 4 up to :data:`MAX_D` (``owner`` names the caller in the
    message)."""
    if d % 4 or not 0 < d <= MAX_D:
        raise ValueError(
            f"{owner}: the InfoNCE kernel on the card takes rows of 4 to "
            f"{MAX_D} floats, a multiple of 4; got {d}")


def _check(v1: torch.Tensor, av2: torch.Tensor, tau: float) -> None:
    cuda_build.check_tensors("nce_lse", v1.device, (
        ("v1", v1, torch.float32, 2), ("av2", av2, torch.float32, 2)))
    d = v1.shape[1]
    if av2.shape[1] != d:
        raise ValueError(f"nce_lse: v1 has rows of {d}, av2 of "
                         f"{av2.shape[1]}")
    check_width(d)
    if v1.shape[0] == 0 or av2.shape[0] == 0:
        raise ValueError("nce_lse: v1 and av2 need at least one row")
    for name, t in (("v1", v1), ("av2", av2)):
        if t.data_ptr() % 16:
            raise ValueError(f"nce_lse: {name} must be 16-byte aligned")
    if not tau > 0:
        raise ValueError(f"nce_lse: tau must be positive, got {tau}")


@functools.lru_cache(maxsize=None)
def _plan(stationary: int, streamed: int, sms: int) -> tuple[int, int]:
    """(splits, tiles a split) of the ``streamed`` tiles for a grid of
    ``stationary`` × splits blocks, one block an SM at a time: the fewest
    waves of blocks times the tiles each streams (plus half a tile for
    its set-up), fewer splits on a tie.  Every split gets a tile."""
    best = None
    for want in range(1, streamed + 1):
        per = -(-streamed // want)
        splits = -(-streamed // per)
        waves = -(-stationary * splits // sms)
        cost = waves * (2 * per + 1)
        if best is None or cost < best[0]:
            best = (cost, splits, per)
    return best[1], best[2]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _tiles(rows: int) -> int:
    return -(-rows // TILE)


class _NceLse(torch.autograd.Function):

    @staticmethod
    def forward(ctx, v1, av2, tau):
        b, n, d = v1.shape[0], av2.shape[0], v1.shape[1]
        splits, per = _plan(_tiles(b), _tiles(n), _sm_count(v1.device.index))
        f32 = dict(dtype=torch.float32, device=v1.device)
        part_m, part_l = (torch.empty((splits, b), **f32) for _ in range(2))
        part_o = torch.empty((splits, b, d), **f32)
        lse, lse2 = (torch.empty(b, **f32) for _ in range(2))
        o = torch.empty((b, d), **f32)
        lib = _library()
        with torch.cuda.device(v1.device):
            stream = torch.cuda.current_stream(v1.device).cuda_stream
            rc = lib.nce_forward_launch(
                v1.data_ptr(), av2.data_ptr(), b, n, d, tau, splits, per,
                part_m.data_ptr(), part_l.data_ptr(), part_o.data_ptr(),
                lse.data_ptr(), lse2.data_ptr(), o.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"nce_lse launch failed: CUDA error {rc}")
        nce_lse.launches += 1
        trace.count("nce_kernel", 1)
        ctx.save_for_backward(v1, av2, lse2, o)
        ctx.tau = tau
        return lse

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        v1, av2, lse2, o = ctx.saved_tensors
        return (*nce_lse_grad(v1, av2, lse2, o, g, ctx.tau), None)


def nce_lse_grad(v1: torch.Tensor, av2: torch.Tensor, lse2: torch.Tensor,
                 o: torch.Tensor, g: torch.Tensor, tau: float
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The backward launch of :class:`_NceLse`: (dv1, dav2) from the
    cotangent ``g`` (B,) and the forward's ``lse2`` (lse in log2 units)
    and ``o`` (the softmax-weighted rows of ``av2``).
    ``nce_lse_grad.launches`` counts its calls."""
    g = g.to(torch.float32).contiguous()
    b, n, d = v1.shape[0], av2.shape[0], v1.shape[1]
    splits, per = _plan(_tiles(n), _tiles(b), _sm_count(v1.device.index))
    dq = torch.empty_like(v1)
    dk = torch.empty_like(av2)
    part = (torch.empty((splits, n, d), dtype=torch.float32,
                        device=v1.device) if splits > 1 else None)
    lib = _library()
    with torch.cuda.device(v1.device):
        stream = torch.cuda.current_stream(v1.device).cuda_stream
        rc = lib.nce_backward_launch(
            v1.data_ptr(), av2.data_ptr(), lse2.data_ptr(), o.data_ptr(),
            g.data_ptr(), b, n, d, tau, splits, per,
            None if part is None else part.data_ptr(), dk.data_ptr(),
            dq.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"nce_lse backward launch failed: CUDA error "
                           f"{rc}")
    nce_lse_grad.launches += 1
    return dq, dk


nce_lse_grad.launches = 0


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("info_nce")
    fwd, bwd = lib.nce_forward_launch, lib.nce_backward_launch
    if fwd.argtypes is None:
        vp, ll, i, f64 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                          ctypes.c_double)
        fwd.argtypes = [vp, vp, ll, ll, i, f64, i, i, vp, vp, vp, vp, vp, vp,
                        vp]
        fwd.restype = ctypes.c_int
        bwd.argtypes = [vp, vp, vp, vp, vp, ll, ll, i, f64, i, i, vp, vp, vp,
                        vp]
        bwd.restype = ctypes.c_int
    return lib
