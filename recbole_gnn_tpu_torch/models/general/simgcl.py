"""SimGCL — LightGCN with per-layer random noise as contrastive views.

Port of ``recbole_gnn_tpu/models/general/simgcl.py``.  The forward adds
sign(e)·ε·u/‖u‖ to each layer's output when perturbed, u uniform on
[0, 1); the layer mean leaves out layer 0.  The loss is LightGCN's BPR
+ reg on the unperturbed forward plus λ·InfoNCE between two perturbed
forwards over the batch's unique users and items, sum-reduced.  On a
sparse graph a training step runs 3·K forward SpMMs and 3·K transpose
SpMMs.

The noise comes from ``torch.rand`` on a generator derived from the
trainer's (``models.base.device_generator``); the JAX package draws it
from ``jax.random.split`` of the step key, so the numbers differ.  The
tests pass the JAX draws in through ``noise``.
"""

from __future__ import annotations

import torch

from recbole_gnn_tpu_torch.models.base import device_generator
from recbole_gnn_tpu_torch.models.general.lightgcn import LightGCN
from recbole_gnn_tpu_torch.models.losses import cl_nce_masked, masked_unique
from recbole_gnn_tpu_torch.ops.spmm import spmm_any


def perturb(x: torch.Tensor, eps: float, rng: torch.Generator | None,
            noise: torch.Tensor | None) -> torch.Tensor:
    """x + sign(x)·ε·u/max(‖u‖, 1e-12) per row, u = ``noise`` or
    ``torch.rand`` of x's shape from ``rng``."""
    u = (torch.rand(x.shape, generator=rng, device=x.device)
         if noise is None else noise)
    u = u / torch.clamp(torch.linalg.vector_norm(u, dim=-1, keepdim=True),
                        min=1e-12)
    return x + torch.sign(x) * u * eps


class SimGCL(LightGCN):

    def __init__(self, config, dataset, device=None):
        super().__init__(config, dataset, device)
        self.cl_rate = float(config.get("lambda", 0.5))
        self.eps = float(config.get("eps", 0.1))
        self.temperature = float(config.get("temperature", 0.2))

    def _forward_noise(self, params, consts, rng, perturbed: bool,
                       noise: list | None = None):
        """(users, items) of the layer mean over layers 1..K; perturbed,
        each layer takes ``noise[k]`` or a draw from ``rng``."""
        x = torch.cat([params["user_emb"], params["item_emb"]], dim=0)
        outs = []
        for k in range(self.n_layers):
            x = spmm_any(consts["graph"], x)
            if perturbed:
                x = perturb(x, self.eps, rng,
                            None if noise is None else noise[k])
            outs.append(x)
        final = torch.stack(outs, dim=0).mean(dim=0)
        return final[:self.n_users], final[self.n_users:]

    def propagate(self, params, consts, extras):
        # the evaluation's forward: unperturbed, layer 0 still left out
        return self._forward_noise(params, consts, None, False)

    def calculate_loss(self, params, consts, extras, batch, rng, mode=0,
                       noise: tuple | None = None):
        """``noise``: the two views' per-layer noise lists, drawn from
        ``rng`` when not given."""
        base, aux = super().calculate_loss(params, consts, extras, batch, rng)
        gen = None if noise is not None else device_generator(rng,
                                                              self.device)
        n1, n2 = noise if noise is not None else (None, None)
        u1, i1 = self._forward_noise(params, consts, gen, True, n1)
        u2, i2 = self._forward_noise(params, consts, gen, True, n2)
        uu, umask = masked_unique(batch["user_id"])
        ii, imask = masked_unique(batch["item_id"])
        cl = (cl_nce_masked(u1[uu], u2[uu], self.temperature, umask, "sum")
              + cl_nce_masked(i1[ii], i2[ii], self.temperature, imask,
                              "sum"))
        aux["cl"] = cl
        return base + self.cl_rate * cl, aux
