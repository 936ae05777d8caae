"""Abstract recommenders — the model contract.

Port of ``recbole_gnn_tpu/models/base.py`` (``BaseRecommender``,
``GeneralGraphRecommender``, ``SocialRecommender``,
``SequentialRecommender``), keeping its
functional contract:

  * a model *object* holds only static hyperparameters and ``device``;
  * graph constants live in ``self.consts`` (tensors on ``device``);
  * params and mutable non-parameter state (``extras``) are plain
    dicts of tensors passed in explicitly, so the same numpy arrays
    feed both packages (``train/checkpoint.py::params_from_numpy``);
  * ``calculate_loss`` is a function of (params, consts, extras, batch,
    rng) → (loss, aux-dict); the trainer differentiates it with
    ``torch.autograd.grad``.  ``rng`` is a ``torch.Generator`` (the
    counterpart of the JAX package's per-step key).
"""

from __future__ import annotations

from typing import Any

import torch

from recbole_gnn_tpu_torch.models.losses import cross_entropy
from recbole_gnn_tpu_torch.quick_start import resolve_device
from recbole_gnn_tpu_torch.utils.enums import InputType, ModelType

Params = dict[str, torch.Tensor]
Consts = dict[str, Any]
Extras = dict[str, Any]
Batch = dict[str, torch.Tensor]


def device_generator(rng: torch.Generator,
                     device: torch.device) -> torch.Generator:
    """A generator on ``device`` for a model's draws: ``rng`` itself when
    it lives there, else one seeded by a draw from ``rng`` (the trainer's
    generators live on the host; drawing noise there and copying it
    would cost a host-to-device copy per draw)."""
    if rng.device.type == torch.device(device).type:
        return rng
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=rng))
    return torch.Generator(device=device).manual_seed(seed)


class BaseRecommender:
    model_type: ModelType = ModelType.GENERAL
    input_type: InputType = InputType.PAIRWISE
    # False for models whose scores are not a user·item factorization
    factorized_eval: bool = True

    def __init__(self, config, dataset, device: torch.device | str | None = None):
        self.config = config
        self.device = resolve_device(config, device)
        self.n_users = dataset.n_users
        self.n_items = dataset.n_items
        self.consts: Consts = {}

    # -- state ---------------------------------------------------------

    def init_params(self, gen: torch.Generator) -> Params:
        raise NotImplementedError

    def init_extras(self, gen: torch.Generator) -> Extras:
        return {}

    # -- compute ---------------------------------------------------------

    def calculate_loss(self, params: Params, consts: Consts, extras: Extras,
                       batch: Batch, rng: torch.Generator | None,
                       mode: int = 0) -> tuple[torch.Tensor, dict]:
        """Loss of one batch.  ``mode`` selects a warm-up variant (see
        ``loss_mode``); most models ignore it."""
        raise NotImplementedError

    def loss_mode(self, epoch: int) -> int:
        """Loss variant for this epoch (default 0)."""
        return 0

    # -- trainer hooks (host side, between epochs) -------------------------

    def epoch_start(self, epoch: int, params: Params, consts: Consts,
                    extras: Extras, rng: torch.Generator | None) -> Extras:
        """Per-epoch refresh of ``extras``.  Default: no-op."""
        return extras


class GeneralGraphRecommender(BaseRecommender):
    """General recommenders over the normalised U-I bipartite graph.
    The symmetric-normalised adjacency is built once by the dataset and
    stored in consts."""

    model_type = ModelType.GENERAL
    input_type = InputType.PAIRWISE

    def __init__(self, config, dataset, device: torch.device | str | None = None):
        super().__init__(config, dataset, device)
        self.consts["graph"] = dataset.get_norm_adj_graph(device=self.device)

    def propagate(self, params: Params, consts: Consts, extras: Extras
                  ) -> tuple[torch.Tensor, torch.Tensor]:
        """Full-graph forward → (user_all_emb, item_all_emb)."""
        raise NotImplementedError

    def predict_pairs(self, params: Params, consts: Consts, extras: Extras,
                      users: torch.Tensor, items: torch.Tensor
                      ) -> torch.Tensor:
        u, i = self.propagate(params, consts, extras)
        return (u[users] * i[items]).sum(-1)


class SocialRecommender(GeneralGraphRecommender):
    """Social models (reference abstract_recommender.py:23-30 +
    SocialDataset): each builds its own device matrices from the
    dataset (``models/social/common.to_device_matrix``); the joint U-I
    adjacency is added by the subclasses that need it."""

    model_type = ModelType.SOCIAL

    def __init__(self, config, dataset, device: torch.device | str | None = None):
        BaseRecommender.__init__(self, config, dataset, device)


class SequentialRecommender(BaseRecommender):
    """Session-graph / sequence models.  Batches carry padded session
    arrays (``data/session.py``); scoring is full-catalog logits."""

    model_type = ModelType.SEQUENTIAL
    input_type = InputType.POINTWISE

    def __init__(self, config, dataset, device: torch.device | str | None = None):
        super().__init__(config, dataset, device)
        self.max_seq_len = int(config.get("MAX_ITEM_LIST_LENGTH", 50))

    def full_scores(self, params: Params, consts: Consts, extras: Extras,
                    batch: Batch, rng: torch.Generator | None, train: bool
                    ) -> torch.Tensor:
        """(B, n_items) logits over the catalog (col 0 = PAD)."""
        raise NotImplementedError

    def calculate_loss(self, params, consts, extras, batch, rng, mode=0):
        logits = self.full_scores(params, consts, extras, batch, rng, True)
        loss = cross_entropy(logits, batch["item_id"], batch.get("weight"))
        return loss, {"ce": loss}
