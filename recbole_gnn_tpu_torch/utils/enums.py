"""Model/input type enums (reference: utils.py:159-165 extends the
[recbole] ModelType with SOCIAL = 7; values kept for config parity)."""

from enum import Enum


class ModelType(Enum):
    GENERAL = 1
    SEQUENTIAL = 2
    CONTEXT = 3
    KNOWLEDGE = 4
    TRADITIONAL = 5
    DECISIONTREE = 6
    SOCIAL = 7


class InputType(Enum):
    POINTWISE = 1
    PAIRWISE = 2
    LISTWISE = 3
