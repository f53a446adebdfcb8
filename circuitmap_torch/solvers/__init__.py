"""Solvers: CAVIaR, its batched form and their shared preamble."""

from .batched import caviar_many
from .caviar import caviar

__all__ = ["caviar", "caviar_many"]
