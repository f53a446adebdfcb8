"""Solvers: CAVIaR (the flagship), CAVI-SnS, MBCS, CoSaMP, the batched
CAVIaR and their shared preamble. The ARD variant of MBCS lives in
``solvers.experimental`` (``mbcs_ard``)."""

from .batched import caviar_many
from .cavi_sns import cavi_sns
from .caviar import caviar
from .cosamp import cosamp
from .mbcs import mbcs

__all__ = ["caviar", "cavi_sns", "cosamp", "mbcs", "caviar_many"]
