"""Solvers: CAVIaR (the flagship), CAVI-SnS, MBCS, CoSaMP, their batched
fits, the resumable and streaming CAVIaR, and their shared preamble. The
ARD variant of MBCS lives in ``solvers.experimental`` (``mbcs_ard``)."""

from .batched import caviar_many, mbcs_many, sns_many
from .cavi_sns import cavi_sns
from .caviar import caviar
from .cosamp import cosamp
from .mbcs import mbcs
from .online import OnlineCaviar
from .resumable import caviar_resumable

__all__ = ["caviar", "cavi_sns", "cosamp", "mbcs", "caviar_many",
           "sns_many", "mbcs_many", "caviar_resumable", "OnlineCaviar"]
