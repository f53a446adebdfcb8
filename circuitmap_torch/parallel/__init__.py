"""Multi-device execution (port of ``circuitmap_tpu/parallel``): the trial
mesh, trial-sharded CAVIaR, CAVI-SnS and MBCS, their multi-process forms,
and the sweep runner.

Every CAVI update is a sum over trials K, so K partitions across the
shards of a :class:`TrialMesh` and each reduction becomes a ``psum``:
within a process an ordered sum of the shards' partials, across
processes one ``torch.distributed`` all-reduce.
"""

from .distributed import (caviar_resumable_distributed,
                          caviar_sharded_distributed,
                          cavi_sns_sharded_distributed, global_trial_mesh,
                          initialize as initialize_distributed,
                          mbcs_sharded_distributed)
from .mesh import TrialMesh, trial_mesh
from .sharded import caviar_sharded, cavi_sns_sharded, mbcs_sharded
from .sweep import run_sweep

__all__ = ["TrialMesh", "trial_mesh", "caviar_sharded", "cavi_sns_sharded",
           "mbcs_sharded", "run_sweep", "initialize_distributed",
           "global_trial_mesh", "caviar_sharded_distributed",
           "caviar_resumable_distributed", "cavi_sns_sharded_distributed",
           "mbcs_sharded_distributed"]
