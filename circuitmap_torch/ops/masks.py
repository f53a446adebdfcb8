"""Small mask helpers (port of ops/masks.py)."""

from __future__ import annotations

import torch


def get_mask(N, device="cpu"):
    """Boolean [N, N] mask that is False on the diagonal, True elsewhere."""
    return ~torch.eye(N, dtype=torch.bool, device=device)
