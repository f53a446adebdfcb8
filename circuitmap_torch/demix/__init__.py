"""Waveform demixer: the U-Net module, checkpoint IO, training data,
template fits and the facade."""

from .demixer import NeuralDemixer
from .unet import init_nwd_params

__all__ = ["NeuralDemixer", "init_nwd_params"]
