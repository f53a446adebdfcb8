"""Waveform demixer: the U-Net module, checkpoint IO, training data,
template fits and the facade."""
