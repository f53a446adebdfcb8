"""The host runtime's C++ source (``windowing.cpp``), built at first use
by ``circuitmap_torch.utils.native``."""
