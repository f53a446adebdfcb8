"""circuitmap_torch — the circuitmap pipeline in PyTorch, for NVIDIA Hopper.

A port of ``circuitmap_tpu`` (the JAX/Pallas package beside it, which
stays the reference every module here is tested against). Same module
layout and public names; inside, PyTorch's idiom: the demixer U-Net is
an ``nn.Module``, the solvers are plain functions on tensors, devices
are explicit and random streams are ``torch.Generator``s.

Device rule: every entry point (``Model.fit``, ``caviar``,
``caviar_many``, ``cavi_sns``, ``mbcs``, ``mbcs_ard``, ``NeuralDemixer``,
``simulate``) takes ``device=None``, which means ``"cuda"``. Pass ``device="cpu"`` to run on the CPU; without
a CUDA device and without that request, the entry point raises
RuntimeError instead of quietly running on the CPU.

Every Pallas TPU kernel of the JAX package has a hand-written CUDA C++
counterpart for sm_90a (``csrc/``), built with nvcc at first use
(``ops/_build.py``). A CPU tensor takes each kernel's plain PyTorch
version. ``cosamp`` is a host numpy baseline by design, as in the JAX
package.

Imports are lazy, so importing the package pulls in nothing heavy.
"""

__version__ = "0.1.0"

_LAZY = {
    "Model": ("circuitmap_torch.model", "Model"),
    "default_priors": ("circuitmap_torch.model", "default_priors"),
    "NeuralDemixer": ("circuitmap_torch.demix.demixer", "NeuralDemixer"),
    "caviar": ("circuitmap_torch.solvers.caviar", "caviar"),
    "caviar_many": ("circuitmap_torch.solvers.batched", "caviar_many"),
    "cavi_sns": ("circuitmap_torch.solvers.cavi_sns", "cavi_sns"),
    "mbcs": ("circuitmap_torch.solvers.mbcs", "mbcs"),
    "cosamp": ("circuitmap_torch.solvers.cosamp", "cosamp"),
    "mbcs_ard": ("circuitmap_torch.solvers.experimental", "mbcs_ard"),
    "simulate": ("circuitmap_torch.simulation", "simulate"),
}

__all__ = list(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module 'circuitmap_torch' has no attribute {name!r}")
