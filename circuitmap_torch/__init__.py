"""circuitmap_torch — the circuitmap pipeline in PyTorch, for NVIDIA Hopper.

A port of ``circuitmap_tpu`` (the JAX/Pallas package beside it, which
stays the reference every module here is tested against). Same module
layout and public names; inside, PyTorch's idiom: the demixer U-Net is
an ``nn.Module``, the solvers are plain functions on tensors, devices
are explicit and random streams are ``torch.Generator``s.

Device rule: every entry point (``Model.fit``, ``caviar``,
``caviar_many``, ``caviar_resumable``, ``OnlineCaviar``, ``cavi_sns``,
``sns_many``, ``mbcs``, ``mbcs_many``, ``mbcs_ard``, ``closed_loop_map``,
``NeuralDemixer`` with its ``train``, ``simulate``,
``simulate_continuous_experiment`` and
``simulation.simulate_continuous_experiment_without_spike_failures``,
``demix.template_fit.fit_psc_templates`` and
``pipelines.connection_waveforms`` /
``pipelines.merge_duplicate_connections``, the fit server's
``serve.FitService`` / ``serve.run_server`` and ``python -m
circuitmap_torch serve``) takes ``device=None``, which
means ``"cuda"``. Pass ``device="cpu"`` to run on the CPU; without a
CUDA device and without that request, the entry point raises
RuntimeError instead of quietly running on the CPU. ``pool_design``,
``AdaptiveDesigner``, ``summarize``/``format_summary`` (and
``Model.summary``), ``demix.datagen``, ``NeuralDemixer``'s
``generate_training_data``, ``demix.demixer.wire_transform``, the rest
of ``pipelines`` and ``viz`` (matplotlib, imported lazily), the wire
codecs and ``FitClient`` of ``serve``, ``utils/io.py`` and
``utils/synthetic.py`` are host numpy.

Every Pallas TPU kernel of the JAX package has a hand-written CUDA C++
counterpart for sm_90a (``csrc/``), built with nvcc at first use
(``ops/_build.py``). A CPU tensor takes each kernel's plain PyTorch
version. ``cosamp`` is a host numpy baseline by design, as in the JAX
package.

Imports are lazy, so importing the package pulls in nothing heavy.
"""

__version__ = "0.1.0"


def default_compile_cache_dir():
    """Where the CUDA kernel library is built and kept (the counterpart
    of the JAX package's persistent compile cache): the directory
    ``$CIRCUITMAP_TORCH_BUILD_DIR`` names, else ``circuitmap_torch/_build``
    (``ops/_build.py``). ``doctor`` reads it; ``warm-cache`` fills it."""
    from .ops._build import build_dir

    return str(build_dir())

_LAZY = {
    "Model": ("circuitmap_torch.model", "Model"),
    "default_priors": ("circuitmap_torch.model", "default_priors"),
    "NeuralDemixer": ("circuitmap_torch.demix.demixer", "NeuralDemixer"),
    "caviar": ("circuitmap_torch.solvers.caviar", "caviar"),
    "caviar_many": ("circuitmap_torch.solvers.batched", "caviar_many"),
    "sns_many": ("circuitmap_torch.solvers.batched", "sns_many"),
    "mbcs_many": ("circuitmap_torch.solvers.batched", "mbcs_many"),
    "caviar_resumable": ("circuitmap_torch.solvers.resumable",
                         "caviar_resumable"),
    "OnlineCaviar": ("circuitmap_torch.solvers.online", "OnlineCaviar"),
    "pool_design": ("circuitmap_torch.design", "pool_design"),
    "AdaptiveDesigner": ("circuitmap_torch.design", "AdaptiveDesigner"),
    "closed_loop_map": ("circuitmap_torch.design", "closed_loop_map"),
    "cavi_sns": ("circuitmap_torch.solvers.cavi_sns", "cavi_sns"),
    "mbcs": ("circuitmap_torch.solvers.mbcs", "mbcs"),
    "cosamp": ("circuitmap_torch.solvers.cosamp", "cosamp"),
    "mbcs_ard": ("circuitmap_torch.solvers.experimental", "mbcs_ard"),
    "simulate": ("circuitmap_torch.simulation", "simulate"),
    "simulate_continuous_experiment": ("circuitmap_torch.simulation",
                                       "simulate_continuous_experiment"),
    "summarize": ("circuitmap_torch.summary", "summarize"),
    "format_summary": ("circuitmap_torch.summary", "format_summary"),
    "FitClient": ("circuitmap_torch.serve", "FitClient"),
}

__all__ = list(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module 'circuitmap_torch' has no attribute {name!r}")
