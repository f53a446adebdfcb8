from setuptools import setup, find_packages

setup(
    name="circuitmap_tpu",
    version="0.1.0",
    description=(
        "TPU-native neural waveform demixing and synaptic connectivity "
        "inference for holographic ensemble stimulation"
    ),
    packages=find_packages(exclude=("tests",)),
    package_data={
        "circuitmap_tpu.native": ["*.cpp", "*.so"],
        "circuitmap_torch": ["csrc/*.cu", "csrc/*.cuh"],
        "circuitmap_torch.native": ["*.cpp"],
        "circuitmap_torch.scripts": ["*.sh"],
    },
    python_requires=">=3.10",
    install_requires=[
        "numpy>=1.24",
        "scipy>=1.9",
        "jax>=0.4.30",
        "optax",
        "pyyaml",
    ],
    extras_require={
        "viz": ["matplotlib"],
        "ckpt-convert": ["torch"],
        "torch": ["torch>=2.4"],
    },
)
