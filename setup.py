from setuptools import find_packages, setup

setup(
    name="protoasnet_tpu",
    version="0.1.0",
    description=(
        "TPU-native (JAX/XLA/Pallas) framework for prototype-based, "
        "uncertainty-aware aortic-stenosis classification in echocardiography"
    ),
    packages=find_packages(include=["protoasnet_tpu", "protoasnet_tpu.*",
                                    "protoasnet_tpu_torch",
                                    "protoasnet_tpu_torch.*"]),
    package_data={"protoasnet_tpu_torch": ["csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "flax",
        "optax",
        "numpy",
        "pandas",
        "pyyaml",
    ],
)
