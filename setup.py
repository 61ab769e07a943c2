"""Install dgvit_tpu (pure-Python package; the C++ replay library builds
lazily via make on first use, see dgvit_tpu/replay/buffer.py).

Console scripts mirror the reference's entry points (reference setup.py:24-32
main/testing/demonstration/keyboard_control/depth_image_subscriber)."""

from setuptools import find_packages, setup

setup(
    name="dgvit_tpu",
    version="0.1.0",
    description=("TPU-native (JAX/XLA/Pallas/pjit) goal-conditioned visual "
                 "navigation framework with the capabilities of DGViT"),
    packages=find_packages(include=["dgvit_tpu", "dgvit_tpu.*",
                                    "dgvit_tpu_torch", "dgvit_tpu_torch.*"]),
    package_data={"dgvit_tpu.replay": ["csrc/*.cpp", "csrc/Makefile"],
                  "dgvit_tpu_torch.ops": ["csrc/*.cu", "csrc/*.cuh"],
                  "dgvit_tpu_torch.replay": ["csrc/*.cpp"]},
    python_requires=">=3.10",
    install_requires=["jax", "flax", "optax", "orbax-checkpoint", "numpy",
                      "pyyaml"],
    entry_points={
        "console_scripts": [
            "dgvit-train=dgvit_tpu.train.train_rl:main",
            "dgvit-test=dgvit_tpu.train.evaluate:main",
            "dgvit-imitate=dgvit_tpu.train.train_bc:main",
            "dgvit-demo=dgvit_tpu.train.demo_record:main",
            "dgvit-frames=dgvit_tpu.train.depth_image_tools:main",
            "dgvit-teleop=dgvit_tpu.train.keyboard_control:main",
            "dgvit-train-vec=dgvit_tpu.train.vec_rollout:main",
            "dgvit-train-fused=dgvit_tpu.train.fused_train:main",
            "dgvit-train-fleet=dgvit_tpu.train.train_fleet:main",
            "dgvit-export=dgvit_tpu.serve.export:main",
            "dgvit-sim-assets=dgvit_tpu.envs.sim_assets:main",
            # the PyTorch/CUDA port's entry points
            "dgvit-torch-export=dgvit_tpu_torch.serve.export:main",
            "dgvit-torch-train-offline="
            "dgvit_tpu_torch.train.train_offline:main",
        ],
    },
)
