"""PyTorch / CUDA port of future urban scene generation through vehicle synthesis.

The port mirrors the JAX package ``future_urban_scene_generation_tpu`` module for
module (same module names, NHWC tensors at every public function) and runs on one
NVIDIA Hopper GPU. It imports ``torch`` and numpy only; the two hand-written CUDA
kernels of the scene path live under ``csrc/`` and build at first use (see
``ops/_kernels.py``).

Entry point: :func:`future_urban_scene_generation_tpu_torch.pipeline.runner.run_scene`.
"""
