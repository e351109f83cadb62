"""PyTorch + CUDA port of lidar_global_registration_tpu for one NVIDIA H100.

The JAX package beside this one is the reference; every module here mirrors
the name of its JAX counterpart.  This package imports torch and numpy only,
never jax and never the JAX package, so it runs on a machine without JAX.

Covered so far: the two routes of `models.flagship.register_pair_staged`
that the bench runs — ISS keypoints + feature-scale FPFH + cluster matching
+ uniformity RANSAC after the loader-equivalent pre-downsample (the JAX
defaults), and keypoint-any FPFH + mutual 1-NN + RANSAC — with seven CUDA
kernels under `csrc/` (built at first use by `kernels.py`).
"""
