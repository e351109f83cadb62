"""PyTorch + CUDA port of lidar_global_registration_tpu for one NVIDIA H100.

The JAX package beside this one is the reference; every module here mirrors
the name of its JAX counterpart.  This package imports torch and numpy only,
never jax and never the JAX package, so it runs on a machine without JAX.

Covered so far: the routes of `models.flagship.register_pair_staged` for
ISS keypoints (the feature-scale route with FPFH or the shipped SHOT
regime, after the loader-equivalent pre-downsample, with cluster matching
and uniformity RANSAC; the classic masked route with either descriptor,
where the JAX package takes it) and for keypoint-any FPFH + mutual 1-NN,
with the CUDA kernels under `csrc/` (built at first use by `kernels.py`).
"""
