"""PyTorch + CUDA port of lidar_global_registration_tpu for one NVIDIA H100.

The JAX package beside this one is the reference; every module here mirrors
the name of its JAX counterpart.  This package imports torch and numpy only,
never jax and never the JAX package, so it runs on a machine without JAX.

Covered so far: every route of `models.flagship.register_pair_staged` (ISS
keypoints: the staged multi-scale pyramid, the feature-scale route, the
classic masked and the unmasked route, with FPFH or SHOT, cluster matching,
RANSAC or GROR; keypoint-any with mutual 1-NN), with the CUDA kernels under
`csrc/` (built at first use by `kernels.py`), the front that leads a
config to it (`utils.config`, `models.pipeline`), and the host pipeline
and command line around it: `python -m lidar_global_registration_tpu_torch
<alignment|metric> config.yaml` reads the PLY pair, preprocesses it on the
card, registers it, writes the reference's CSV artifacts and analyses the
result (`cli`, `models.pipeline`, `analysis`, `utils.io`, `utils.naming`).
"""
