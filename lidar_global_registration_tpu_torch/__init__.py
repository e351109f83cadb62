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
<alignment|metric|debug> config.yaml` reads the PLY pair, preprocesses it
on the card, registers it, writes the reference's CSV artifacts and
analyses the result (`cli`, `models.pipeline`, `analysis`, `utils.io`,
`utils.naming`).  Configs outside the staged envelope take the host path
(`models.pyramid`, `models.ransac`, `models.gror`): every metric, matching
strategy, descriptor (FPFH, SHOT, RoPS, USC), frame (gravity, default,
ground truth), the bf16 matcher and an initial guess.  Beside them: the
one-graph entry points `register_pair_step` and `register_pair_two_stage`,
GROR's preparation and the hypothesis pool; the debug side (`debug`,
`compare`, `keypoint`, `save_features`; `utils.debug_viz`,
`ops.quadric`); batches of pairs, one process or split over a
('dp', 'tp') mesh of processes (`parallel.batch`, `parallel.mesh`); and a
voxel of one point keeps the JAX route's float32 centroid
(`ops.downsample`).  Outside the package, on the port only: the dataset
tool `tools/datasets_torch.py` and the benchmark `bench_torch.py` with its
sweep `tools/bench_sweep_torch.py`.
"""
