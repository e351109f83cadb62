"""Batched registration of many scan pairs (lidar_global_registration_tpu/parallel).

mesh.py: the ('dp', 'tp') device mesh over the processes of a
torch.distributed group, and the one collective the step uses.  batch.py:
the batch step, its pairs split over dp and each pair's rows and its
matcher's train side over tp; without a mesh, a loop of the single-pair step.
"""
