"""Batched registration of many scan pairs (lidar_global_registration_tpu/parallel).

The JAX package shards the pair batch over a ('dp', 'tp') device mesh.  On
one GPU the dp axis is a loop over the pairs and tp = 1: batch.py.  The
mesh (parallel/mesh.py) and the tp row sharding of a pair exist only across
several devices and have no counterpart here.
"""
