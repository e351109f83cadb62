"""Constants of the registration path (lidar_global_registration_tpu/types.py)."""

FEATURE_NR_POINTS = 352  # points a feature disk should hold (types.py:76)
NORMAL_NR_POINTS = 30  # points a normal disk should hold (types.py:77)
SEED = 566  # the reference's default random seed (types.py:302)
