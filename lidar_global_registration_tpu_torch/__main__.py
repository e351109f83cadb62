from lidar_global_registration_tpu_torch.cli import main

main()
