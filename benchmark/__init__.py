"""The benchmark of gslidar_tpu_torch on the H100 (see README.md)."""
