"""Numpy and stdlib helpers the port carries itself (copies of the parts
of ``gslidar_tpu/utils`` it calls)."""
