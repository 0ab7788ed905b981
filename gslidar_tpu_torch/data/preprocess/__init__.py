"""Offline converters from raw dataset trees to the transforms JSONs the
loaders read (the port's copies of ``gslidar_tpu/data/preprocess``)."""
