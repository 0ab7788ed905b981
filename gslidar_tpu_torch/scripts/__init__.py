"""Scripts of the port: ``compare_2dgs_3dgs`` (the port of
scripts/compare_2dgs_3dgs.py)."""
