"""Visualization of trained Implicitron models (port of
pytorch3d_tpu/implicitron/models/visualization)."""
