"""Image feature extractors (port of
pytorch3d_tpu/implicitron/models/feature_extractor)."""
