"""View pooling: sampling and aggregation of source-view features (port of
pytorch3d_tpu/implicitron/models/view_pooler)."""
