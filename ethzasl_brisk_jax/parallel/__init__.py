from ethzasl_brisk_jax.parallel.frames import (
    FramePipeline,
    make_mesh,
    sharded_knn_match,
)

__all__ = ["FramePipeline", "make_mesh", "sharded_knn_match"]
