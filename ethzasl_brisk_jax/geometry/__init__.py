from ethzasl_brisk_jax.geometry.cameras import (
    EquidistantDistortion,
    NoDistortion,
    PinholeCamera,
    RadialTangentialDistortion,
)

__all__ = [
    "EquidistantDistortion",
    "NoDistortion",
    "PinholeCamera",
    "RadialTangentialDistortion",
]
