"""Fixed-shape point and projection ops: box membership, range-image
projection and box rasterisation."""
