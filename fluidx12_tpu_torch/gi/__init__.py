"""Global illumination from a radiance light probe (spherical harmonics)."""
