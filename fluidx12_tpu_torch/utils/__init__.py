"""Image helpers."""
