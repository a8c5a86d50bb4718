"""Multi-device modes on torch.distributed (mirror of fluidx12_tpu/parallel/):
the Z-slab domain decomposition (domain.py), the sharded light map
(light.py) and render (render.py), and ensembles of independent
simulations (ensemble.py)."""
