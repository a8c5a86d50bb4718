"""FluidX12 on PyTorch + CUDA: the port of fluidx12_tpu to NVIDIA Hopper.

Module names follow fluidx12_tpu/ so each module's counterpart is found by
path.  Kernels written by hand for sm_90a live in csrc/ and are bound in
ops/cuda/; everything else is plain PyTorch.  This package never imports
jax.
"""
