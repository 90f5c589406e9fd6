"""PyTorch/CUDA port of the DC-HierSignSGD system (see ``src/repro`` for
the JAX reference it is held against)."""
