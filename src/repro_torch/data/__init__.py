"""Numpy copies of the JAX package's data modules (no JAX, no repro)."""
