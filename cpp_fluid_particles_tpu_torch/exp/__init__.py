"""Entry points of the JAX package's experiments (exp/) that run a TPU
kernel, ported: ``flat_pallas_proto``."""
