"""Model assembly of the port: layers, the decoder LM, the JAX-weight converter."""
