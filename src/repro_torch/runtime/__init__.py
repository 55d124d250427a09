"""Train and serving steps of the port, and the training loop."""
