"""Experiment scripts of the port: counterparts of the JAX package's
`scripts/` (`python3 -m ipddp2tpu_torch.scripts.<name>`)."""
