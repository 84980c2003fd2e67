"""Experiment scripts of the port: the 100-instance campaigns of the JAX
package's `experiments/`, solved from their committed instance data."""
