"""Supervised losses and the Eigen error suite."""
