"""Step factories of the port."""
