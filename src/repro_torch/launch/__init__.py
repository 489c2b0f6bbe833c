"""Step functions and the serving and training entry points of the port."""
