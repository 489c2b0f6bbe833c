"""Step functions and the standard serving entry point of the port."""
