"""Fault tolerance and elasticity of the port (``fault_tolerance``)."""
