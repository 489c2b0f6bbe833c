"""Sharded execution of the port: meshes and collectives (``spmd``), the
layout rules (``sharding``) and the pipeline schedule (``pipeline``)."""
