"""Vertex programs run through ``Engine.run``."""
