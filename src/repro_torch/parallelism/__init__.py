"""Sharding: the context of a mesh\x27s axes, and the rules and placement of every leaf."""
