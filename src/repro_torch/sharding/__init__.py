"""Sharding rules (port of ``repro.sharding``): the PIM placement half."""
