"""Sharding rules for activations and elastic resharding on a DeviceMesh."""
