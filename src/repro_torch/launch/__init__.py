"""Launcher (port of ``repro.launch``): device meshes, per-(arch, shape)
input specs, sharding rules and the multi-pod dry-run."""
