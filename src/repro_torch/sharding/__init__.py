"""Sharding: the planner's per-leaf layouts (``planner``) and the
collectives that move tensors between them (``collectives``)."""
