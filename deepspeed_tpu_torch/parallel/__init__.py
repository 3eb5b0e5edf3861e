"""Sharding rules (``sharding.py``): how ZeRO stages place each parameter's
and optimizer-state leaf over the mesh, ported from
``deepspeed_tpu/parallel/``."""
